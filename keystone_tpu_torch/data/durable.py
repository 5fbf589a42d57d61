"""Content identity of arrays and tensors (port of the two helpers of
``keystone_tpu/data/durable.py`` the serving plan's fingerprint needs:
``crc_of_array`` and ``fingerprint_token``; the shard directories and
fold checkpoints come with a later slice).

A tensor's token reads its shape, dtype and content CRC from a host copy,
wherever the tensor lies: a CUDA tensor is copied to the host first (the
reference's ``np.asarray`` of a device array cannot do that for a CUDA
tensor, and would degrade it to its type name, so two plans differing
only in weights would share a fingerprint). bfloat16, which numpy lacks,
is hashed through its 16-bit pattern and named ``bfloat16``, as the
reference names an ``ml_dtypes`` array.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["crc_of_array", "fingerprint_token"]


try:  # pragma: no cover - depends on the optional wheel
    import crc32c as _crc32c_mod

    def _crc(data, value: int = 0) -> int:
        return _crc32c_mod.crc32c(data, value)
except ImportError:
    def _crc(data, value: int = 0) -> int:
        return zlib.crc32(data, value) & 0xFFFFFFFF


def crc_of_array(arr: np.ndarray) -> int:
    """Digest of an array's raw bytes (C-order copy if needed)."""
    return _crc(np.ascontiguousarray(arr).view(np.uint8).reshape(-1).data)


def _host_array(x: torch.Tensor):
    """(numpy array of the tensor's bits, dtype name): a host copy, bf16
    through its 16-bit pattern."""
    t = x.detach()
    if t.is_meta:
        raise TypeError("a meta tensor has no content")
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def fingerprint_token(x: Any) -> Any:
    """A JSON-safe, address-free identity token for fingerprint fields:
    scalars pass through, sequences tokenize elementwise, callables
    become ``module.qualname`` (``repr`` would embed a memory address
    and never match across processes), arrays and tensors become a
    shape/dtype/content-CRC triple (a tensor's from its host copy), and
    anything else degrades to its type name."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [fingerprint_token(v) for v in x]
    if isinstance(x, torch.Tensor):
        try:
            arr, dtype = _host_array(x)
        except Exception:
            return type(x).__name__
        return {"shape": list(arr.shape), "dtype": dtype, "crc": int(crc_of_array(arr))}
    if callable(x):
        mod = getattr(x, "__module__", "?")
        qn = getattr(x, "__qualname__", type(x).__name__)
        return f"{mod}.{qn}"
    try:
        arr = np.asarray(x)
        if arr.dtype == object:
            return type(x).__name__
        return {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": int(crc_of_array(arr)),
        }
    except Exception:
        return type(x).__name__
