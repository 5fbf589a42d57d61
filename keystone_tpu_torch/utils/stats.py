"""Numeric comparison helpers (reference: utils/Stats.scala:25-66).

Port of ``keystone_tpu/utils/stats.py``. ``about_eq`` is the tolerance
comparison the reference uses throughout its solver tests; it accepts
scalars, arrays, tensors (on any device) and nested sequences.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_THRESHOLD = 1e-8


def _float64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def about_eq(a, b, threshold: float = DEFAULT_THRESHOLD) -> bool:
    """True when every element of ``a`` is strictly within ``threshold`` of
    ``b``: ``abs(a - b) < threshold``, the reference's Stats.aboutEq. A
    shape mismatch is a programming error and raises, as the reference's
    ``require`` does."""
    a, b = _float64(a), _float64(b)
    if a.shape != b.shape:
        raise ValueError(
            f"about_eq operands must have the same shape: {a.shape} vs {b.shape}"
        )
    return bool(np.all(np.abs(a - b) < threshold))
