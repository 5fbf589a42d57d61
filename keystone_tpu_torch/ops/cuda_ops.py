"""Hand-written CUDA kernels for the port's hot ops, with their plain
PyTorch versions.

Port of the kernels of ``keystone_tpu/ops/pallas_ops.py`` that the TIMIT
block slice runs:

  - :func:`cosine_features` ↔ ``pallas_ops.cosine_features``
    (``csrc/cosine_features.cu``): ``cos(X Wᵀ + b)`` with the cosine fused
    into the GEMM epilogue;
  - :func:`gram_corr_sym` ↔ ``pallas_ops.gram_corr_sym``
    (``csrc/gram_corr_sym.cu``): ``(AᵀA, AᵀR)`` in one launch, upper
    Gramian tiles only.

Each wrapper keeps its Pallas twin's name and operand contract. For a
tensor on the CPU it computes the plain PyTorch version (``*_ref``); for a
CUDA tensor it launches its kernel or raises — it checks device, dtype,
shape and layout, and never falls back. ``launches[name]`` counts the
wrapper's kernel launches (and nothing else), so a run can show that its
main path went through the kernels.

The kernels are built at first use: ``nvcc`` compiles each source under
``csrc/`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/keystone_tpu_torch/`` at the repository root (one library per
source, named by a hash of the source and flags), and ``ctypes`` loads it.
:func:`build` compiles every kernel at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

# Kernel launches per wrapper since the last reset_launch_counts().
launches: Dict[str, int] = {"cosine_features": 0, "gram_corr_sym": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "keystone_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point of each source: name -> (symbol, argtypes).
_ENTRY_POINTS = {
    "cosine_features": (
        "kt_cosine_features", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P]
    ),
    "gram_corr_sym": (
        "kt_gram_corr_sym", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]
    ),
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (_CSRC / f"{name}.cu").read_bytes() + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD / f"lib{name}-{digest}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the kernels' sources that are not built yet, one ``nvcc`` per
    source, all started together; returns each compile's ptxas report
    (registers, shared memory, spills) by kernel name. Raises on a failed
    build."""
    names = list(_ENTRY_POINTS) if names is None else names
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            reports[name] = "(already built)"
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return reports


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _ENTRY_POINTS[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError_t {err})")


def _cuda_operands(name: str, tensors) -> torch.device:
    """The common CUDA device of ``tensors``; raises for a mix of devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: operands must all lie on one CUDA device, got {devices}")
    return next(iter(devices))


def _check_rows(name: str, t: torch.Tensor, what: str) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: {what} must be 2-D, got shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: {what} must have contiguous rows (stride(1) == 1)")


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Fused cosine random features: cos(X Wᵀ + b)
# ---------------------------------------------------------------------------


def _cosine_operands(X, W, compute_dtype):
    """The operand dtype both kernels and the plain version compute from:
    bf16 when asked for (or when both operands already are), else f32 —
    the reference casts to f32 first, then to ``compute_dtype``."""
    if compute_dtype == torch.bfloat16 or (
        X.dtype == torch.bfloat16 and W.dtype == torch.bfloat16
    ):
        return torch.bfloat16
    return torch.float32


def cosine_features_ref(X, W, b, compute_dtype=torch.float32, out_dtype=None):
    """Plain PyTorch version of :func:`cosine_features`:
    ``cos(X Wᵀ + b)`` from the same operand rounding, in float32."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    op = _cosine_operands(X, W, compute_dtype)
    Xf = X.to(op).to(torch.float32)
    Wf = W.to(op).to(torch.float32)
    return torch.cos(Xf @ Wf.T + b.to(torch.float32)).to(out_dtype)


def cosine_features(X, W, b, compute_dtype=torch.float32, out_dtype=None):
    """cos(X @ Wᵀ + b) fused into the matmul epilogue.

    X: (m, d), W: (num_out, d), b: (num_out,). The featurized (m, num_out)
    matrix is written once; the pre-activation never exists in device
    memory (reference: CosineRandomFeatures.scala:19-45).
    ``compute_dtype=torch.bfloat16`` rounds the operands to bf16 (products
    still accumulate in f32); ``out_dtype=torch.bfloat16`` writes the
    features at half the footprint.
    """
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if X.device.type == "cpu" and W.device.type == "cpu" and b.device.type == "cpu":
        return cosine_features_ref(X, W, b, compute_dtype, out_dtype)
    name = "cosine_features"
    device = _cuda_operands(name, (X, W, b))
    _check_rows(name, X, "X")
    _check_rows(name, W, "W")
    if X.shape[1] != W.shape[1] or b.shape != (W.shape[0],):
        raise ValueError(
            f"{name}: shapes X {tuple(X.shape)}, W {tuple(W.shape)}, b {tuple(b.shape)} "
            "do not match cos(X Wᵀ + b)"
        )
    if X.dtype not in _KERNEL_DTYPES + (torch.float64,) or W.dtype not in _KERNEL_DTYPES + (torch.float64,):
        raise TypeError(f"{name}: operands must be floating, got {X.dtype}, {W.dtype}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    op = _cosine_operands(X, W, compute_dtype)
    Xk = X if X.dtype == op else X.to(op)
    Wk = W if W.dtype == op else W.to(op)
    bk = b.to(torch.float32).contiguous()
    m, d = Xk.shape
    n = Wk.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _lib(name).kt_cosine_features
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            Xk.data_ptr(), Wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            m, n, d, Xk.stride(0), Wk.stride(0), out.stride(0),
            int(op == torch.bfloat16), int(out_dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# Symmetric one-pass Gramian + correlation: (AᵀA, AᵀR)
# ---------------------------------------------------------------------------


def gram_corr_sym_ref(A, R):
    """Plain PyTorch version of :func:`gram_corr_sym`: ``(AᵀA, AᵀR)`` in
    float32 from A's values (bf16 A is exact in f32)."""
    Af = A.to(torch.float32)
    return Af.T @ Af, Af.T @ R.to(torch.float32)


def gram_corr_sym(A, R):
    """(AᵀA, AᵀR) computing only the upper-triangle tiles of AᵀA.

    A: (n, d) float32 or bfloat16, rows contiguous (a column window of a
    wider matrix is read in place through its row stride). R: (n, k),
    taken as float32. Returns the full symmetric (d, d) Gramian and the
    (d, k) correlation, both float32.
    """
    if A.device.type == "cpu" and R.device.type == "cpu":
        return gram_corr_sym_ref(A, R)
    name = "gram_corr_sym"
    device = _cuda_operands(name, (A, R))
    _check_rows(name, A, "A")
    _check_rows(name, R, "R")
    if A.shape[0] != R.shape[0]:
        raise ValueError(
            f"{name}: A {tuple(A.shape)} and R {tuple(R.shape)} must have the same rows"
        )
    if A.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: A must be float32 or bfloat16, got {A.dtype}")
    Rk = R if R.dtype == torch.float32 else R.to(torch.float32)
    _check_rows(name, Rk, "R")
    n, d = A.shape
    k = Rk.shape[1]
    gram = torch.empty((d, d), dtype=torch.float32, device=device)
    corr = torch.empty((d, k), dtype=torch.float32, device=device)
    if d == 0:
        return gram, corr
    fn = _lib(name).kt_gram_corr_sym
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            A.data_ptr(), Rk.data_ptr(), gram.data_ptr(), corr.data_ptr(),
            n, d, k, A.stride(0), Rk.stride(0), int(A.dtype == torch.bfloat16),
            stream,
        )
    _check_launch(name, err)
    return gram, corr
