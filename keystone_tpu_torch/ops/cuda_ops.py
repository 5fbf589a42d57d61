"""Hand-written CUDA kernels for the port's hot ops, with their plain
PyTorch versions.

Port of the kernels of ``keystone_tpu/ops/pallas_ops.py`` that the TIMIT
block slice, the fused flat fit and the streamed fit run:

  - :func:`cosine_features` ↔ ``pallas_ops.cosine_features``
    (``csrc/cosine_features.cu``): ``cos(X Wᵀ + b)`` with the cosine fused
    into the GEMM epilogue;
  - :func:`gram_corr_sym` ↔ ``pallas_ops.gram_corr_sym``
    (``csrc/gram_corr_sym.cu``): ``(AᵀA, AᵀR)`` in one launch, upper
    Gramian tiles only;
  - :func:`block_gram_sym`, :func:`block_corr`,
    :func:`block_residual_update` ↔ their ``pallas_ops`` namesakes
    (``csrc/block_*.cu``): the flat solver's Gramian, correlation and
    residual update over the column window ``F[:, s:s+b]``, read in place
    through F's row stride (never copied). :func:`strided_gram_ok` is the
    guard that sends the solver to them;
  - :func:`gram_sym_acc` ↔ ``pallas_ops.gram_sym_acc``
    (``csrc/gram_sym_acc.cu``): ``G + FᵀF`` on the upper-triangle tiles,
    the streamed fit's per-tile Gramian fold, accumulating in place.
    :func:`gram_acc_ok` is its guard;
  - :func:`gaussian_kernel_block` ↔ ``pallas_ops.gaussian_kernel_block``
    (``csrc/gaussian_kernel_block.cu``): ``exp(−γ·max(‖x‖²+‖y‖²−2x·y, 0))``
    with the distance and exp epilogue on the register tile, for kernel
    ridge regression's diagonal blocks and its apply;
  - :func:`gaussian_resid_block` ↔ ``pallas_ops.gaussian_resid_block``
    (``csrc/gaussian_resid_block.cu``): ``K(X, Y)ᵀ W`` with the kernel
    block contracted tile by tile and never stored, every step of the
    kernel ridge regression sweep.

All but the cosine kernel share one FP32-FMA register tile
(``csrc/fma_tile.cuh``). The image featurizer's kernel
(``csrc/conv_featurize.cu``) has its wrapper in ``ops/cuda_images.py``; it
is built, loaded and counted here with the others.

Each wrapper keeps its Pallas twin's name and operand contract. For a
tensor on the CPU it computes the plain PyTorch version (``*_ref``); for a
CUDA tensor it launches its kernel or raises — it checks device, dtype,
shape and layout, and never falls back. ``launches[name]`` counts the
wrapper's kernel launches (and nothing else), so a run can show that its
main path went through the kernels.

The kernels are built at first use: ``nvcc`` compiles each source under
``csrc/`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/keystone_tpu_torch/`` at the repository root (one library per
source, named by a hash of the source, the shared headers and the flags),
and ``ctypes`` loads it.
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
launches: Dict[str, int] = {
    "cosine_features": 0, "gram_corr_sym": 0,
    "block_gram_sym": 0, "block_corr": 0, "block_residual_update": 0,
    "gram_sym_acc": 0, "gaussian_kernel_block": 0, "gaussian_resid_block": 0,
    "conv_featurize": 0,
}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "keystone_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point of each source: name -> (symbol, argtypes).
_ENTRY_POINTS = {
    "cosine_features": (
        "kt_cosine_features", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P]
    ),
    "gram_corr_sym": (
        "kt_gram_corr_sym", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]
    ),
    "block_gram_sym": (
        "kt_block_gram_sym", [_P, _P, _I, _I, _I, _L, _I, _P]
    ),
    "block_corr": (
        "kt_block_corr", [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _P]
    ),
    "block_residual_update": (
        "kt_block_residual_update",
        [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P],
    ),
    "gram_sym_acc": (
        "kt_gram_sym_acc", [_P, _P, _P, _I, _I, _L, _L, _L, _I, _P]
    ),
    "gaussian_kernel_block": (
        "kt_gaussian_kernel_block",
        [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _F, _I, _P],
    ),
    "gaussian_resid_block": (
        "kt_gaussian_resid_block",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _F, _I, _P],
    ),
    "conv_featurize": (
        "kt_conv_featurize",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
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
    # The shared headers count too: a header edit must not load a library
    # built from the old one.
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (_CSRC / f"{name}.cu").read_bytes() + headers + " ".join(_NVCC_FLAGS).encode()
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


def cosine_features(X, W, b, compute_dtype=torch.float32, out_dtype=None, out=None):
    """cos(X @ Wᵀ + b) fused into the matmul epilogue.

    X: (m, d), W: (num_out, d), b: (num_out,). The featurized (m, num_out)
    matrix is written once; the pre-activation never exists in device
    memory (reference: CosineRandomFeatures.scala:19-45).
    ``compute_dtype=torch.bfloat16`` rounds the operands to bf16 (products
    still accumulate in f32); ``out_dtype=torch.bfloat16`` writes the
    features at half the footprint. ``out``: an (m, num_out) buffer with
    contiguous rows to write into instead, e.g. a column window of a wider
    feature matrix (written in place through its row stride); its dtype is
    the output dtype.
    """
    if out is not None:
        if out_dtype is not None and out_dtype != out.dtype:
            raise TypeError(f"cosine_features: out is {out.dtype}, out_dtype {out_dtype}")
        out_dtype = out.dtype
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    operands = (X, W, b) if out is None else (X, W, b, out)
    if all(t.device.type == "cpu" for t in operands):
        ref = cosine_features_ref(X, W, b, compute_dtype, out_dtype)
        return ref if out is None else out.copy_(ref)
    name = "cosine_features"
    device = _cuda_operands(name, operands)
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
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=device)
    else:
        _check_rows(name, out, "out")
        if out.shape != (m, n):
            raise ValueError(f"{name}: out is {tuple(out.shape)}, expected {(m, n)}")
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


# ---------------------------------------------------------------------------
# Column-window kernels of the flat solver: F[:, s:s+b] read in place
# ---------------------------------------------------------------------------


def strided_gram_ok(F, block: int) -> bool:
    """Whether the flat solver may take the column-window kernels for F
    (counterpart of ``pallas_ops.strided_gram_ok``). The TPU kernels need
    tile-aligned rows and windows; these mask ragged edges, so the guard
    asks only for whole windows (``d % block == 0``), a 2-D F with
    contiguous rows (the window is read through the row stride), and an
    f32 accumulation dtype (F float32 or bfloat16)."""
    return (
        F.dim() == 2
        and block > 0
        and F.shape[1] % block == 0
        and (F.shape[1] <= 1 or F.stride(1) == 1)
        and F.dtype in _KERNEL_DTYPES
    )


def _window(F, col_start: int, block: int):
    return F[:, col_start:col_start + block].to(torch.float32)


def _check_window(name: str, F, col_start: int, block: int) -> None:
    _check_rows(name, F, "F")
    if F.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: F must be float32 or bfloat16, got {F.dtype}")
    if col_start < 0 or block < 0 or col_start + block > F.shape[1]:
        raise ValueError(
            f"{name}: window [{col_start}, {col_start + block}) is not inside F's "
            f"{F.shape[1]} columns"
        )


def block_gram_sym_ref(F, col_start: int, block: int):
    """Plain PyTorch version of :func:`block_gram_sym`: ``FwᵀFw`` in float32
    for the window ``Fw = F[:, col_start:col_start+block]``, its upper
    triangle mirrored (exactly symmetric, as the kernel's output is)."""
    Fw = _window(F, col_start, block)
    G = Fw.T @ Fw
    return torch.triu(G) + torch.triu(G, 1).T


def block_gram_sym(F, col_start: int, block: int):
    """Symmetric Gramian of the column window ``F[:, col_start:col_start+block]``,
    read in place (no window copy), upper-triangle tiles only. F: (n, d)
    float32 or bfloat16 with contiguous rows. Returns (block, block) float32."""
    col_start, block = int(col_start), int(block)
    if F.device.type == "cpu":
        return block_gram_sym_ref(F, col_start, block)
    name = "block_gram_sym"
    device = _cuda_operands(name, (F,))
    _check_window(name, F, col_start, block)
    gram = torch.empty((block, block), dtype=torch.float32, device=device)
    if block == 0:
        return gram
    fn = _lib(name).kt_block_gram_sym
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            F.data_ptr(), gram.data_ptr(), F.shape[0], col_start, block, F.stride(0),
            int(F.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return gram


def _corr_operand(F, R):
    """R as the correlation sees it: float32, rounded to bf16 first when F is
    bf16 (the reference's kernel computes in F's dtype)."""
    Rf = R.to(torch.float32)
    return Rf.to(torch.bfloat16).to(torch.float32) if F.dtype == torch.bfloat16 else Rf


def block_corr_ref(F, col_start: int, block: int, R):
    """Plain PyTorch version of :func:`block_corr`: ``FwᵀR`` in float32."""
    return _window(F, col_start, block).T @ _corr_operand(F, R)


def _corr_splits(n: int, block: int, k: int, device) -> int:
    """Row chunks of one block_corr launch: enough (tile, chunk) blocks for
    about four per SM, each chunk at least 1024 rows. Fixed by the shapes,
    so the summation order never changes from run to run."""
    tiles = -(-block // 128) * -(-k // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // tiles), n // 1024))


def block_corr(F, col_start: int, block: int, R):
    """``F[:, col_start:col_start+block]ᵀ R`` with the window read in place.
    F: (n, d) float32 or bfloat16 with contiguous rows; R: (n, k), taken as
    float32 (rounded to bf16 in the product when F is bf16, as the
    reference computes in F's dtype). Returns (block, k) float32. The sum
    over rows is split into chunks whose partial sums add in a fixed order:
    no atomics, the same bits every run."""
    col_start, block = int(col_start), int(block)
    if F.device.type == "cpu" and R.device.type == "cpu":
        return block_corr_ref(F, col_start, block, R)
    name = "block_corr"
    device = _cuda_operands(name, (F, R))
    _check_window(name, F, col_start, block)
    Rk = R if R.dtype == torch.float32 else R.to(torch.float32)
    _check_rows(name, Rk, "R")
    n, k = F.shape[0], Rk.shape[1]
    if Rk.shape[0] != n:
        raise ValueError(
            f"{name}: F {tuple(F.shape)} and R {tuple(R.shape)} must have the same rows"
        )
    corr = torch.empty((block, k), dtype=torch.float32, device=device)
    if corr.numel() == 0:
        return corr
    splits = _corr_splits(n, block, k, device)
    partials = None
    if splits > 1:
        partials = torch.empty((splits, block, k), dtype=torch.float32, device=device)
    fn = _lib(name).kt_block_corr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            F.data_ptr(), Rk.data_ptr(), None if partials is None else partials.data_ptr(),
            corr.data_ptr(), n, col_start, block, k, F.stride(0), Rk.stride(0), splits,
            int(F.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return corr


def block_residual_update_ref(F, col_start: int, block: int, dW, R):
    """Plain PyTorch version of :func:`block_residual_update`:
    ``R - Fw @ dW`` in float32, dW rounded to F's dtype first."""
    dWf = dW.to(F.dtype).to(torch.float32)
    return R.to(torch.float32) - _window(F, col_start, block) @ dWf


def block_residual_update(F, col_start: int, block: int, dW, R):
    """``R - F[:, col_start:col_start+block] @ dW`` with the window read in
    place: the Gauss-Seidel residual update without a window copy. F: (n, d)
    float32 or bfloat16 with contiguous rows; dW: (block, k), cast to F's
    dtype (as the reference's kernel casts it); R: (n, k), taken as
    float32. Returns a new (n, k) float32 residual."""
    col_start, block = int(col_start), int(block)
    if all(t.device.type == "cpu" for t in (F, dW, R)):
        return block_residual_update_ref(F, col_start, block, dW, R)
    name = "block_residual_update"
    device = _cuda_operands(name, (F, dW, R))
    _check_window(name, F, col_start, block)
    dWk = dW.to(F.dtype).contiguous()
    Rk = R if R.dtype == torch.float32 else R.to(torch.float32)
    _check_rows(name, Rk, "R")
    n, k = F.shape[0], Rk.shape[1]
    if Rk.shape[0] != n or dWk.shape != (block, k):
        raise ValueError(
            f"{name}: F {tuple(F.shape)}, dW {tuple(dW.shape)}, R {tuple(R.shape)} do not "
            f"match R - F[:, s:s+{block}] @ dW"
        )
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if block == 0:
        return out.copy_(Rk)
    fn = _lib(name).kt_block_residual_update
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            F.data_ptr(), dWk.data_ptr(), Rk.data_ptr(), out.data_ptr(), n, col_start,
            block, k, F.stride(0), dWk.stride(0), Rk.stride(0), out.stride(0),
            int(F.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# Accumulating symmetric Gramian of the streamed fold: G + FᵀF
# ---------------------------------------------------------------------------


def gram_acc_ok(F) -> bool:
    """Whether :func:`gram_sym_acc`'s kernel can read the feature tile F
    as it is (counterpart of ``pallas_ops.gram_acc_ok``). The TPU kernel
    needs rows in whole 512-row tiles and d in whole 512- or 1024-wide
    column tiles; this one masks ragged edges, so the guard asks only for
    a 2-D F with contiguous rows and an f32 accumulation dtype (F float32
    or bfloat16). The streamed fold copies a card tile that fails it to
    contiguous rows; the fold's carry G is float32 (d, d) with contiguous
    rows by construction."""
    return (
        F.dim() == 2
        and (F.shape[1] <= 1 or F.stride(1) == 1)
        and F.dtype in _KERNEL_DTYPES
    )


def gram_sym_acc_ref(G, F):
    """Plain PyTorch version of :func:`gram_sym_acc`: ``G + FᵀF`` as
    float32, every entry computed in float32 (bf16 F is exact in f32), or
    in F's own precision where that is wider."""
    acc = torch.promote_types(F.dtype, torch.float32)
    Ff = F.to(acc)
    return (G.to(acc) + Ff.T @ Ff).to(torch.float32)


def gram_sym_acc(G, F, out=None):
    """``G + FᵀF`` on the upper-triangle 128 x 128 tiles of the Gramian.

    G: (d, d) float32 with a meaningful upper triangle; F: (n, d) float32
    or bfloat16 with contiguous rows (ragged n and d are masked in the
    kernel). Writes the upper-triangle tiles of ``out`` — a new (d, d)
    float32 buffer, or the one given, which may be G itself to accumulate
    in place — and returns it. The strictly-lower tiles are undefined
    (left as they were when ``out`` is G): callers mirror once after the
    last accumulation (``triu(G) + triu(G, 1).T``), as the reference's
    contract has it.
    """
    operands = (G, F) if out is None else (G, F, out)
    if all(t.device.type == "cpu" for t in operands):
        ref = gram_sym_acc_ref(G, F)
        return ref if out is None else out.copy_(ref)
    name = "gram_sym_acc"
    device = _cuda_operands(name, operands)
    _check_rows(name, F, "F")
    _check_rows(name, G, "G")
    if F.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: F must be float32 or bfloat16, got {F.dtype}")
    n, d = F.shape
    if G.dtype != torch.float32 or G.shape != (d, d):
        raise ValueError(f"{name}: G must be ({d}, {d}) float32, got {tuple(G.shape)} {G.dtype}")
    if out is None:
        out = torch.empty((d, d), dtype=torch.float32, device=device)
    else:
        _check_rows(name, out, "out")
        if out.dtype != torch.float32 or out.shape != (d, d):
            raise ValueError(
                f"{name}: out must be ({d}, {d}) float32, got {tuple(out.shape)} {out.dtype}"
            )
    if d == 0:
        return out
    fn = _lib(name).kt_gram_sym_acc
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            F.data_ptr(), G.data_ptr(), out.data_ptr(), n, d, F.stride(0), G.stride(0),
            out.stride(0), int(F.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# Gaussian kernel block and the fused residual: exp(−γ‖x − y‖²)
# ---------------------------------------------------------------------------


def _kernel_operand(X, compute_dtype):
    """X as the Gaussian kernels read it: float32, rounded to bf16 when
    ``compute_dtype`` is bf16 (the reference casts to f32 first, then to
    the compute dtype inside its kernel). Other compute dtypes raise."""
    if compute_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return X if X.dtype == compute_dtype else X.to(torch.float32).to(compute_dtype)


def gaussian_kernel_block_ref(X, Y, x_norms, y_norms, gamma: float,
                              compute_dtype=torch.float32):
    """Plain PyTorch version of :func:`gaussian_kernel_block`:
    ``exp(−γ·max(xn_i + yn_j − 2 X_i·Y_j, 0))`` in float32, the cross term
    from the operands rounded to ``compute_dtype``."""
    Xf = _kernel_operand(X, compute_dtype).to(torch.float32)
    Yf = _kernel_operand(Y, compute_dtype).to(torch.float32)
    sq = (x_norms.to(torch.float32)[:, None] + y_norms.to(torch.float32)[None, :]
          - 2.0 * (Xf @ Yf.T))
    return torch.exp(-float(gamma) * torch.clamp_min(sq, 0.0))


def _check_gaussian(name, X, Y, x_norms, y_norms):
    _check_rows(name, X, "X")
    _check_rows(name, Y, "Y")
    if X.shape[1] != Y.shape[1] or x_norms.shape != (X.shape[0],) or (
        y_norms.shape != (Y.shape[0],)
    ):
        raise ValueError(
            f"{name}: shapes X {tuple(X.shape)}, Y {tuple(Y.shape)}, norms "
            f"{tuple(x_norms.shape)}, {tuple(y_norms.shape)} do not match"
        )
    if X.dtype != Y.dtype or X.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: X and Y must both be float32 or bfloat16, got "
                        f"{X.dtype}, {Y.dtype}")


def gaussian_kernel_block(X, Y, x_norms, y_norms, gamma: float,
                          compute_dtype=torch.float32):
    """K[i, j] = exp(−γ‖X_i − Y_j‖²) as one fused kernel, the squared
    distances never in device memory.

    X: (m, d), Y: (n, d) with contiguous rows (a row slice of a larger
    matrix is read in place); x_norms (m,), y_norms (n,) their squared row
    norms. ``compute_dtype=torch.bfloat16`` rounds X and Y to bf16 (the
    products still accumulate in f32; bf16 operands are used as they are).
    Returns (m, n) float32. Ragged m, n and d are masked in the kernel.
    """
    if all(t.device.type == "cpu" for t in (X, Y, x_norms, y_norms)):
        return gaussian_kernel_block_ref(X, Y, x_norms, y_norms, gamma, compute_dtype)
    name = "gaussian_kernel_block"
    device = _cuda_operands(name, (X, Y, x_norms, y_norms))
    Xk, Yk = _kernel_operand(X, compute_dtype), _kernel_operand(Y, compute_dtype)
    xn = x_norms.to(torch.float32).contiguous()
    yn = y_norms.to(torch.float32).contiguous()
    _check_gaussian(name, Xk, Yk, xn, yn)
    m, d = Xk.shape
    n = Yk.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    fn = _lib(name).kt_gaussian_kernel_block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            Xk.data_ptr(), Yk.data_ptr(), xn.data_ptr(), yn.data_ptr(), out.data_ptr(),
            m, n, d, Xk.stride(0), Yk.stride(0), out.stride(0), float(gamma),
            int(Xk.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out


def gaussian_resid_block_ref(X, Y, x_norms, y_norms, W, gamma: float,
                             compute_dtype=torch.float32):
    """Plain PyTorch version of :func:`gaussian_resid_block`:
    ``K(X, Y)ᵀ W`` in float32, K from :func:`gaussian_kernel_block_ref`."""
    K = gaussian_kernel_block_ref(X, Y, x_norms, y_norms, gamma, compute_dtype)
    return K.T @ W.to(torch.float32)


def _resid_splits(m: int, n: int, device) -> int:
    """Row chunks of one gaussian_resid_block launch: enough (column tile,
    chunk) blocks for about four per SM, each chunk at least one 128-row
    tile. Fixed by the shapes, so the summation order never changes from
    run to run."""
    tiles = -(-n // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // tiles), -(-m // 128)))


def gaussian_resid_block(X, Y, x_norms, y_norms, W, gamma: float,
                         compute_dtype=torch.float32):
    """``K(X, Y)ᵀ W`` with the Gaussian kernel block made tile by tile and
    contracted at once: the (m, n) block never exists in device memory.

    X: (m, d) training rows, Y: (n, d) one block's rows, both with
    contiguous rows; x_norms (m,), y_norms (n,); W: (m, k) the dual model,
    taken as float32. Returns (n, k) float32. Rows of X past m are masked
    in the kernel, not read, so W needs no ghost rows. The sum over the m
    rows is split into chunks whose partial sums add in a fixed order: no
    atomics, the same bits every run.
    """
    if all(t.device.type == "cpu" for t in (X, Y, x_norms, y_norms, W)):
        return gaussian_resid_block_ref(X, Y, x_norms, y_norms, W, gamma, compute_dtype)
    name = "gaussian_resid_block"
    device = _cuda_operands(name, (X, Y, x_norms, y_norms, W))
    Xk, Yk = _kernel_operand(X, compute_dtype), _kernel_operand(Y, compute_dtype)
    xn = x_norms.to(torch.float32).contiguous()
    yn = y_norms.to(torch.float32).contiguous()
    _check_gaussian(name, Xk, Yk, xn, yn)
    Wk = W if W.dtype == torch.float32 else W.to(torch.float32)
    _check_rows(name, Wk, "W")
    m, d = Xk.shape
    n, k = Yk.shape[0], Wk.shape[1]
    if Wk.shape[0] != m:
        raise ValueError(f"{name}: W {tuple(W.shape)} must have X's {m} rows")
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if m == 0:
        return out.zero_()
    splits = _resid_splits(m, n, device)
    partials = None
    if splits > 1:
        partials = torch.empty((splits, n, k), dtype=torch.float32, device=device)
    fn = _lib(name).kt_gaussian_resid_block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launches[name] += 1
        err = fn(
            Xk.data_ptr(), Yk.data_ptr(), xn.data_ptr(), yn.data_ptr(), Wk.data_ptr(),
            None if partials is None else partials.data_ptr(), out.data_ptr(),
            m, n, d, k, Xk.stride(0), Yk.stride(0), Wk.stride(0), splits, float(gamma),
            int(Xk.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out
