"""Hand-written CUDA kernels for the port's hot ops, with their plain
PyTorch versions.

Port of the kernels of ``keystone_tpu/ops/pallas_ops.py``, all of them:
the ones the TIMIT block slice, the fused flat fit, the streamed fit, the
CIFAR kernel ridge regression, the sparse gram fit and the sketched tier
run:

  - :func:`cosine_features` ↔ ``pallas_ops.cosine_features``
    (``csrc/cosine_features.cu``): ``cos(X Wᵀ + b)`` with the cosine fused
    into the GEMM epilogue;
  - :func:`gram_corr_sym` ↔ ``pallas_ops.gram_corr_sym`` and
    :func:`gram_corr` ↔ ``pallas_ops.gram_corr``: ``(AᵀA, AᵀR)`` in one
    launch of one kernel (``csrc/gram_corr.cu``), upper Gramian tiles
    computed and mirrored, for the block update's ``sym=True`` and
    ``sym=False`` forms (the second TPU kernel computes every Gramian
    tile);
  - :func:`block_gram_sym`, :func:`block_corr`,
    :func:`block_residual_update` ↔ their ``pallas_ops`` namesakes: the
    flat solver's Gramian (``csrc/gram_corr.cu``'s Gramian tiles alone;
    bf16 F on the tensor cores, ``csrc/gram_wgmma.cuh``), correlation and
    residual update (``csrc/block_corr.cu``,
    ``csrc/block_residual_update.cu``) over the column window
    ``F[:, s:s+b]``, read in place through F's row stride (never copied).
    :func:`strided_gram_ok` is the guard that sends the solver to them;
  - :func:`gram_sym_acc` ↔ ``pallas_ops.gram_sym_acc``
    (``csrc/gram_corr.cu``'s Gramian tiles alone, with an accumulating
    epilogue; bf16 F on the tensor cores, ``csrc/gram_wgmma.cuh``):
    ``G + FᵀF`` on the upper-triangle tiles, the streamed fit's per-tile
    Gramian fold, accumulating in place. :func:`gram_acc_ok` is its guard;
  - :func:`gram_corr_sym_acc` ↔ ``pallas_ops.gram_corr_sym_acc``
    (``csrc/gram_corr_sym_acc.cu``): ``(G + FᵀF, C + FᵀR)`` in one pass
    over F, the sparse gram fold's chunk step (``ops/sparse.py``),
    accumulating in place. :func:`gram_corr_acc_ok` is its guard;
  - :func:`gaussian_kernel_block` ↔ ``pallas_ops.gaussian_kernel_block``
    (``csrc/gaussian_kernel_block.cu``): ``exp(−γ·max(‖x‖²+‖y‖²−2x·y, 0))``
    with the distance and exp epilogue on the register tile, for kernel
    ridge regression's diagonal blocks and its apply;
  - :func:`gaussian_resid_block` ↔ ``pallas_ops.gaussian_resid_block``
    (``csrc/gaussian_resid_block.cu``): ``K(X, Y)ᵀ W`` with the kernel
    block contracted tile by tile and never stored, every step of the
    kernel ridge regression sweep (both Gaussian kernels share the epilogue
    of ``csrc/gaussian.cuh``);
  - :func:`countsketch_scatter` ↔ ``pallas_ops.countsketch_scatter``
    (``csrc/countsketch_scatter.cu``): one row chunk's CountSketch ``S A``
    added into an (m, d₁) accumulator, the Iterative Hessian Sketch's fold
    step; each warp owns one bucket's output row, so the adds land in a
    fixed order without atomics.

Beside them one kernel with no TPU twin: :func:`row_stable_matmul`
(``csrc/row_stable_matmul.cu``), ``X @ W`` whose rows keep their bits
whatever the row count, the linear models' product in every exported
plan's buckets and every fused batch apply (ROADMAP C.8: the reference
leaves that product to XLA, and cuBLAS sums by the batch's shape).

All but the CountSketch kernel and the bf16 forms of ``gram_corr_sym_acc``,
``gram_sym_acc`` and ``block_gram_sym`` (one TMA + ``wgmma`` mainloop on
the tensor cores, ``csrc/gram_wgmma.cuh``, whose operand layout
:func:`_tma_layout_ok` states) run on one FP32-FMA register tile,
``row_stable_matmul`` among them, the pipelined one of
``csrc/fma_pipe.cuh`` (a ring of stages, operands row-major or K-major,
label tiles sized to k; chunks of the reduction that fill whole waves for
``block_corr``, :func:`corr_splits`, ``gaussian_kernel_block``,
:func:`gaussian_splits`, and ``gaussian_resid_block``,
:func:`gaussian_resid_splits`): ``cosine_features``, ``block_corr``,
``block_residual_update``, the two Gaussian kernels, and the Gramian
kernels of ``csrc/gram_tile.cuh`` — ``gram_corr.cu``'s four wrappers
(``gram_corr_sym`` and ``gram_corr`` in both dtypes, ``block_gram_sym``
and ``gram_sym_acc`` with float32 F) and ``gram_corr_sym_acc`` with
float32 F; and the image featurizer
(``csrc/conv_featurize.cu``, its patch tiles built in shared memory),
whose wrapper is in ``ops/cuda_images.py`` and whose kernel is built,
loaded and counted here with the others.

Each wrapper keeps its Pallas twin's name and operand contract. For a
tensor on the CPU it computes the plain PyTorch version (``*_ref``); for a
CUDA tensor it launches its kernel or raises — it checks device, dtype,
shape and layout, and never falls back. Given a meta tensor (the plan
verifier's shape inference) ``cosine_features``, ``conv_featurize`` and
``row_stable_matmul``, the kernels a transformer's ``device_fn`` reaches,
run the same checks and
return an empty meta output of the kernel's shape and dtype, launching
nothing. ``launches[name]`` counts the
wrapper's kernel launches (and nothing else), so a run can show that its
main path went through the kernels; ``staged[name]`` counts the bf16
operands ``gram_sym_acc`` and ``block_gram_sym`` copied into TMA-ready
rows before their launch.

The kernels are built at first use: ``nvcc`` compiles each source under
``csrc/`` for ``sm_90a`` into a shared library with a plain C interface
under ``build/keystone_tpu_torch/`` at the repository root (one library per
source, named by a hash of the source, the shared headers and the flags),
and ``ctypes`` loads it. A source may serve several wrappers
(``_SOURCES``): its library is built once and loaded once, with every
wrapper's C entry points bound.
:func:`build` compiles every kernel at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

# Kernel launches per wrapper since the last reset_launch_counts().
launches: Dict[str, int] = {
    "cosine_features": 0, "gram_corr_sym": 0,
    "block_gram_sym": 0, "block_corr": 0, "block_residual_update": 0,
    "gram_sym_acc": 0, "gaussian_kernel_block": 0, "gaussian_resid_block": 0,
    "conv_featurize": 0, "gram_corr_sym_acc": 0, "gram_corr": 0,
    "countsketch_scatter": 0, "row_stable_matmul": 0,
}
# bf16 operands copied into TMA-ready rows (a 16-byte-aligned base, a row
# stride of a multiple of 8 elements) before the wrapper's launch, since
# the last reset_launch_counts(): their layout failed _tma_layout_ok.
staged: Dict[str, int] = {"gram_sym_acc": 0, "block_gram_sym": 0}

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
        "kt_gram_corr", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]
    ),
    "gram_corr": (
        "kt_gram_corr", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P]
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
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _F, _I, _I, _P],
    ),
    "gaussian_resid_block": (
        "kt_gaussian_resid_block",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _F, _I, _P],
    ),
    "conv_featurize": (
        "kt_conv_featurize",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "gram_corr_sym_acc": (
        "kt_gram_corr_sym_acc",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _P],
    ),
    "countsketch_scatter": (
        "kt_countsketch_scatter",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _P],
    ),
    "row_stable_matmul": (
        "kt_row_stable_matmul", [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _P]
    ),
}
# Further C entry points of a source, beside its launching one.
_EXTRA_SYMBOLS = {
    "countsketch_scatter": [("kt_countsketch_prepare", [_P, _I, _I, _I, _P, _P, _P, _P])],
    "block_corr": [("kt_block_corr_config", [_I, _I, _P])],
    "block_residual_update": [("kt_block_residual_update_config", [_I, _I, _P])],
    "gaussian_kernel_block": [("kt_gaussian_kernel_block_config", [_I, _P])],
    "gaussian_resid_block": [("kt_gaussian_resid_block_config", [_I, _I, _I, _P])],
    "cosine_features": [("kt_cosine_features_config", [_I, _I, _I, _P])],
    "gram_corr": [("kt_gram_corr_config", [_P, _I, _I, _L, _I, _P])],
    "block_gram_sym": [("kt_block_gram_sym_config", [_P, _I, _I, _L, _I, _P])],
    "gram_sym_acc": [("kt_gram_sym_acc_config", [_P, _I, _L, _I, _P])],
    "gram_corr_sym_acc": [("kt_gram_corr_sym_acc_config", [_P, _I, _I, _L, _P])],
    "conv_featurize": [("kt_conv_featurize_config", [_I, _I, _I, _I, _I, _I, _P])],
    "row_stable_matmul": [("kt_row_stable_matmul_config", [_I, _I, _P])],
}
# Wrappers whose kernel lives in another wrapper's source: name -> source.
_SOURCES = {"gram_corr_sym": "gram_corr", "block_gram_sym": "gram_corr",
            "gram_sym_acc": "gram_corr"}
# Loaded libraries by source.
_LIBS: Dict[str, ctypes.CDLL] = {}


# Serialises every write to ``launches``: replicas replay captured
# programs on their own threads.
_launch_lock = threading.Lock()
# The calling thread's capture record, while it captures a CUDA graph.
_capturing = threading.local()


def reset_launch_counts() -> None:
    with _launch_lock:
        for counts in (launches, staged):
            for name in counts:
                counts[name] = 0


def count_launches(name: str, n: int = 1) -> None:
    """Count ``n`` launches of ``name``'s kernel: into the calling thread's
    capture record while it captures (a capture launches nothing), else
    into ``launches``."""
    record = getattr(_capturing, "record", None)
    if record is not None:
        record[name] = record.get(name, 0) + n
        return
    with _launch_lock:
        launches[name] += n


@contextmanager
def recording_launches():
    """Within the block, the calling thread's launches go into the yielded
    dict instead of ``launches`` (the launches a captured graph replays);
    other threads keep counting into ``launches``."""
    prev = getattr(_capturing, "record", None)
    record: Dict[str, int] = {}
    _capturing.record = record
    try:
        yield record
    finally:
        _capturing.record = prev


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


def _source(name: str) -> str:
    """The source under ``csrc/`` (without ``.cu``) of a wrapper's kernel."""
    return _SOURCES.get(name, name)


def _symbols(source: str) -> Dict[str, list]:
    """The C entry points of a source's library, symbol -> argtypes: the
    launching and further ones of every wrapper whose kernel it holds."""
    return {
        symbol: argtypes
        for name, entry in _ENTRY_POINTS.items() if _source(name) == source
        for symbol, argtypes in [entry, *_EXTRA_SYMBOLS.get(name, [])]
    }


def _library_path(name: str) -> Path:
    # The shared headers count too: a header edit must not load a library
    # built from the old one.
    source = _source(name)
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (_CSRC / f"{source}.cu").read_bytes() + headers + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD / f"lib{source}-{digest}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the sources of the wrappers ``names`` (default: all) that
    are not built yet, one ``nvcc`` per source, all started together;
    returns each compile's ptxas report (registers, shared memory, spills)
    by source. Raises on a failed build."""
    names = list(_ENTRY_POINTS) if names is None else names
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for source in dict.fromkeys(_source(name) for name in names):
        lib = _library_path(source)
        if lib.exists():
            reports[source] = "(already built)"
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{source}.cu")]
        procs.append((source, lib, tmp, subprocess.Popen(
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
    source = _source(name)
    lib = _LIBS.get(source)
    if lib is None:
        path = _library_path(source)
        if not path.exists():
            build([source])
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in _symbols(source).items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
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


_META = torch.device("meta")


def _meta_operands(name: str, tensors) -> bool:
    """True when an operand is a meta tensor: the call is shape inference
    (the plan verifier's, ``workflow/verify.py``), and the wrapper runs its
    shape and dtype checks and returns an empty meta output of the kernel's
    shape and dtype: it builds nothing, launches nothing and counts
    nothing. The operands that are not meta must lie on one device, as
    the kernel's would."""
    if not any(t.device.type == "meta" for t in tensors):
        return False
    devices = {t.device for t in tensors if t.device.type != "meta"}
    if len(devices) > 1:
        raise ValueError(f"{name}: operands must all lie on one device, got {devices}")
    return True


def _check_rows(name: str, t: torch.Tensor, what: str) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: {what} must be 2-D, got shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1 and t.numel() > 0:
        raise ValueError(f"{name}: {what} must have contiguous rows (stride(1) == 1)")


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _tma_layout_ok(ptr: int, row_stride: int, col_start: int = 0) -> bool:
    """Whether the tensor-core Gramian's TMA loads can read bf16 rows in
    place (``csrc/gram_wgmma.cuh``): the base address ``ptr`` and the first
    column ``col_start`` of the window on a 16-byte boundary, and a row
    stride (in elements) that is a multiple of 16 bytes."""
    return ptr % 16 == 0 and row_stride % 8 == 0 and col_start % 8 == 0


def _tma_rows(name: str, F, col_start: int, width: int):
    """The bf16 columns ``[col_start, col_start + width)`` of F where the
    tensor-core kernel reads them: F itself (its base moved to the window)
    when the layout passes :func:`_tma_layout_ok`, else a copy into a new
    buffer whose row stride is ``width`` rounded up to 8 elements, counted
    in ``staged[name]``. Returns (operand, its first column)."""
    if _tma_layout_ok(F.data_ptr(), F.stride(0), col_start):
        return F, col_start
    rows = torch.empty((F.shape[0], -(-width // 8) * 8), dtype=F.dtype, device=F.device)
    rows = rows[:, :width].copy_(F[:, col_start:col_start + width])
    with _launch_lock:
        staged[name] += 1
    return rows, 0


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


# The reference's cosine (pallas_ops._fast_cos): the even minimax
# polynomial in r², highest degree first, after a one-constant reduction.
_COS_COEFFS = (
    1.724826627109e-09,
    -2.707995836252e-07,
    2.476998508524e-05,
    -1.388780871411e-03,
    4.166649038026e-02,
    -4.999998919802e-01,
    9.999999892578e-01,
)
_TWO_PI = 6.283185307179586


def fast_cos(x):
    """The cosine :func:`cosine_features` evaluates, with the reference's
    float32 arithmetic: ``x`` reduced to [−π, π] with one 2π constant, then
    the degree-12 even polynomial in Horner form. Within 4e-7 of cos for
    |x| ≲ 10; the one-constant reduction's error grows with |x| (about 2e-5
    at |x| = 300)."""
    q = (x * (1.0 / _TWO_PI)).add_(0.5).floor_()
    r2 = (x - q.mul_(_TWO_PI)).square_()
    del q
    acc = torch.full_like(x, _COS_COEFFS[0])
    for c in _COS_COEFFS[1:]:
        acc.mul_(r2).add_(c)
    return acc


def _unit_rows(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _cosine_preactivation(Xf, Wf):
    """X Wᵀ for the cosine plain version. On the CPU each output is one
    fused multiply-add chain over the inputs in index order, in C++
    (``native.matmul_fma_chain_f32``), as the kernel sums it: a row's bits
    depend on that row and W alone, whatever the row count (an MKL product
    sums in an order it picks by the batch's shape, and a plan's padding
    buckets would part). Elsewhere torch's float32 product."""
    if Xf.device.type == "cpu" and Xf.shape[1] == Wf.shape[1]:
        from keystone_tpu_torch import native

        k = Xf.shape[1]
        return native.matmul_fma_chain_f32(_unit_rows(Xf), _unit_rows(Wf.T), max(k, 1),
                                           torch.get_num_threads())
    return Xf @ Wf.T


def cosine_features_ref(X, W, b, compute_dtype=torch.float32, out_dtype=None):
    """Plain PyTorch version of :func:`cosine_features`:
    ``fast_cos(X Wᵀ + b)`` from the same operand rounding, in float32 (on
    the CPU a row's bits follow that row, W and b alone:
    :func:`_cosine_preactivation`; the kernel sums each output in a fixed k
    order, so its rows keep their bits too)."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    op = _cosine_operands(X, W, compute_dtype)
    Xf = X.to(op).to(torch.float32)
    Wf = W.to(op).to(torch.float32)
    return fast_cos(_cosine_preactivation(Xf, Wf) + b.to(torch.float32)).to(out_dtype)


# cosine_features_grid's answers by (device index, m, n, d, bf16 operands,
# bf16 output): fixed for a card and a build, so worked out once.
_COSINE_GRIDS: Dict[tuple, Dict[str, float]] = {}


def cosine_features_grid(m: int, n: int, d: int, bf16: bool, out_bf16: bool,
                         device) -> Dict[str, float]:
    """The grid :func:`cosine_features` launches for X (m, d) and W (n, d)
    on ``device`` (a card), bf16 operands or output as asked: its 128 x 128
    tiles (one block each), the kernel's resident blocks an SM, registers
    and local (spilled) bytes a thread, and the waves. d picks the instance:
    16-byte loads where d is a whole number of 16-byte chunks (contiguous
    operands), element-wise otherwise."""
    device = torch.device(device)
    key = (device.index, m, n, d, bool(bf16), bool(out_bf16))
    grid = _COSINE_GRIDS.get(key)
    if grid is None:
        out = (ctypes.c_int * 3)()
        vec = d % (8 if bf16 else 4) == 0
        with torch.cuda.device(device):
            err = _lib("cosine_features").kt_cosine_features_config(
                int(bf16), int(out_bf16), int(vec), out)
        _check_launch("cosine_features", err)
        bps, regs, local = out
        tiles = -(-m // 128) * -(-n // 128)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = _grid(dict(tiles=tiles, blocks=tiles, blocks_per_sm=bps, registers=regs,
                          local_bytes=local), sms)
        _COSINE_GRIDS[key] = grid
    return grid


def cosine_features(X, W, b, compute_dtype=torch.float32, out_dtype=None, out=None):
    """cos(X @ Wᵀ + b) fused into the matmul epilogue.

    X: (m, d), W: (num_out, d), b: (num_out,). The featurized (m, num_out)
    matrix is written once; the pre-activation never exists in device
    memory (reference: CosineRandomFeatures.scala:19-45). The cosine is
    :func:`fast_cos`, the reference's polynomial.
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
    name = "cosine_features"
    meta = _meta_operands(name, operands)
    if not meta and all(t.device.type == "cpu" for t in operands):
        ref = cosine_features_ref(X, W, b, compute_dtype, out_dtype)
        return ref if out is None else out.copy_(ref)
    device = _META if meta else _cuda_operands(name, operands)
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
    if out is not None:
        _check_rows(name, out, "out")
        if out.shape != (X.shape[0], W.shape[0]):
            raise ValueError(
                f"{name}: out is {tuple(out.shape)}, expected {(X.shape[0], W.shape[0])}"
            )
    if meta:
        return out if out is not None else torch.empty(
            (X.shape[0], W.shape[0]), dtype=out_dtype, device=_META
        )
    op = _cosine_operands(X, W, compute_dtype)
    Xk = X if X.dtype == op else X.to(op)
    Wk = W if W.dtype == op else W.to(op)
    bk = b.to(torch.float32).contiguous()
    m, d = Xk.shape
    n = Wk.shape[0]
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    fn = _lib(name).kt_cosine_features
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
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
    (d, k) correlation, both float32. Launches the kernel of
    :func:`gram_corr` (``csrc/gram_corr.cu``), counted as this wrapper's.
    """
    if A.device.type == "cpu" and R.device.type == "cpu":
        return gram_corr_sym_ref(A, R)
    return _gram_corr_launch("gram_corr_sym", A, R)


def gram_corr_ref(A, R):
    """Plain PyTorch version of :func:`gram_corr`: the same function as
    :func:`gram_corr_sym_ref`, whose Gramian is whole too."""
    return gram_corr_sym_ref(A, R)


def gram_corr(A, R):
    """(AᵀA, AᵀR), the whole (d, d) Gramian returned (the dense form the
    block update takes with ``sym=False``): its upper tiles computed and
    mirrored, each entry of both outputs float32 FMA chains over row
    chunks in order (2,048 rows for the Gramian, 256 for the
    correlation), the chunks' sums added in order (``csrc/gram_tile.cuh``),
    so the Gramian is exactly symmetric and both outputs have the bits of
    :func:`gram_corr_sym`'s (:func:`gram_corr_grid` gives the launch's
    grid).

    A: (n, d) float32 or bfloat16, rows contiguous (a column window of a
    wider matrix is read in place through its row stride). R: (n, k),
    taken as float32. Returns the (d, d) Gramian and the (d, k)
    correlation, both float32.
    """
    if A.device.type == "cpu" and R.device.type == "cpu":
        return gram_corr_ref(A, R)
    return _gram_corr_launch("gram_corr", A, R)


def _gram_corr_config(out, k: int) -> Dict[str, float]:
    """A Gramian + correlation launch's grid from its config entry point's
    9 ints (``csrc/gram_tile.cuh``'s ``plan``)."""
    gram, corr, ktile, bps, regs, local, sms, corr_cols, vec = out
    return _grid(dict(blocks=gram + corr, gram_blocks=gram, corr_blocks=corr,
                      corr_cols=corr_cols, ktile=ktile,
                      masked=1 - k / max(-(-k // ktile) * ktile, 1), vec=bool(vec),
                      blocks_per_sm=bps, registers=regs, local_bytes=local), sms)


def gram_corr_grid(A, k: int) -> Dict[str, float]:
    """The grid :func:`gram_corr` launches for A (on a card) and k label
    columns: its blocks (the correlation's first, each ``corr_cols``
    columns of A, then the Gramian's upper tiles), the correlation's
    label-tile width and share of masked label FMAs, whether A is copied in
    16-byte chunks (``vec``: A's base and row stride whole chunks), the
    kernel's resident blocks an SM, registers and local (spilled) bytes a
    thread, and the waves."""
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(A.device):
        err = _lib("gram_corr").kt_gram_corr_config(
            A.data_ptr(), A.shape[1], k, A.stride(0), int(A.dtype == torch.bfloat16), out)
    _check_launch("gram_corr", err)
    return _gram_corr_config(out, k)


def _gram_corr_launch(name: str, A, R):
    """Launch ``csrc/gram_corr.cu``'s kernel for the wrapper ``name``
    (``gram_corr_sym`` or ``gram_corr``, the same function, operand guards
    and C entry point) on CUDA operands, counted as its launch, or raise."""
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
    fn = getattr(_lib(name), _ENTRY_POINTS[name][0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
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
    f32 accumulation dtype (F float32 or bfloat16). For bf16 F,
    :func:`block_gram_sym` runs on the tensor cores, whose TMA loads read
    the window in place where :func:`_tma_layout_ok` holds (F's base and
    row stride, and ``block``, multiples of 16 bytes: the flat fit's slab
    at TIMIT's d = 16,384 and blocks of 4,096) and a copy of it otherwise;
    :func:`block_corr` and :func:`block_residual_update` take any bf16
    window on their FP32-FMA tiles."""
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


def _gram_alone_config(out, staged_copy: bool) -> Dict[str, float]:
    """A Gramian-alone launch's grid from its config entry point's 7 ints
    (``csrc/gram_corr.cu``'s ``gram_config``)."""
    blocks, vec, bps, regs, local, sms, tensor_cores = out
    return _grid(dict(blocks=blocks, vec=bool(vec), tensor_cores=bool(tensor_cores),
                      staged=staged_copy, blocks_per_sm=bps, registers=regs,
                      local_bytes=local), sms)


def block_gram_sym_grid(F, col_start: int, block: int) -> Dict[str, float]:
    """The grid :func:`block_gram_sym` launches for the window
    ``F[:, col_start:col_start+block]`` of F (on a card): its blocks (the
    upper 128 x 128 tiles), whether it runs on the tensor cores
    (``tensor_cores``: bf16 F) and, if so, whether the window is first
    copied into TMA-ready rows (``staged``), for float32 F whether it copies
    the window in 16-byte chunks (``vec``: the window's base and F's row
    stride whole chunks), the kernel's resident blocks an SM, registers and
    local (spilled) bytes a thread, and the waves."""
    col_start, block = int(col_start), int(block)
    bf16 = F.dtype == torch.bfloat16
    staged_copy = bf16 and not _tma_layout_ok(F.data_ptr(), F.stride(0), col_start)
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(F.device):
        err = _lib("block_gram_sym").kt_block_gram_sym_config(
            F.data_ptr(), col_start, block, F.stride(0), int(bf16), out)
    _check_launch("block_gram_sym", err)
    return _gram_alone_config(out, staged_copy)


def _check_tensor_map(name: str, err: int) -> None:
    if err == -1:
        raise RuntimeError(f"{name}: the TMA tensor map of F could not be made "
                           f"(cuTensorMapEncodeTiled failed or is missing)")
    _check_launch(name, err)


def block_gram_sym(F, col_start: int, block: int):
    """Symmetric Gramian of the column window ``F[:, col_start:col_start+block]``,
    its upper-triangle tiles computed and mirrored, no correlation. F:
    (n, d) float32 or bfloat16 with contiguous rows. Returns (block, block)
    float32 (:func:`block_gram_sym_grid` gives the launch's grid).

    float32 F: the Gramian tiles of ``csrc/gram_corr.cu``, the window read
    in place; every entry float32 FMA chains over row chunks of 2,048 in
    order, the chunks' sums added in order, so the bits of
    :func:`gram_corr_sym` on a copy of the window.

    bfloat16 F: the tensor cores (``csrc/gram_wgmma.cuh``, TMA + ``wgmma``,
    its STORE epilogue), the window read in place where
    :func:`_tma_layout_ok` holds for it, else copied first into rows of a
    stride rounded up to 8 elements (counted in ``staged``; the same bits
    either way). The output has the bits of ``gram_sym_acc(0, window)``
    with its upper triangle mirrored (``triu(G) + triu(G, 1).T``).

    Bound on an H100 at the TIMIT window (F 65,536 x 16,384, 4,096
    columns): 16.4 ms for float32 F at the FP32 peak, 1.11 ms for bf16 F at
    the tensor cores' bf16 peak, both by operations.
    """
    col_start, block = int(col_start), int(block)
    if F.device.type == "cpu":
        return block_gram_sym_ref(F, col_start, block)
    name = "block_gram_sym"
    device = _cuda_operands(name, (F,))
    _check_window(name, F, col_start, block)
    gram = torch.empty((block, block), dtype=torch.float32, device=device)
    if block == 0:
        return gram
    bf16 = F.dtype == torch.bfloat16
    fn = _lib(name).kt_block_gram_sym
    with torch.cuda.device(device):
        if bf16:
            F, col_start = _tma_rows(name, F, col_start, block)
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(F.data_ptr(), gram.data_ptr(), F.shape[0], col_start, block, F.stride(0),
                 int(bf16), stream)
    _check_tensor_map(name, err)
    return gram


def _corr_operand(F, R):
    """R as the correlation sees it: float32, rounded to bf16 first when F is
    bf16 (the reference's kernel computes in F's dtype)."""
    Rf = R.to(torch.float32)
    return Rf.to(torch.bfloat16).to(torch.float32) if F.dtype == torch.bfloat16 else Rf


def block_corr_ref(F, col_start: int, block: int, R):
    """Plain PyTorch version of :func:`block_corr`: ``FwᵀR`` in float32."""
    return _window(F, col_start, block).T @ _corr_operand(F, R)


# Fewest rows a block_corr row chunk sums: shorter chunks would spend
# more of their time filling and draining the cp.async ring.
_MIN_SPLIT_ROWS = 1024


def _wave_splits(length: int, minimum: int, tiles: int, sms: int, blocks_per_sm: int,
                 whole: bool = False) -> int:
    """Chunks of a reduction of ``length`` steps: the fewest that bring the
    (tile, chunk) grid within 5% of a whole number of waves of the card's
    resident blocks (``sms * blocks_per_sm``), each chunk at least
    ``minimum`` steps; where none does, the count that fills most.
    ``whole``: each step is a large unit of work (a row tile), so the
    chunks' lengths differ by a whole step and the longest,
    ``ceil(length / s)``, sets a wave's time; the fill then counts the steps
    that the waves' slots could hold in that time."""
    if tiles <= 0:
        return 1
    resident = sms * max(blocks_per_sm, 1)
    best, best_fill = 1, 0.0
    for s in range(1, max(length // minimum, 1) + 1):
        blocks = tiles * s
        fill = blocks / (-(-blocks // resident) * resident)
        if whole:
            fill *= length / (s * -(-length // s))
        if fill >= 0.95:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def corr_splits(n: int, tiles: int, sms: int, blocks_per_sm: int) -> int:
    """Row chunks of a :func:`block_corr` launch: the fewest that bring the
    (tile, chunk) grid within 5% of a whole number of waves of the card's
    resident blocks (``sms * blocks_per_sm``), each chunk at least
    ``_MIN_SPLIT_ROWS`` rows; where none does, the count that fills most. A
    function of the shapes and the card alone, so the chunks' partial sums
    add in the same order every run."""
    return _wave_splits(n, _MIN_SPLIT_ROWS, tiles, sms, blocks_per_sm)


def _grid(config, sms: int) -> Dict[str, float]:
    """A grid description with the card's SM count and its waves: blocks
    over resident blocks (``sms * blocks_per_sm``)."""
    config["sms"] = sms
    config["waves"] = config["blocks"] / (sms * max(config["blocks_per_sm"], 1))
    return config


# block_corr_grid's answers by (device index, n, block, k, bf16 F): fixed
# for a card and a build, so worked out once.
_BLOCK_CORR_GRIDS: Dict[tuple, Dict[str, float]] = {}


def block_corr_grid(n: int, block: int, k: int, bf16: bool, device) -> Dict[str, float]:
    """The grid :func:`block_corr` launches for an n-row, block-wide window
    and k label columns on ``device`` (a card): its label-tile width, tiles,
    row chunks, blocks, the kernel's resident blocks an SM, registers and
    local (spilled) bytes a thread, the waves and the share of masked label
    FMAs."""
    device = torch.device(device)
    key = (device.index, n, block, k, bool(bf16))
    grid = _BLOCK_CORR_GRIDS.get(key)
    if grid is None:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = _lib("block_corr").kt_block_corr_config(k, int(bf16), out)
        _check_launch("block_corr", err)
        ktile, bps, regs, local = out
        label_tiles = -(-k // ktile)
        tiles = -(-block // 128) * label_tiles
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = corr_splits(n, tiles, sms, bps)
        grid = _grid(dict(ktile=ktile, tiles=tiles, splits=splits, blocks=tiles * splits,
                          blocks_per_sm=bps, registers=regs, local_bytes=local,
                          masked=1 - k / (label_tiles * ktile)), sms)
        _BLOCK_CORR_GRIDS[key] = grid
    return grid


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
    splits = block_corr_grid(n, block, k, F.dtype == torch.bfloat16, device)["splits"]
    partials = None
    if splits > 1:
        partials = torch.empty((splits, block, k), dtype=torch.float32, device=device)
    fn = _lib(name).kt_block_corr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
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


# block_residual_update_grid's answers by (device index, k, bf16 F): fixed
# for a card and a build, so worked out once.
_RESID_CONFIGS: Dict[tuple, Tuple[int, int, int, int]] = {}


def block_residual_update_grid(n: int, k: int, bf16: bool, device) -> Dict[str, float]:
    """The grid :func:`block_residual_update` launches for n rows and k label
    columns on ``device`` (a card): its label-tile width, row tiles, label
    tiles, blocks (one a row tile and label tile: the window's columns are
    not split), the kernel's resident blocks an SM, registers and local
    (spilled) bytes a thread, the waves and the share of masked label
    FMAs."""
    device = torch.device(device)
    key = (device.index, k, bool(bf16))
    if key not in _RESID_CONFIGS:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = _lib("block_residual_update").kt_block_residual_update_config(
                k, int(bf16), out)
        _check_launch("block_residual_update", err)
        _RESID_CONFIGS[key] = tuple(out)
    ktile, bps, regs, local = _RESID_CONFIGS[key]
    label_tiles = -(-k // ktile)
    row_tiles = -(-n // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _grid(dict(ktile=ktile, row_tiles=row_tiles, label_tiles=label_tiles,
                      blocks=row_tiles * label_tiles, blocks_per_sm=bps, registers=regs,
                      local_bytes=local, masked=1 - k / (label_tiles * ktile)), sms)


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
        count_launches(name)
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
    """Whether :func:`gram_sym_acc`'s kernels can read the feature tile F
    (counterpart of ``pallas_ops.gram_acc_ok``). The TPU kernel needs rows
    in whole 512-row tiles and d in whole 512- or 1024-wide column tiles;
    these mask ragged edges, so the guard asks only for a 2-D F with
    contiguous rows and an f32 accumulation dtype: float32 F (the FP32-FMA
    tile) or bfloat16 F (the tensor cores, which read it in place where
    :func:`_tma_layout_ok` holds, as the cosine bank's bf16 tiles do when d
    is a multiple of 8, and a copy of it otherwise). The streamed fold
    copies a card tile that fails it to contiguous rows; the fold's carry G
    is float32 (d, d) with contiguous rows by construction."""
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


def gram_sym_acc_grid(F) -> Dict[str, float]:
    """The grid :func:`gram_sym_acc` launches for the feature tile F (on a
    card): :func:`block_gram_sym_grid`'s keys for F's d columns (bf16 F on
    the tensor cores, ``staged`` where F is first copied into TMA-ready
    rows; float32 F copied in 16-byte chunks where ``vec``)."""
    bf16 = F.dtype == torch.bfloat16
    staged_copy = bf16 and not _tma_layout_ok(F.data_ptr(), F.stride(0))
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(F.device):
        err = _lib("gram_sym_acc").kt_gram_sym_acc_config(
            F.data_ptr(), F.shape[1], F.stride(0), int(bf16), out)
    _check_launch("gram_sym_acc", err)
    return _gram_alone_config(out, staged_copy)


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

    On the card float32 F takes the Gramian tiles of ``csrc/gram_corr.cu``
    (:func:`block_gram_sym`'s) with an accumulating epilogue: each entry is
    G's entry plus float32 FMA chains over row chunks of 2,048, the chunks'
    sums added in order. bfloat16 F takes the tensor cores
    (``csrc/gram_wgmma.cuh``, TMA + ``wgmma``), the kernel of
    :func:`gram_corr_sym_acc`'s bf16 form with no labels, so its output
    has the bits of that form's Gramian; F is read in place where
    :func:`_tma_layout_ok` holds, else copied first into rows of a stride
    rounded up to 8 elements (counted in ``staged``; the same bits either
    way). In both, each entry is read and written by one thread in one
    fixed order, so in place gives the bits of a new buffer
    (:func:`gram_sym_acc_grid` gives the launch's grid).

    Bound on an H100 at the streamed fit's tile (F 32,768 x 16,384): 131.3
    ms for float32 F at the FP32 peak, 8.89 ms for bf16 F at the tensor
    cores' bf16 peak, both by operations.
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
    bf16 = F.dtype == torch.bfloat16
    fn = _lib(name).kt_gram_sym_acc
    with torch.cuda.device(device):
        if bf16:
            F, _ = _tma_rows(name, F, 0, d)
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(F.data_ptr(), G.data_ptr(), out.data_ptr(), n, d, F.stride(0), G.stride(0),
                 out.stride(0), int(bf16), stream)
    _check_tensor_map(name, err)
    return out


# ---------------------------------------------------------------------------
# Accumulating symmetric Gramian + correlation of the sparse gram fold
# ---------------------------------------------------------------------------


def gram_corr_acc_ok(F) -> bool:
    """Whether :func:`gram_corr_sym_acc`'s kernel can read the chunk slab F
    as it is (counterpart of ``pallas_ops.gram_corr_acc_ok``). The kernel
    masks ragged rows, columns and label columns, so the guard asks for a
    2-D F with contiguous rows, float32 or bfloat16 (an empty one whatever
    its strides), and for bf16 F what its TMA loads need: a 16-byte-aligned
    base and a row stride that is a multiple of 8 elements (16 bytes), so
    that every row starts on a 16-byte boundary. The fold pads its bf16
    slab's rows to 64 elements (``ops/sparse.py``), so every chunk passes."""
    if F.dim() == 2 and F.numel() == 0 and F.dtype in _KERNEL_DTYPES:
        return True
    return gram_acc_ok(F) and (
        F.dtype != torch.bfloat16 or _tma_layout_ok(F.data_ptr(), F.stride(0))
    )


def gram_corr_sym_acc_ref(G, C, F, R):
    """Plain PyTorch version of :func:`gram_corr_sym_acc`:
    ``(G + FᵀF, C + FᵀR)`` as float32, every entry computed in float32
    (bf16 F is exact in f32) or in F's own precision where that is wider;
    R rounded to bf16 first when F is bf16."""
    acc = torch.promote_types(F.dtype, torch.float32)
    Ff = F.to(acc)
    Rq = _corr_operand(F, R).to(acc)
    return (
        (G.to(acc) + Ff.T @ Ff).to(torch.float32),
        (C.to(acc) + Ff.T @ Rq).to(torch.float32),
    )


def gram_corr_sym_acc_grid(F, k: int) -> Dict[str, float]:
    """The grid :func:`gram_corr_sym_acc` launches for float32 F (on a
    card) and k label columns, :func:`gram_corr_grid`'s keys: the
    correlation's blocks, then the Gramian's upper tiles, and whether F is
    copied in 16-byte chunks (F's base and row stride whole chunks). bf16 F
    runs on the tensor cores, one block an upper tile; it has no such
    grid."""
    if F.dtype != torch.float32:
        raise TypeError(f"gram_corr_sym_acc_grid: the float32 form's grid, got {F.dtype}")
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(F.device):
        err = _lib("gram_corr_sym_acc").kt_gram_corr_sym_acc_config(
            F.data_ptr(), F.shape[1], k, F.stride(0), out)
    _check_launch("gram_corr_sym_acc", err)
    return _gram_corr_config(out, k)


def gram_corr_sym_acc(G, C, F, R, out=None):
    """``(G + FᵀF, C + FᵀR)`` in one pass over F, the Gramian on the
    upper-triangle 128 x 128 tiles only.

    G: (d, d) float32 with a meaningful upper triangle; C: (d, k) float32;
    F: (n, d) float32 or bfloat16 with contiguous rows (bf16 F on the card
    also 16-byte aligned with a row stride of a multiple of 8 elements, as
    :func:`gram_corr_acc_ok` says, or it raises); R: (n, k), taken as
    float32 and rounded to bf16 in the product when F is bf16 (the
    reference quantizes R to F's compute dtype). Ragged n, d and k are
    masked in the kernel. Writes ``out = (gout, cout)`` — new float32
    buffers, or the pair given, which may be ``(G, C)`` themselves to
    accumulate in place — and returns it. The strictly-lower tiles of gout
    are undefined (left as they were when gout is G): callers mirror once
    after the last accumulation, as :func:`gram_sym_acc`'s contract has it.

    On the card bf16 F runs on the tensor cores (TMA + ``wgmma``, float32
    accumulators) and float32 F on the FP32 FMA units, on the Gramian
    kernel of ``csrc/gram_tile.cuh`` (:func:`gram_sym_acc`'s tiles and
    :func:`gram_corr`'s correlation blocks, :func:`gram_corr_sym_acc_grid`);
    either way the sums have one fixed order, so runs and in-place calls
    give the same bits. float32 F is copied in 16-byte chunks when its base
    and row stride are whole chunks (the fold pads its float32 slab's rows
    to 4 elements for that), else element by element.
    """
    operands = (G, C, F, R) if out is None else (G, C, F, R, *out)
    if all(t.device.type == "cpu" for t in operands):
        gram, corr = gram_corr_sym_acc_ref(G, C, F, R)
        if out is None:
            return gram, corr
        out[0].copy_(gram)
        out[1].copy_(corr)
        return out
    name = "gram_corr_sym_acc"
    device = _cuda_operands(name, operands)
    if not gram_corr_acc_ok(F):
        raise TypeError(
            f"{name}: F must be 2-D float32 or bfloat16 with contiguous rows, and for "
            f"bfloat16 a 16-byte-aligned base and a row stride that is a multiple of 8 "
            f"elements (the kernel's TMA loads read it in place; pad the rows, F is never "
            f"copied), got shape {tuple(F.shape)}, {F.dtype}, strides {F.stride()}, "
            f"base address {F.data_ptr():#x}"
        )
    Rk = R if R.dtype == torch.float32 else R.to(torch.float32)
    _check_rows(name, Rk, "R")
    n, d = F.shape
    k = Rk.shape[1]
    if Rk.shape[0] != n:
        raise ValueError(f"{name}: F {tuple(F.shape)} and R {tuple(R.shape)} must have the same rows")
    for what, t, shape in (("G", G, (d, d)), ("C", C, (d, k))):
        _check_rows(name, t, what)
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(
                f"{name}: {what} must be {shape} float32, got {tuple(t.shape)} {t.dtype}"
            )
    if out is None:
        out = (
            torch.empty((d, d), dtype=torch.float32, device=device),
            torch.empty((d, k), dtype=torch.float32, device=device),
        )
    else:
        for what, t, shape in (("gout", out[0], (d, d)), ("cout", out[1], (d, k))):
            _check_rows(name, t, what)
            if t.dtype != torch.float32 or t.shape != shape:
                raise ValueError(
                    f"{name}: {what} must be {shape} float32, got {tuple(t.shape)} {t.dtype}"
                )
    if d == 0:
        return out
    gout, cout = out
    fn = _lib(name).kt_gram_corr_sym_acc
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(
            F.data_ptr(), Rk.data_ptr(), G.data_ptr(), C.data_ptr(), gout.data_ptr(),
            cout.data_ptr(), n, d, k, F.stride(0), Rk.stride(0), G.stride(0), C.stride(0),
            gout.stride(0), cout.stride(0), int(F.dtype == torch.bfloat16), stream,
        )
    _check_tensor_map(name, err)
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


# Fewest features a gaussian_kernel_block feature chunk sums: 8 of its
# 8-feature stages.
_MIN_SPLIT_FEATURES = 64


def gaussian_splits(m: int, n: int, d: int, sms: int, blocks_per_sm: int) -> int:
    """Feature chunks of a :func:`gaussian_kernel_block` launch. One where
    the (m, n) output's 128 x 128 tiles alone make a wave of the card's
    resident blocks (``sms * blocks_per_sm``): there chunks would only add
    the partial sums' traffic (at the CIFAR test apply, 392 tiles, 2 chunks
    measured 4% slower than 1). Otherwise :func:`corr_splits`' rule along
    the feature axis: the fewest chunks that bring the (tile, chunk) grid
    within 5% of a whole number of waves, each at least
    ``_MIN_SPLIT_FEATURES`` features; where none does, the count that
    fills most. A function of the shapes and the card alone, so the chunks'
    partial sums add in the same order every run. At the CIFAR shapes (d =
    1,800, 132 SMs, 2 blocks an SM): 1 for the train and test applies
    (50,000 and 12,500 x 512), 16 for a 512-row diagonal block and 28 for
    the ragged 336-row one."""
    tiles = -(-m // 128) * -(-n // 128)
    if tiles >= sms * max(blocks_per_sm, 1):
        return 1
    return _wave_splits(d, _MIN_SPLIT_FEATURES, tiles, sms, blocks_per_sm)


# gaussian_kernel_block_grid's answers by (device index, m, n, d, bf16):
# fixed for a card and a build, so worked out once.
_GAUSS_GRIDS: Dict[tuple, Dict[str, float]] = {}


def gaussian_kernel_block_grid(m: int, n: int, d: int, bf16: bool, device) -> Dict[str, float]:
    """The grid :func:`gaussian_kernel_block` launches for X (m, d) and Y
    (n, d) on ``device`` (a card): its 128 x 128 tiles, feature chunks
    (:func:`gaussian_splits`), blocks, the kernel's resident blocks an SM,
    registers and local (spilled) bytes a thread, and the waves."""
    device = torch.device(device)
    key = (device.index, m, n, d, bool(bf16))
    grid = _GAUSS_GRIDS.get(key)
    if grid is None:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            err = _lib("gaussian_kernel_block").kt_gaussian_kernel_block_config(int(bf16), out)
        _check_launch("gaussian_kernel_block", err)
        bps, regs, local = out
        tiles = -(-m // 128) * -(-n // 128)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = gaussian_splits(m, n, d, sms, bps)
        grid = _grid(dict(tiles=tiles, splits=splits, blocks=tiles * splits, blocks_per_sm=bps,
                          registers=regs, local_bytes=local), sms)
        _GAUSS_GRIDS[key] = grid
    return grid


def gaussian_kernel_block(X, Y, x_norms, y_norms, gamma: float,
                          compute_dtype=torch.float32):
    """K[i, j] = exp(−γ‖X_i − Y_j‖²) as one fused kernel, the squared
    distances never in device memory.

    X: (m, d), Y: (n, d) with contiguous rows (a row slice of a larger
    matrix is read in place); x_norms (m,), y_norms (n,) their squared row
    norms. ``compute_dtype=torch.bfloat16`` rounds X and Y to bf16 (the
    products still accumulate in f32; bf16 operands are used as they are).
    Returns (m, n) float32. Ragged m, n and d are masked in the kernel.
    Where the output has too few tiles to fill the card (a diagonal block),
    the feature sum is split into chunks (:func:`gaussian_splits`) whose
    partial sums add in a fixed order: no atomics, the same bits every run.
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
    bf16 = Xk.dtype == torch.bfloat16
    splits = gaussian_kernel_block_grid(m, n, d, bf16, device)["splits"]
    partials = None
    if splits > 1:
        partials = torch.empty((splits, m, n), dtype=torch.float32, device=device)
    fn = _lib(name).kt_gaussian_kernel_block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(
            Xk.data_ptr(), Yk.data_ptr(), xn.data_ptr(), yn.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(), m, n, d, Xk.stride(0),
            Yk.stride(0), out.stride(0), float(gamma), splits, int(bf16), stream,
        )
    _check_launch(name, err)
    return out


def gaussian_resid_block_ref(X, Y, x_norms, y_norms, W, gamma: float,
                             compute_dtype=torch.float32):
    """Plain PyTorch version of :func:`gaussian_resid_block`:
    ``K(X, Y)ᵀ W`` in float32, K from :func:`gaussian_kernel_block_ref`."""
    K = gaussian_kernel_block_ref(X, Y, x_norms, y_norms, gamma, compute_dtype)
    return K.T @ W.to(torch.float32)


def gaussian_resid_splits(m: int, n: int, sms: int, blocks_per_sm: int) -> int:
    """Row chunks of a :func:`gaussian_resid_block` launch: the fewest that
    bring the (column tile, chunk) grid within 5% of whole waves of the
    card's resident blocks (``sms * blocks_per_sm``), each chunk whole
    128-row tiles of X and none empty (the kernel gives chunk z the row
    tiles [z T / s, (z + 1) T / s) of T = ceil(m / 128)); where none does,
    the count that fills most. A row tile is a sixth of a block's work at
    the CIFAR sweep, so the fill counts the tiles the waves could hold in
    the time of the longest chunk (:func:`_wave_splits` with ``whole``):
    blocks alone would take 63 chunks of 6–7 tiles for 0.95 of a wave,
    where 66 of 5–6 take a seventh less time. A function of the shapes and
    the card alone, so the chunks' partial sums add in the same order every
    run. At the CIFAR sweep (m = 50,000: 391 row tiles; 132 SMs, 2 blocks
    an SM): 66 chunks x 4 column tiles = 264 blocks at a 512-row block
    (0.99 of the wave's tile slots), 80 x 3 = 240 at the ragged 336-row one
    (0.89, the most any count reaches)."""
    return _wave_splits(-(-m // 128), 1, -(-n // 128), sms, blocks_per_sm, whole=True)


# gaussian_resid_block_grid's answers by (device index, m, n, d, k, bf16):
# fixed for a card and a build, so worked out once.
_RESID_GRIDS: Dict[tuple, Dict[str, float]] = {}


def gaussian_resid_block_grid(m: int, n: int, d: int, k: int, bf16: bool,
                              device) -> Dict[str, float]:
    """The grid :func:`gaussian_resid_block` launches for X (m, d), Y (n,
    d) and k label columns on ``device`` (a card): its column tiles (128 of
    Y's rows each), X's row tiles, row chunks (:func:`gaussian_resid_splits`)
    and the row tiles a chunk (fewest, most), blocks, the label-tile width
    and the label tiles (contraction passes a row tile), the kernel's
    resident blocks an SM, registers and local (spilled) bytes a thread,
    shared memory a block, and the waves. d picks the instance:
    16-byte loads where d is a whole number of 16-byte chunks (contiguous
    operands), element-wise otherwise."""
    device = torch.device(device)
    key = (device.index, m, n, d, k, bool(bf16))
    grid = _RESID_GRIDS.get(key)
    if grid is None:
        out = (ctypes.c_int * 5)()
        vec = d % (8 if bf16 else 4) == 0
        with torch.cuda.device(device):
            err = _lib("gaussian_resid_block").kt_gaussian_resid_block_config(
                k, int(bf16), int(vec), out)
        _check_launch("gaussian_resid_block", err)
        ktile, bps, regs, local, smem = out
        tiles, row_tiles = -(-n // 128), -(-m // 128)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = gaussian_resid_splits(m, n, sms, bps)
        grid = _grid(dict(tiles=tiles, row_tiles=row_tiles, splits=splits,
                          chunk_tiles=(row_tiles // splits, -(-row_tiles // splits)),
                          blocks=tiles * splits, ktile=ktile, label_tiles=-(-k // ktile),
                          blocks_per_sm=bps,
                          registers=regs, local_bytes=local, smem_bytes=smem), sms)
        _RESID_GRIDS[key] = grid
    return grid


def gaussian_resid_block(X, Y, x_norms, y_norms, W, gamma: float,
                         compute_dtype=torch.float32):
    """``K(X, Y)ᵀ W`` with the Gaussian kernel block made tile by tile and
    contracted at once: the (m, n) block never exists in device memory.

    X: (m, d) training rows, Y: (n, d) one block's rows, both with
    contiguous rows; x_norms (m,), y_norms (n,); W: (m, k) the dual model,
    taken as float32. Returns (n, k) float32. Rows of X past m are masked
    in the kernel, not read, so W needs no ghost rows. The sum over the m
    rows is split into chunks of whole row tiles that fill whole waves of
    the card (:func:`gaussian_resid_splits`), whose partial sums add in a
    fixed order: no atomics, the same bits every run.
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
    splits = gaussian_resid_block_grid(m, n, d, k, Xk.dtype == torch.bfloat16, device)["splits"]
    partials = None
    if splits > 1:
        partials = torch.empty((splits, n, k), dtype=torch.float32, device=device)
    fn = _lib(name).kt_gaussian_resid_block
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(
            Xk.data_ptr(), Yk.data_ptr(), xn.data_ptr(), yn.data_ptr(), Wk.data_ptr(),
            None if partials is None else partials.data_ptr(), out.data_ptr(),
            m, n, d, k, Xk.stride(0), Yk.stride(0), Wk.stride(0), splits, float(gamma),
            int(Xk.dtype == torch.bfloat16), stream,
        )
    _check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# CountSketch of one row chunk: SA[b, j] += Σ_{bucket_i = b} sign_i Σ_{idx[i,t] = j} val[i,t]
# ---------------------------------------------------------------------------


def _countsketch_check(name, idx, val, bucket, sign, m: int, d1: int):
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(
            f"{name}: idx and val must both be (c, s), got {tuple(idx.shape)}, "
            f"{tuple(val.shape)}"
        )
    c = idx.shape[0]
    if bucket.shape != (c,) or sign.shape != (c,):
        raise ValueError(
            f"{name}: bucket and sign must be ({c},), got {tuple(bucket.shape)}, "
            f"{tuple(sign.shape)}"
        )
    if m < 0 or d1 < 0:
        raise ValueError(f"{name}: m and d1 must be non-negative, got {m}, {d1}")


def _countsketch_out(name, out, m: int, d1: int, device):
    if out is None:
        return torch.zeros((m, d1), dtype=torch.float32, device=device)
    _check_rows(name, out, "out")
    if out.dtype != torch.float32 or out.shape != (m, d1):
        raise ValueError(
            f"{name}: out must be ({m}, {d1}) float32, got {tuple(out.shape)} {out.dtype}"
        )
    return out


def countsketch_scatter_ref(idx, val, bucket, sign, m: int, d1: int, out=None):
    """Plain PyTorch version of :func:`countsketch_scatter`: one flattened
    scatter-add (``index_add_``) of ``sign_i · val[i, t]`` into
    ``out.view(-1)`` at ``bucket_i · d1 + idx[i, t]``, over the live lanes
    in (row, slot) order — the reference's own fallback
    (keystone_tpu/ops/learning/sketch.py). On a CPU tensor the scatter adds
    one lane after another in that order."""
    m, d1 = int(m), int(d1)
    _countsketch_check("countsketch_scatter", idx, val, bucket, sign, m, d1)
    device = val.device
    out = _countsketch_out("countsketch_scatter", out, m, d1, device)
    j = idx.to(device=device, dtype=torch.int64)
    b = bucket.to(device=device, dtype=torch.int64)
    live = (j >= 0) & (j < d1) & ((b >= 0) & (b < m))[:, None]
    seg = (b[:, None] * d1 + j)[live]
    src = (sign.to(device=device, dtype=torch.float32)[:, None]
           * val.to(torch.float32))[live]
    flat = out if out.is_contiguous() else out.contiguous()
    flat.view(-1).index_add_(0, seg, src)
    return out if flat is out else out.copy_(flat)


def countsketch_order(bucket, m: int):
    """A chunk's rows ordered by bucket and, within a bucket, by row (a
    stable sort; rows whose bucket lies outside [0, m) come last), and
    ``starts`` (m + 1,): the position in that order of each bucket's first
    row, ``starts[m]`` the end of the live rows. Both int32 on the bucket's
    device, with no read on the host. The plain form of the CountSketch
    kernel's index preparation (:func:`countsketch_prepare`), which on the
    card places the rows unstably and leaves the order within a bucket to
    the kernel."""
    b = bucket.to(torch.int64)
    key = torch.where((b >= 0) & (b < m), b, m)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(m + 1, device=b.device))
    return order.to(torch.int32), starts.to(torch.int32)


def countsketch_prepare(bucket, m: int):
    """The CountSketch kernel's index preparation on the card: a histogram
    of the live buckets, its exclusive scan into ``starts`` (m + 1,) and a
    placement of each live row into its bucket's segment of ``order`` (c,)
    — hand-written kernels, no host read. Rows whose bucket lies outside
    [0, m) are not placed (``order`` past ``starts[m]`` is undefined), and
    within a bucket the rows come in any order: the scatter kernel takes
    them by increasing row. bucket: (c,) int32 or int64 on a CUDA device;
    m > 0. Returns (order, starts), int32."""
    name = "countsketch_scatter"
    device = _cuda_operands(name, (bucket,))
    if bucket.dtype not in (torch.int32, torch.int64) or bucket.dim() != 1:
        raise TypeError(f"{name}: bucket must be 1-D int32 or int64, got {bucket.dtype}, "
                        f"shape {tuple(bucket.shape)}")
    bk = bucket.contiguous()
    c = bk.shape[0]
    scratch = torch.empty((c + 2 * m + 1,), dtype=torch.int32, device=device)
    order, starts, counts = scratch[:c], scratch[c:c + m + 1], scratch[c + m + 1:]
    fn = _lib(name).kt_countsketch_prepare
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(bk.data_ptr(), int(bk.dtype == torch.int64), c, m, order.data_ptr(),
                 starts.data_ptr(), counts.data_ptr(), stream)
    _check_launch(name, err)
    return order, starts


def countsketch_scatter(idx, val, bucket, sign, m: int, d1: int, out=None):
    """One row chunk's CountSketch ``S A`` as an (m, d1) float32 sum:
    ``SA[b, j] = Σ_{i: bucket_i = b} sign_i · Σ_{t: idx[i,t] = j} val[i,t]``.

    idx: (c, s) integer column ids (−1, or anything outside [0, d1), marks
    a masked lane, which adds nothing); val: (c, s) float32; bucket: (c,)
    integer, a row whose bucket lies outside [0, m) adds nothing; sign: (c,)
    float32, ±1 (0 on pad rows). Duplicate columns within a row and across
    the rows of one bucket add up. ``out``: an (m, d1) float32 buffer with
    contiguous rows to add into in place (the fold's accumulator), instead
    of a new zeroed one; returned either way.

    On the card each bucket's row of the output is one warp's (after
    :func:`countsketch_prepare`): the contributions to an entry add in
    (row, slot) order, so the result has the bits of the plain version run
    on the CPU, run after run.
    """
    m, d1 = int(m), int(d1)
    operands = (idx, val, bucket, sign) if out is None else (idx, val, bucket, sign, out)
    if all(t.device.type == "cpu" for t in operands):
        return countsketch_scatter_ref(idx, val, bucket, sign, m, d1, out=out)
    name = "countsketch_scatter"
    device = _cuda_operands(name, operands)
    _countsketch_check(name, idx, val, bucket, sign, m, d1)
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if val.dtype != torch.float32 or sign.dtype != torch.float32:
        raise TypeError(f"{name}: val and sign must be float32, got {val.dtype}, {sign.dtype}")
    if bucket.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: bucket must be int32 or int64, got {bucket.dtype}")
    _check_rows(name, idx, "idx")
    _check_rows(name, val, "val")
    out = _countsketch_out(name, out, m, d1, device)
    c, s = idx.shape
    if m == 0 or d1 == 0 or c == 0 or s == 0:
        return out
    order, starts = countsketch_prepare(bucket, m)
    return countsketch_rows(idx, val, sign, order, starts, out)


def countsketch_rows(idx, val, sign, order, starts, out):
    """The CountSketch kernel alone, on prepared indices: ``out`` (m, d1)
    += the chunk's sketch, with (order, starts) from
    :func:`countsketch_prepare` (or :func:`countsketch_order`) for the same
    buckets. Operands as :func:`countsketch_scatter` checks them; m, s and
    d1 > 0. Counts one launch."""
    name = "countsketch_scatter"
    m, d1 = out.shape
    signk = sign.contiguous()
    fn = _lib(name).kt_countsketch_scatter
    device = out.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(
            idx.data_ptr(), val.data_ptr(), signk.data_ptr(), order.data_ptr(),
            starts.data_ptr(), out.data_ptr(), m, idx.shape[1], d1, idx.stride(0),
            val.stride(0), out.stride(0), stream,
        )
    _check_launch(name, err)
    return out


# ---------------------------------------------------------------------------
# Row-stable product: X @ W with each row's bits independent of the row count
# ---------------------------------------------------------------------------

# The reduction chunk of row_stable_matmul (csrc/row_stable_matmul.cu's KC):
# fixed, so a sum's order depends on k alone.
ROW_STABLE_CHUNK = 256
# Scratch the kernel's chunk sums may take (floats): rows run in panels
# whose chunk sums fit in it (a schedule; it moves no bit).
_ROW_STABLE_SCRATCH = 1 << 25
# Elements of the plain version's per-chunk running sums at a time.
_ROW_STABLE_REF_BLOCK = {"cpu": 1 << 22, "cuda": 1 << 26}


def row_stable_matmul_ref(X, W):
    """Plain version of :func:`row_stable_matmul`, summed in the kernel's
    chunks of :data:`ROW_STABLE_CHUNK` reduction indices (one chunk of k
    when k is smaller), the chunk sums added in chunk order, so a row's
    bits depend on that row and W alone, whatever the row count, the row's
    position or the number of threads (an MKL or cuBLAS product sums in an
    order it picks by the shape). For float32 CPU tensors each chunk is one
    fused multiply-add chain in index order, as the kernel sums it, in C++
    (``native.matmul_fma_chain_f32``: the elementwise form is memory-bound
    on a CPU); elsewhere (the card, float64) :func:`_row_stable_matmul_elementwise`,
    whose pairwise trees part from the kernel's chains by rounding: about
    1e-7 of the sums' scale."""
    m, k = X.shape
    n = W.shape[1]
    if W.shape[0] != k:
        raise ValueError(f"row_stable_matmul: X {tuple(X.shape)} and W {tuple(W.shape)} "
                         "do not match X @ W")
    if X.dtype != W.dtype or not X.dtype.is_floating_point:
        raise TypeError(f"row_stable_matmul: operands must share one floating dtype, "
                        f"got {X.dtype} and {W.dtype}")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=X.dtype, device=X.device)
    if X.device.type == "cpu" and X.dtype == torch.float32 and not _meta_operands(
            "row_stable_matmul_ref", (X, W)):
        from keystone_tpu_torch import native

        return native.matmul_fma_chain_f32(_unit_rows(X), _unit_rows(W), ROW_STABLE_CHUNK,
                                           torch.get_num_threads())
    return _row_stable_matmul_elementwise(X, W)


def _row_stable_matmul_elementwise(X, W):
    """The elementwise form of :func:`row_stable_matmul_ref`: in each chunk
    the products (the chunk padded with zeros to a power of two) are summed
    by a fixed pairwise tree, then the chunk sums are added in chunk order.
    Every operation is elementwise and rounded on its own, so a row's bits
    depend on that row and W alone on any device."""
    m, k = X.shape
    n = W.shape[1]
    out = torch.zeros((m, n), dtype=X.dtype, device=X.device)
    if m == 0 or n == 0 or k == 0:
        return out
    kc = min(ROW_STABLE_CHUNK, k)
    chunks = -(-k // kc)
    width = 1 << (kc - 1).bit_length()
    Wp = W.new_zeros((chunks, width, n))
    Wp[:, :kc].view(chunks * kc, n)[:k] = W
    rows = max(1, _ROW_STABLE_REF_BLOCK.get(X.device.type, 1 << 22) // (chunks * width * n))
    for r0 in range(0, m, rows):
        Xb = X[r0:r0 + rows]
        Xp = Xb.new_zeros((Xb.shape[0], chunks, width))
        Xp[:, :, :kc].reshape(Xb.shape[0], chunks * kc)[:, :k] = Xb
        P = Xp[:, :, :, None] * Wp[None]
        while P.shape[2] > 1:
            half = P.shape[2] // 2
            P = P[:, :, :half] + P[:, :, half:]
        s = P[:, 0, 0]
        for c in range(1, chunks):
            s = s + P[:, c, 0]
        out[r0:r0 + rows] = s
    return out


def _row_stable_panel_rows(m: int, n: int, k: int) -> int:
    """Rows a panel of :func:`row_stable_matmul`: all of them, or as many
    whole 128-row tiles as keep the chunk sums inside the scratch."""
    chunks = -(-k // ROW_STABLE_CHUNK)
    if chunks == 1:
        return m
    return min(m, max(128, _ROW_STABLE_SCRATCH // (chunks * n) // 128 * 128))


def row_stable_matmul_grid(m: int, n: int, k: int, device) -> Dict[str, float]:
    """The grid :func:`row_stable_matmul` launches for an (m, k) @ (k, n)
    product on ``device`` (a card): its tile rows and columns, chunks,
    panels, blocks a panel, the kernel's resident blocks an SM, registers
    and local (spilled) bytes a thread, and a panel's waves."""
    device = torch.device(device)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _lib("row_stable_matmul").kt_row_stable_matmul_config(m, n, out)
    _check_launch("row_stable_matmul", err)
    tm, tn, bps, regs, local = tuple(out)
    panel = _row_stable_panel_rows(m, n, k)
    chunks = -(-k // ROW_STABLE_CHUNK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _grid(dict(tile_rows=tm, tile_cols=tn, chunks=chunks, panel_rows=panel,
                      panels=-(-m // panel), blocks=-(-panel // tm) * -(-n // tn) * chunks,
                      blocks_per_sm=bps, registers=regs, local_bytes=local), sms)


def row_stable_matmul(X, W):
    """``X @ W`` whose row i has the same bits however many rows share the
    call (``csrc/row_stable_matmul.cu``; no TPU twin: ROADMAP C.8's
    repair). X: (m, k), W: (k, n), both float32 on the card (any one
    floating dtype on the CPU, through :func:`row_stable_matmul_ref`); X
    with non-contiguous rows is copied. Returns a new (m, n) tensor. A
    meta operand (the plan verifier's shape inference) gets an empty meta
    output, and nothing is launched or counted. Counts one launch a call
    (its chunk-sum pass included)."""
    name = "row_stable_matmul"
    meta = _meta_operands(name, (X, W))
    if not meta and X.device.type == "cpu" and W.device.type == "cpu":
        return row_stable_matmul_ref(X, W)
    device = _META if meta else _cuda_operands(name, (X, W))
    if X.dim() != 2 or W.dim() != 2 or X.shape[1] != W.shape[0]:
        raise ValueError(f"{name}: X {tuple(X.shape)} and W {tuple(W.shape)} do not "
                         "match X @ W")
    if X.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 operands, got {X.dtype} and "
                        f"{W.dtype}")
    m, k = X.shape
    n = W.shape[1]
    if meta:
        return torch.empty((m, n), dtype=torch.float32, device=_META)
    Xk = X if X.stride(1) == 1 or k <= 1 else X.contiguous()
    Wk = W if W.stride(1) == 1 or n <= 1 else W.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    panel = _row_stable_panel_rows(m, n, k)
    chunks = -(-k // ROW_STABLE_CHUNK)
    P = torch.empty(chunks * panel * n if chunks > 1 else 0, dtype=torch.float32,
                    device=device)
    fn = _lib(name).kt_row_stable_matmul
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launches(name)
        err = fn(
            Xk.data_ptr(), Wk.data_ptr(), P.data_ptr() if chunks > 1 else None,
            out.data_ptr(), m, n, k, Xk.stride(0), Wk.stride(0), out.stride(0), panel,
            stream,
        )
    _check_launch(name, err)
    return out
