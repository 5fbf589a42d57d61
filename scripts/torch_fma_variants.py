"""The pipelined FP32-FMA kernels' tuning constants, measured on one GPU.

    python3 scripts/torch_fma_variants.py [--out build/torch_fma_variants.json]
                                          [--kernels NAME ...]
    python3 scripts/torch_fma_variants.py --root DIR [DIR ...] [--out FILE]

Builds variants of the kernels on ``keystone_tpu_torch/csrc/fma_pipe.cuh``
(``block_corr.cu``, ``gram_corr.cu``, which also holds ``block_gram_sym``'s
Gramian-only launch and ``gram_sym_acc``'s accumulating one,
``gram_corr_sym_acc.cu``'s float32 form, both on the Gramian kernel of
``gram_tile.cuh``, ``block_residual_update.cu``,
``gaussian_kernel_block.cu``, ``gaussian_resid_block.cu``,
``cosine_features.cu``, ``conv_featurize.cu``) that differ from them in one
constant (or two) each,
of the kernel's source or of a header: ``STAGES``, the ring's depth;
``BK``, the reduction steps a stage (of the Gramian in ``gram_corr``,
``block_gram_sym``, ``gram_sym_acc`` and ``gram_corr_sym_acc``); the
order of the Gramians' upper tiles (row-major, or grouped
column by column in 8 tile rows);
``KT_WIDE``, the label tile of k > 32 (128 takes k = 147 in two tiles, the
second masked past column 19); ``MINB``, the blocks an SM the registers are
capped for; ``CORR_MI``, the columns of A a thread of a ``gram_corr``
correlation block, x 16 a block; ``NJ``, the output columns a thread of
``gaussian_kernel_block`` (16: 128 x 256 tiles, at one block an SM; the
wider tile's block counts are printed as if it were 128 wide); the order of
``gaussian_kernel_block``'s grid (column tiles first); whether
``gaussian_resid_block`` keeps a row chunk's partial in registers across
its row tiles at k <= 16 or adds each tile's share into it in device
memory (its k > 16 form), ``KT``, the label columns of its contraction
pass, and the width of its row-tile counters; ``conv_featurize``'s filter
tile at k = 100 (112 or 128 wide), its patch stages (one, relying on two
resident blocks to overlap the gather with the product, or two, the next
tile's gather in flight during the product at one block an SM) and its
stores (16-byte or element by element). Each variant is built in a directory of its own under
``build/keystone_tpu_torch/variants/`` (beside copies of the headers, edited
where the variant edits them), one ``nvcc`` each, all started together. Then, at the
main path's shapes (``chip_smoke.py``'s: ``block_corr``,
``block_gram_sym`` and ``block_residual_update`` at the TIMIT window, F
65,536 x 16,384 float32, columns [8192, 12288), R 65,536 x 147, dW 4,096 x
147; ``gram_corr``: A
65,536 x 4,096, R 65,536 x 147; ``gram_sym_acc`` at the streamed fit's
tile, F 32,768 x 16,384; ``gram_corr_sym_acc`` at the Amazon chunk, F
65,536 x 16,385 at the fold's row stride of 16,388 (as built also at
16,385, and ``gram_sym_acc``'s Gramian alone on it), R 65,536 x 2; ``gaussian_kernel_block`` at the CIFAR
route's four shapes, ``chip_smoke.cifar_gaussian_shapes``;
``gaussian_resid_block`` at the CIFAR sweep, X 50,000 x 1,800, a 512-row
block and the ragged 336-row one, W 50,000 x 10; ``cosine_features`` at
one TIMIT branch, X 65,536 x 440, W 4,096 x 440, into its column window of
the 16,384-wide fused feature matrix; ``conv_featurize`` at one row chunk of
the CIFAR featurization, 2,382 images of 32 x 32 x 3, 100 filters of
6 x 6 x 3 and whitening means), it holds each variant against the
plain version (the error relative to the sums' scale, as ``chip_smoke.py``
does; absolute for the Gaussian and cosine kernels, whose entries lie in
[0, 1] and [-1, 1]; a ``gram_corr`` variant's outputs also against
``gram_corr_sym``'s bits, a ``block_gram_sym``, ``gaussian_resid_block``
or ``cosine_features`` variant's against the as-built variant's) and times
it with CUDA events, beside the library yardstick (``Fw.T @ R``; ``A.T @
A`` and ``A.T @ R``; ``Fw.T @ Fw``; ``addmm(R, Fw, dW, alpha=-1)``;
``exp(addmm(...))``
and its product with W; ``cos(addmm(b, X, W.T))``; for the convolution the
product alone on cuBLAS, ``matmul`` of the normalised patch matrix made
before timing by the filters). ``block_corr`` is also
timed as built at other row-chunk counts than the one
``cuda_ops.corr_splits`` picks, and ``gaussian_kernel_block`` at other
feature-chunk counts than ``cuda_ops.gaussian_splits`` picks.

With ``--root DIR [DIR ...]`` it builds no variants: it loads the
``cuda_ops`` module of each checkout under a name of its own and times
their ``gram_sym_acc`` (the streamed tile, f32 and bf16 F, in place),
``gram_corr_sym_acc`` (the Amazon chunk: f32 F at row strides 16,388 and
16,385, its ragged last chunk, bf16 F; in place), ``gram_corr_sym`` (A
65,536 x 4,096, R 65,536 x 147, f32 and bf16 A), ``block_gram_sym`` (the
TIMIT window, f32 and bf16 F), ``block_residual_update`` (f32 and bf16
F), ``gaussian_kernel_block`` (each CIFAR shape), ``gaussian_resid_block``
(both sweep blocks, f32 and bf16 operands), ``cosine_features`` (f32, bf16 operands, bf16 output,
and f32 into the fused matrix's window) and ``conv_featurize`` (the CIFAR
row chunk and the one-image first chunk, each checkout's
``cuda_images`` bound to its own ``cuda_ops``) through their wrappers, in turns
in one process on one card (first to last checkout and back: parent,
change, change, parent for two), a call with CUDA events (``ms``: the
host's time to launch included, which decides a short call) and the
calls queued back to back on the card (``chip_smoke.device_ms``), each held
against its plain version, beside its library yardstick, and against the
first checkout's output on the same inputs (``bits_of_first_root``,
``max_diff_from_first_root``). Each checkout builds its kernels into its
own ``build/`` directory; a parent commit unpacked under ``build/`` is
compared with this one in one call. ``--kernels`` picks the wrappers
timed (default: all).

Prints one line a variant (or shape, a turn) and writes the numbers, with
the card's name and power limit, as JSON to ``--out``. Needs a CUDA device;
exits non-zero without one.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from chip_smoke import (  # noqa: E402  (the shapes and timers chip_smoke.py uses)
    AMAZON_CHUNK, AMAZON_D, AMAZON_K, AMAZON_RAGGED, BLOCK, CIFAR_BLOCK, CIFAR_BLOCKS, CIFAR_D,
    CIFAR_GAMMA, CIFAR_K, CIFAR_N, CIFAR_TEST, COL_START, D_FEAT, D_IN, K, N_TRAIN as N,
    CIFAR_FILTERS, STREAM_TILE, _conv_chunk_rows, cifar_gaussian_shapes, device_ms, f32_slab,
    time_ms, tma_slab)


HEADER = "fma_pipe.cuh"
GRAM = "gram_tile.cuh"
# The Gramian's tile order: upper tiles row-major (as built), or in groups of
# GH tile rows and, inside a group, column by column (the bf16
# gram_corr_sym_acc kernel's order), so the blocks of a wave share more of
# F's columns.
ROW_MAJOR_TILES = """  int ti = 0;
  int rem = p;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;"""
GROUPED_TILES = """  constexpr int GH = 8;
  int g0 = 0;
  for (;;) {
    const int h = min(GH, nt - g0);
    const int count = h * (h + 1) / 2 + h * (nt - g0 - h);
    if (p < count) break;
    p -= count;
    g0 += GH;
  }
  const int h = min(GH, nt - g0);
  const int tri = h * (h + 1) / 2;
  int ti, tj;
  if (p < tri) {
    int c = 0;
    while (p > c) {
      p -= c + 1;
      ++c;
    }
    tj = g0 + c;
    ti = g0 + p;
  } else {
    p -= tri;
    tj = g0 + h + p / h;
    ti = g0 + p % h;
  }"""
# The 16-byte copies of a row-major Gramian operand: as built, whole chunks
# where d is whole chunks and the partial-last-chunk instance (PART, a byte
# count held a thread) where it is not; the partial instance at every width;
# or whole chunks at every width, which at a ragged d reads up to 12 bytes of
# the rows' pad (right only where the rows are padded, as the fold's are).
WHOLE_OR_PART = "return d % vec_elems<TA>() == 0 ? fn(T{}, F{}) : fn(T{}, T{});"
COPY_VARIANTS = [
    ("16-byte copies in part at every width", ((GRAM, WHOLE_OR_PART, "return fn(T{}, T{});"),)),
    ("whole 16-byte chunks at every width (reads the rows' pad)",
     ((GRAM, WHOLE_OR_PART, "return fn(T{}, F{});"),)),
]
# The ring variants of the accumulating Gramians (gram_tile.cuh's constants).
ACC_VARIANTS = [
    ("as built", ()),
    ("STAGES 2", ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("STAGES 4", ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("BK 16", ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 16;"),)),
    ("BK 16, STAGES 4", ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 16;"),
                         (GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"))),
    ("grouped tile order (GH 8)", ((GRAM, ROW_MAJOR_TILES, GROUPED_TILES),)),
    *COPY_VARIANTS,
]
# (kernel, name, edits): each edit (file, the line, its replacement), the
# file "" for the kernel's own source; "as built" has none.
VARIANTS = [
    ("block_corr", "as built", ()),
    ("block_corr", "STAGES 3", (("", "constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),)),
    ("block_corr", "STAGES 4", (("", "constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),)),
    ("block_corr", "BK 8", (("", "constexpr int BK = 16;", "constexpr int BK = 8;"),)),
    ("block_corr", "BK 32", (("", "constexpr int BK = 16;", "constexpr int BK = 32;"),)),
    ("block_corr", "KT_WIDE 128",
     ((HEADER, "constexpr int KT_WIDE = 160;", "constexpr int KT_WIDE = 128;"),)),
    ("block_corr", "MINB 1", (("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),)),
    ("gram_corr", "as built", ()),
    ("gram_corr", "STAGES 2", ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("gram_corr", "STAGES 4", ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("gram_corr", "BK 8", ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 8;"),)),
    ("gram_corr", "BK 16", ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 16;"),)),
    ("gram_corr", "CORR_MI 2",
     ((GRAM, "constexpr int CORR_MI = 4;", "constexpr int CORR_MI = 2;"),)),
    ("gram_corr", "CORR_MI 8",
     ((GRAM, "constexpr int CORR_MI = 4;", "constexpr int CORR_MI = 8;"),)),
    ("block_gram_sym", "as built", ()),
    ("block_gram_sym", "STAGES 2",
     ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("block_gram_sym", "STAGES 4",
     ((GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("block_gram_sym", "BK 16", ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 16;"),)),
    ("block_gram_sym", "BK 16, STAGES 4",
     ((GRAM, "constexpr int BK = 32;", "constexpr int BK = 16;"),
      (GRAM, "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"))),
    ("gram_corr", "grouped tile order (GH 8)", ((GRAM, ROW_MAJOR_TILES, GROUPED_TILES),)),
    ("block_gram_sym", "grouped tile order (GH 8)",
     ((GRAM, ROW_MAJOR_TILES, GROUPED_TILES),)),
    *[("gram_corr", name, edits) for name, edits in COPY_VARIANTS[:1]],
    *[("block_gram_sym", name, edits) for name, edits in COPY_VARIANTS[:1]],
    ("block_residual_update", "as built", ()),
    ("block_residual_update", "STAGES 3",
     (("", "constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),)),
    ("block_residual_update", "STAGES 4",
     (("", "constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),)),
    ("block_residual_update", "BK 8", (("", "constexpr int BK = 16;", "constexpr int BK = 8;"),)),
    ("block_residual_update", "BK 32",
     (("", "constexpr int BK = 16;", "constexpr int BK = 32;"),)),
    ("block_residual_update", "KT_WIDE 128",
     ((HEADER, "constexpr int KT_WIDE = 160;", "constexpr int KT_WIDE = 128;"),)),
    ("block_residual_update", "MINB 1",
     (("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),)),
    ("gaussian_kernel_block", "as built", ()),
    ("gaussian_kernel_block", "STAGES 2",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("gaussian_kernel_block", "STAGES 4",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("gaussian_kernel_block", "BK 16", (("", "constexpr int BK = 8;", "constexpr int BK = 16;"),)),
    ("gaussian_kernel_block", "BK 32", (("", "constexpr int BK = 8;", "constexpr int BK = 32;"),)),
    ("gaussian_kernel_block", "MINB 1",
     (("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),)),
    ("gaussian_kernel_block", "NJ 16 (128 x 256 tiles), MINB 1, BK 16",
     (("", "constexpr int NJ = 8; ", "constexpr int NJ = 16;"),
      ("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),
      ("", "constexpr int BK = 8;", "constexpr int BK = 16;"))),
    ("gaussian_kernel_block", "column tiles first",
     (("", "const long long i0 = (long long)blockIdx.x * TM;",
       "const long long i0 = (long long)blockIdx.y * TM;"),
      ("", "const long long j0 = (long long)blockIdx.y * TN;",
       "const long long j0 = (long long)blockIdx.x * TN;"),
      ("", "const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);",
       "const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM, splits);"))),
    ("gaussian_resid_block", "as built", ()),
    ("gaussian_resid_block", "partial through device memory (the k > 16 form)",
     (("", "return k <= KT ? resid_kernel<TIn, VEC, true>",
       "return k < 0 ? resid_kernel<TIn, VEC, true>"),)),
    ("gaussian_resid_block", "STAGES 2",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("gaussian_resid_block", "STAGES 4",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("gaussian_resid_block", "BK 16", (("", "constexpr int BK = 8;", "constexpr int BK = 16;"),)),
    ("gaussian_resid_block", "MINB 1",
     (("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),)),
    ("gaussian_resid_block", "32-wide label passes",
     (("", "constexpr int KT = 16;", "constexpr int KT = 32;"),)),
    ("gaussian_resid_block", "64-bit row-tile counters",
     (("", """  const int tiles = (m + TM - 1) / TM;
  const int t0 = static_cast<int>((long long)blockIdx.y * tiles / splits);
  const int t1 = static_cast<int>(((long long)blockIdx.y + 1) * tiles / splits);""",
       """  const long long tiles = ((long long)m + TM - 1) / TM;
  const long long t0 = blockIdx.y * tiles / splits;
  const long long t1 = (blockIdx.y + 1) * tiles / splits;"""),
      ("", "  for (int t = t0; t < t1; ++t) {", "  for (long long t = t0; t < t1; ++t) {"))),
    ("cosine_features", "as built", ()),
    ("cosine_features", "STAGES 2",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),)),
    ("cosine_features", "STAGES 4",
     (("", "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),)),
    ("cosine_features", "BK 8, STAGES 2",
     (("", "constexpr int BK = 16;", "constexpr int BK = 8;"),
      ("", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"))),
    ("cosine_features", "BK 8", (("", "constexpr int BK = 16;", "constexpr int BK = 8;"),)),
    ("cosine_features", "BK 8, STAGES 4",
     (("", "constexpr int BK = 16;", "constexpr int BK = 8;"),
      ("", "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"))),
    ("cosine_features", "MINB 1",
     (("", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),)),
    *[("gram_sym_acc", name, edits) for name, edits in ACC_VARIANTS],
    *[("gram_corr_sym_acc", name, edits) for name, edits in ACC_VARIANTS],
    ("conv_featurize", "as built", ()),
    ("conv_featurize", "filter tile 128",
     (("", "constexpr int FT_MID = 112;", "constexpr int FT_MID = 128;"),)),
    ("conv_featurize", "two patch stages",
     (("", "constexpr int BUFS = 1;", "constexpr int BUFS = 2;"),)),
    ("conv_featurize", "element stores",
     (("", "constexpr bool VEC_STORES = true;", "constexpr bool VEC_STORES = false;"),)),
    ("conv_featurize", "filter tile 128, element stores",
     (("", "constexpr int FT_MID = 112;", "constexpr int FT_MID = 128;"),
      ("", "constexpr bool VEC_STORES = true;", "constexpr bool VEC_STORES = false;"))),
    *[("conv_featurize", f"KSTEP {step}",
       (("", "constexpr int KSTEP = 36;", f"constexpr int KSTEP = {step};"),))
      for step in (4, 12, 18, 54, 108)],
    ("conv_featurize", "gather by plain loads",
     (("", "cp_async4(S + e * TM + pix, src + off[e], live);",
       "S[e * TM + pix] = live ? __ldg(src + off[e]) : 0.f;"),)),
    ("conv_featurize", "reciprocal scaling (other bits)",
     (("", "const float sd = sd_s[pix];", "const float sd = 1.0f / sd_s[pix];"),
      ("", "(S[e * TM + pix] - mean) / sd - mu[e]", "(S[e * TM + pix] - mean) * sd - mu[e]"))),
    # What the product and the stores alone take: no gather, statistics or
    # normalisation (the stage keeps whatever it holds; wrong outputs).
    ("conv_featurize", "product and stores alone (diagnostic)",
     (("", "    for (int e = e0; e < d; e += EPT) cp_async4(S + e * TM + pix, src + off[e], live);\n",
       ""),
      ("", "if (normalize && threadIdx.x < TM) {", "if (false) {"),
      ("", "    if (normalize) {\n      const float mean", "    if (false) {\n      const float mean"),
      ("", "      for (int e = e0; e < d; e += EPT) S[e * TM + pix] = S[e * TM + pix] - mu[e];\n",
       ""))),
]


def build(cuda_ops, kernels):
    """Compile every variant of ``kernels``; returns (kernel, name) -> the
    loaded library."""
    out_dir = cuda_ops._BUILD / "variants"
    procs = {}
    for i, (kernel, name, edits) in enumerate(VARIANTS):
        if kernel not in kernels:
            continue
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        source = cuda_ops._source(kernel)
        # The source and every header, edited or not, side by side: a quoted
        # #include looks in the including file's own directory first, so a
        # header that includes another (gram_tile.cuh, fma_pipe.cuh) finds the
        # variant's copy.
        texts = {"": (cuda_ops._CSRC / f"{source}.cu").read_text(),
                 **{h.name: h.read_text() for h in cuda_ops._CSRC.glob("*.cuh")}}
        for file, old, new in edits:
            if old not in texts[file]:
                raise RuntimeError(f"{kernel} {name}: {old!r} is not in {file or kernel}")
            texts[file] = texts[file].replace(old, new)
        for file, text in texts.items():
            (vdir / (file or f"{source}.cu")).write_text(text)
        cmd = [cuda_ops._nvcc(), *cuda_ops._NVCC_FLAGS, "-o", str(vdir / f"lib{source}.so"),
               str(vdir / f"{source}.cu")]
        procs[kernel, name] = (vdir, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (vdir, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(str(vdir / f"lib{cuda_ops._source(kernel)}.so"))
        for symbol, argtypes in cuda_ops._symbols(cuda_ops._source(kernel)).items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
        libs[kernel, name] = lib
    return libs


def block_corr_rows(cuda_ops, libs, stream, sms):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.randn((N, D_FEAT), generator=gen, device=dev)
    R = torch.randn((N, K), generator=gen, device=dev)
    Fw = F[:, COL_START:COL_START + BLOCK]
    want = cuda_ops.block_corr_ref(F, COL_START, BLOCK, R)
    scale = (Fw.abs().T @ R.abs()).max().item()
    flops = 2 * N * BLOCK * K
    rows = {}

    def run(lib, splits, name, chosen):
        P = torch.empty((splits, BLOCK, K), device=dev)
        C = torch.empty((BLOCK, K), device=dev)

        def call():
            err = lib.kt_block_corr(F.data_ptr(), R.data_ptr(), P.data_ptr(), C.data_ptr(), N,
                                    COL_START, BLOCK, K, F.stride(0), R.stride(0), splits, 0,
                                    stream)
            if err:
                raise RuntimeError(f"block_corr {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        rows[name] = dict(splits=splits, rel_err=(C - want).abs().max().item() / scale,
                          ms=time_ms(call, 10), **chosen)

    for (kernel, name), lib in libs.items():
        if kernel != "block_corr":
            continue
        cfg = (ctypes.c_int * 4)()
        lib.kt_block_corr_config(K, 0, cfg)
        ktile, bps, regs, local = cfg
        tiles = (BLOCK // 128) * -(-K // ktile)
        splits = cuda_ops.corr_splits(N, tiles, sms, bps)
        chosen = dict(ktile=ktile, blocks_per_sm=bps, registers=regs, local_bytes=local,
                      blocks=tiles * splits, waves=tiles * splits / (sms * bps))
        run(lib, splits, name, chosen)
        if name == "as built":
            for other in sorted({max(1, splits // 2), 2 * splits, 4 * splits}):
                run(lib, other, f"as built, {other} chunks",
                    dict(chosen, blocks=tiles * other, waves=tiles * other / (sms * bps)))
    rows["library: Fw.T @ R"] = dict(rel_err=((Fw.T @ R) - want).abs().max().item() / scale,
                                     ms=time_ms(lambda: Fw.T @ R, 10))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del F, R, Fw
    torch.cuda.empty_cache()
    return rows


def gram_corr_rows(cuda_ops, libs, stream):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn((N, BLOCK), generator=gen, device=dev)
    R = torch.randn((N, K), generator=gen, device=dev)
    want_g, want_c = cuda_ops.gram_corr_ref(A, R)
    sym_g, sym_c = cuda_ops.gram_corr_sym(A, R)
    g_scale = want_g.diagonal().max().item()
    c_scale = (A.abs().T @ R.abs()).max().item()
    flops = N * BLOCK * (BLOCK + 1) + 2 * N * BLOCK * K
    rows = {}
    for (kernel, name), lib in libs.items():
        if kernel != "gram_corr":
            continue
        G = torch.empty((BLOCK, BLOCK), device=dev)
        C = torch.empty((BLOCK, K), device=dev)

        def call():
            err = lib.kt_gram_corr(A.data_ptr(), R.data_ptr(), G.data_ptr(), C.data_ptr(), N,
                                   BLOCK, K, A.stride(0), R.stride(0), 0, stream)
            if err:
                raise RuntimeError(f"gram_corr {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        cfg = (ctypes.c_int * 9)()
        lib.kt_gram_corr_config(A.data_ptr(), BLOCK, K, A.stride(0), 0, cfg)
        rows[name] = dict(
            gram_rel_err=(G - want_g).abs().max().item() / g_scale,
            corr_rel_err=(C - want_c).abs().max().item() / c_scale,
            bits_of_gram_corr_sym=bool(torch.equal(G, sym_g) and torch.equal(C, sym_c)),
            gram_blocks=cfg[0], corr_blocks=cfg[1], corr_cols=cfg[7], blocks_per_sm=cfg[3],
            registers=cfg[4], local_bytes=cfg[5], ms=time_ms(call, 3))
    rows["library: A.T @ A, A.T @ R"] = dict(
        gram_rel_err=((A.T @ A) - want_g).abs().max().item() / g_scale,
        ms=time_ms(lambda: (A.T @ A, A.T @ R), 3))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del A, R
    torch.cuda.empty_cache()
    return rows


def block_gram_sym_rows(cuda_ops, libs, stream):
    """Each Gramian-only ring variant of block_gram_sym at the TIMIT
    window, held against the plain version and the as-built variant's bits
    (every variant keeps each entry's fmaf chain)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    F = torch.randn((N, D_FEAT), generator=gen, device=dev)
    Fw = F[:, COL_START:COL_START + BLOCK]
    want = cuda_ops.block_gram_sym_ref(F, COL_START, BLOCK)
    scale = want.diagonal().max().item()
    flops = N * BLOCK * (BLOCK + 1)
    rows, built = {}, None
    for (kernel, name), lib in libs.items():
        if kernel != "block_gram_sym":
            continue
        G = torch.empty((BLOCK, BLOCK), device=dev)

        def call():
            err = lib.kt_block_gram_sym(F.data_ptr(), G.data_ptr(), N, COL_START, BLOCK,
                                        F.stride(0), 0, stream)
            if err:
                raise RuntimeError(f"block_gram_sym {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        if name == "as built":
            built = G.clone()
        cfg = (ctypes.c_int * 6)()
        lib.kt_block_gram_sym_config(F.data_ptr(), COL_START, BLOCK, F.stride(0), 0, cfg)
        blocks, vec, bps, regs, local, _ = cfg
        rows[name] = dict(rel_err=(G - want).abs().max().item() / scale,
                          bits_of_as_built=bool(torch.equal(G, built)), blocks=blocks,
                          vec=bool(vec), blocks_per_sm=bps, registers=regs, local_bytes=local,
                          ms=time_ms(call, 5))
    rows["library: Fw.T @ Fw"] = dict(
        rel_err=((Fw.T @ Fw) - want).abs().max().item() / scale,
        ms=time_ms(lambda: Fw.T @ Fw, 5))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del F, Fw, want, built
    torch.cuda.empty_cache()
    return rows


def _upper(d, device):
    """The upper-triangle 128 x 128 tiles of a (d, d) Gramian."""
    tiles = torch.arange(d, device=device) // 128
    return tiles[:, None] <= tiles[None, :]


def gram_sym_acc_rows(cuda_ops, libs, stream):
    """Each ring or tile-order variant of gram_sym_acc at the streamed fit's
    tile (F 32,768 x 16,384 float32, a random G0, into a new buffer), held
    against the plain version (relative to the sums' scale, upper tiles) and
    the as-built variant's bits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d = STREAM_TILE, D_FEAT
    F = torch.randn((n, d), generator=gen, device=dev)
    G0 = torch.randn((d, d), generator=gen, device=dev)
    upper = _upper(d, dev)
    want = cuda_ops.gram_sym_acc_ref(G0, F)
    scale = torch.addmm(G0.abs(), F.abs().T, F.abs())
    flops = n * d * (d + 1)
    rows, built = {}, None
    for (kernel, name), lib in libs.items():
        if kernel != "gram_sym_acc":
            continue
        out = torch.empty((d, d), device=dev)

        def call():
            err = lib.kt_gram_sym_acc(F.data_ptr(), G0.data_ptr(), out.data_ptr(), n, d,
                                      F.stride(0), d, d, 0, stream)
            if err:
                raise RuntimeError(f"gram_sym_acc {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        got = out[upper]
        if name == "as built":
            built = got
        cfg = (ctypes.c_int * 6)()
        lib.kt_gram_sym_acc_config(F.data_ptr(), d, F.stride(0), 0, cfg)
        blocks, vec, bps, regs, local, sms = cfg
        rows[name] = dict(rel_err=((out - want).abs() / scale)[upper].max().item(),
                          bits_of_as_built=bool(torch.equal(got, built)), blocks=blocks,
                          vec=bool(vec), blocks_per_sm=bps, waves=blocks / (sms * bps),
                          registers=regs, local_bytes=local, ms=time_ms(call, 3))
        del out, got
    rows["library: addmm(G0, F.T, F)"] = dict(ms=time_ms(lambda: torch.addmm(G0, F.T, F), 3))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del F, G0, upper, want, scale, built
    torch.cuda.empty_cache()
    return rows


def gram_corr_sym_acc_rows(cuda_ops, libs, stream):
    """Each ring or tile-order variant of the float32 gram_corr_sym_acc at the
    Amazon chunk (F 65,536 x 16,385 at the fold's row stride of 16,388, R
    65,536 x 2, a random G0 and C0, into new buffers), held against the
    plain version and the as-built variant's bits; as built also at row
    stride 16,385 (element-wise copies), and gram_sym_acc's Gramian alone
    on the same F (the correlation blocks' cost is the difference)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    c, d1, k = AMAZON_CHUNK, AMAZON_D + 1, AMAZON_K
    F = f32_slab(torch.randn((c, d1), generator=gen, device=dev))
    R = torch.randn((c, k), generator=gen, device=dev)
    G0 = torch.randn((d1, d1), generator=gen, device=dev)
    C0 = torch.randn((d1, k), generator=gen, device=dev)
    upper = _upper(d1, dev)
    want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G0, C0, F, R)
    g_scale = torch.addmm(G0.abs(), F.abs().T, F.abs())
    c_scale = torch.addmm(C0.abs(), F.abs().T, R.abs())
    flops = c * d1 * (d1 + 1) + 2 * c * d1 * k
    rows, built = {}, None
    gout = torch.empty((d1, d1), device=dev)
    cout = torch.empty((d1, k), device=dev)

    def run(lib, name, Fk):
        nonlocal built

        def call():
            err = lib.kt_gram_corr_sym_acc(
                Fk.data_ptr(), R.data_ptr(), G0.data_ptr(), C0.data_ptr(), gout.data_ptr(),
                cout.data_ptr(), c, d1, k, Fk.stride(0), R.stride(0), d1, k, d1, k, 0, stream)
            if err:
                raise RuntimeError(f"gram_corr_sym_acc {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        got = torch.cat([gout[upper], cout.flatten()])
        built = got if built is None else built
        cfg = (ctypes.c_int * 9)()
        lib.kt_gram_corr_sym_acc_config(Fk.data_ptr(), d1, k, Fk.stride(0), cfg)
        gram, corr, ktile, bps, regs, local, sms, corr_cols, vec = cfg
        rows[name] = dict(
            gram_rel_err=((gout - want_g).abs() / g_scale)[upper].max().item(),
            corr_rel_err=((cout - want_c).abs() / c_scale).max().item(),
            bits_of_as_built=bool(torch.equal(got, built)), gram_blocks=gram, corr_blocks=corr,
            ktile=ktile, vec=bool(vec), blocks_per_sm=bps, waves=(gram + corr) / (sms * bps),
            registers=regs, local_bytes=local, ms=time_ms(call, 3))

    for (kernel, name), lib in libs.items():
        if kernel != "gram_corr_sym_acc":
            continue
        run(lib, name, F)
        if name == "as built":
            Fu = F.contiguous()
            run(lib, "as built, row stride 16,385 (element-wise copies)", Fu)
            del Fu
    out = torch.empty((d1, d1), device=dev)
    rows["gram_sym_acc on the same F (no correlation)"] = dict(
        ms=time_ms(lambda: cuda_ops.gram_sym_acc(G0, F, out=out), 3))
    rows["library: two addmm"] = dict(
        ms=time_ms(lambda: (torch.addmm(G0, F.T, F), torch.addmm(C0, F.T, R)), 3))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del F, R, G0, C0, upper, want_g, want_c, g_scale, c_scale, gout, cout, out, built
    torch.cuda.empty_cache()
    return rows


def block_residual_rows(cuda_ops, libs, stream, sms):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    F = torch.randn((N, D_FEAT), generator=gen, device=dev)
    R = torch.randn((N, K), generator=gen, device=dev)
    dW = torch.randn((BLOCK, K), generator=gen, device=dev) * 0.01
    Fw = F[:, COL_START:COL_START + BLOCK]
    want = cuda_ops.block_residual_update_ref(F, COL_START, BLOCK, dW, R)
    scale = (R.abs() + Fw.abs() @ dW.abs()).max().item()
    flops = 2 * N * BLOCK * K
    rows = {}
    for (kernel, name), lib in libs.items():
        if kernel != "block_residual_update":
            continue
        out = torch.empty((N, K), device=dev)

        def call():
            err = lib.kt_block_residual_update(
                F.data_ptr(), dW.data_ptr(), R.data_ptr(), out.data_ptr(), N, COL_START, BLOCK,
                K, F.stride(0), dW.stride(0), R.stride(0), out.stride(0), 0, stream)
            if err:
                raise RuntimeError(f"block_residual_update {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        cfg = (ctypes.c_int * 4)()
        lib.kt_block_residual_update_config(K, 0, cfg)
        ktile, bps, regs, local = cfg
        blocks = (N // 128) * -(-K // ktile)
        rows[name] = dict(rel_err=(out - want).abs().max().item() / scale, ktile=ktile,
                          blocks=blocks, blocks_per_sm=bps, waves=blocks / (sms * bps),
                          registers=regs, local_bytes=local, ms=time_ms(call, 10))
    rows["library: addmm(R, Fw, dW, alpha=-1)"] = dict(
        rel_err=(torch.addmm(R, Fw, dW, alpha=-1) - want).abs().max().item() / scale,
        ms=time_ms(lambda: torch.addmm(R, Fw, dW, alpha=-1), 10))
    for r in rows.values():
        r["tflops"] = flops / r["ms"] / 1e9
    del F, R, dW, Fw, want
    torch.cuda.empty_cache()
    return rows


def gaussian_rows(cuda_ops, libs, stream, sms):
    """Each gaussian_kernel_block variant at the CIFAR route's four shapes,
    with the feature chunks gaussian_splits picks for its resident blocks an
    SM; as built also at other chunk counts."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    d, g = CIFAR_D, CIFAR_GAMMA
    X = torch.randn((CIFAR_N, d), generator=gen, device=dev)
    Xt = torch.randn((CIFAR_TEST, d), generator=gen, device=dev)
    xn, xtn = (X * X).sum(1), (Xt * Xt).sum(1)
    shapes = cifar_gaussian_shapes(X, xn, Xt, xtn)
    rows = {}

    def run(lib, label, shape, splits, extra):
        A, B, an, bn, _ = shape
        m, nn = A.shape[0], B.shape[0]
        out = torch.empty((m, nn), device=dev)
        P = torch.empty((splits, m, nn), device=dev) if splits > 1 else None

        def call():
            err = lib.kt_gaussian_kernel_block(
                A.data_ptr(), B.data_ptr(), an.data_ptr(), bn.data_ptr(), out.data_ptr(),
                None if P is None else P.data_ptr(), m, nn, d, A.stride(0), B.stride(0),
                out.stride(0), g, splits, 0, stream)
            if err:
                raise RuntimeError(f"gaussian_kernel_block {label}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        want = cuda_ops.gaussian_kernel_block_ref(A, B, an, bn, g)
        tiles = -(-m // 128) * -(-nn // 128)
        ms = time_ms(call, 10 if m * nn > 1e6 else 50)
        rows[label] = dict(abs_err=(out - want).abs().max().item(), splits=splits,
                           blocks=tiles * splits, ms=ms, tflops=2 * m * nn * d / ms / 1e9,
                           **extra)

    for (kernel, name), lib in libs.items():
        if kernel != "gaussian_kernel_block":
            continue
        cfg = (ctypes.c_int * 3)()
        lib.kt_gaussian_kernel_block_config(0, cfg)
        bps, regs, local = cfg
        for shape_name, shape in shapes.items():
            m, nn = shape[0].shape[0], shape[1].shape[0]
            splits = cuda_ops.gaussian_splits(m, nn, d, sms, bps)
            extra = dict(blocks_per_sm=bps, registers=regs, local_bytes=local)
            run(lib, f"{name}, {shape_name}", shape, splits, extra)
            if name == "as built" and shape_name in ("diagonal", "test apply"):
                others = {1, 8, 17, 33} if shape_name == "diagonal" else {1, 2, 3}
                for other in sorted(others - {splits}):
                    run(lib, f"{name}, {shape_name}, {other} chunks", shape, other, extra)
    for shape_name, (A, B, an, bn, _) in shapes.items():
        xyn = an[:, None] + bn[None, :]

        def library():
            return torch.addmm(xyn, A, B.T, beta=-g, alpha=2 * g).exp_()

        want = cuda_ops.gaussian_kernel_block_ref(A, B, an, bn, g)
        rows[f"library: exp(addmm(...)), {shape_name}"] = dict(
            abs_err=(library() - want).abs().max().item(),
            ms=time_ms(library, 10 if A.shape[0] > 1000 else 50))
    del X, Xt, xn, xtn, shapes
    torch.cuda.empty_cache()
    return rows


def gram_corr_sym_wrapper_rows(cuda_ops):
    """gram_corr_sym through its wrapper at the stacked route's block (A
    65,536 x 4,096, R 65,536 x 147), f32 and bf16 A; returns the rows and
    the outputs (Gramian, correlation) by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn((N, BLOCK), generator=gen, device=dev)
    R = torch.randn((N, K), generator=gen, device=dev)
    rows, outs = {}, {}
    for label, dtype in (("f32 A", torch.float32), ("bf16 A", torch.bfloat16)):
        Ak = A.to(dtype)
        want_g, want_c = cuda_ops.gram_corr_sym_ref(Ak, R)
        got = cuda_ops.gram_corr_sym(Ak, R)
        outs[label] = torch.cat([got[0], got[1]], dim=1)
        rows[label] = dict(
            gram_rel_err=(got[0] - want_g).abs().max().item() / want_g.diagonal().max().item(),
            corr_rel_err=(got[1] - want_c).abs().max().item()
            / (Ak.float().abs().T @ R.abs()).max().item(),
            ms=time_ms(lambda: cuda_ops.gram_corr_sym(Ak, R), 5))
        del Ak, want_g, want_c, got
    rows["library: A.T @ A, A.T @ R"] = dict(ms=time_ms(lambda: (A.T @ A, A.T @ R), 5))
    del A, R
    torch.cuda.empty_cache()
    return rows, outs


def block_gram_sym_wrapper_rows(cuda_ops):
    """block_gram_sym through its wrapper at the TIMIT window (F 65,536 x
    16,384, columns [8192, 12288)), f32 and bf16 F; returns the rows and
    the outputs by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    F = torch.randn((N, D_FEAT), generator=gen, device=dev)
    rows, outs = {}, {}
    for label, dtype in (("f32 F", torch.float32), ("bf16 F", torch.bfloat16)):
        Fk = F.to(dtype)
        want = cuda_ops.block_gram_sym_ref(Fk, COL_START, BLOCK)
        got = outs[label] = cuda_ops.block_gram_sym(Fk, COL_START, BLOCK)
        rows[label] = dict(
            rel_err=(got - want).abs().max().item() / want.diagonal().max().item(),
            ms=time_ms(lambda: cuda_ops.block_gram_sym(Fk, COL_START, BLOCK), 5))
        del Fk, want, got
    Fw = F[:, COL_START:COL_START + BLOCK]
    rows["library: Fw.T @ Fw"] = dict(ms=time_ms(lambda: Fw.T @ Fw, 5))
    del F, Fw
    torch.cuda.empty_cache()
    return rows, outs


def gram_sym_acc_wrapper_rows(cuda_ops):
    """gram_sym_acc through its wrapper at the streamed fit's tile (F 32,768
    x 16,384, a random G0), f32 and bf16 F, in place (the fold's call),
    checked against a new buffer's bits and for untouched lower tiles;
    returns the rows and the upper tiles by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d = STREAM_TILE, D_FEAT
    F = torch.randn((n, d), generator=gen, device=dev)
    G0 = torch.randn((d, d), generator=gen, device=dev)
    upper = _upper(d, dev)
    rows, outs = {}, {}
    for label, dtype in (("f32 F", torch.float32), ("bf16 F", torch.bfloat16)):
        Fk = F.to(dtype)
        fresh = cuda_ops.gram_sym_acc(G0, Fk)
        G = G0.clone()
        cuda_ops.gram_sym_acc(G, Fk, out=G)
        torch.cuda.synchronize()
        Ff = Fk.float()
        scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
        del Ff
        want = cuda_ops.gram_sym_acc_ref(G0, Fk)
        outs[label] = G[upper]
        rows[label] = dict(
            rel_err=((G - want).abs() / scale)[upper].max().item(),
            in_place_bits_of_new_buffer=bool(torch.equal(outs[label], fresh[upper])),
            lower_tiles_untouched=bool(torch.equal(G[~upper], G0[~upper])),
            ms=time_ms(lambda: cuda_ops.gram_sym_acc(G, Fk, out=G), 3))
        del Fk, fresh, G, scale, want
    rows["library: addmm(G0, F.T, F)"] = dict(ms=time_ms(lambda: torch.addmm(G0, F.T, F), 3))
    del F, G0, upper
    torch.cuda.empty_cache()
    return rows, outs


def gram_corr_sym_acc_wrapper_rows(cuda_ops):
    """gram_corr_sym_acc through its wrapper at the Amazon chunk (F 65,536 x
    16,385, R 65,536 x 2, a random G0 and C0): f32 F at the fold's row
    stride of 16,388 and at 16,385, f32 F's ragged last chunk of 41,248
    rows, and bf16 F at the fold's row stride of 16,448; in place (the
    fold's call), checked against a new buffer's bits and for untouched
    lower tiles; returns the rows and (G's upper tiles, C) by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    c, d1, k = AMAZON_CHUNK, AMAZON_D + 1, AMAZON_K
    F = torch.randn((c, d1), generator=gen, device=dev)
    R = torch.randn((c, k), generator=gen, device=dev)
    G0 = torch.randn((d1, d1), generator=gen, device=dev)
    C0 = torch.randn((d1, k), generator=gen, device=dev)
    upper = _upper(d1, dev)
    rows, outs = {}, {}
    cases = {
        "f32 F at the fold's row stride": lambda: f32_slab(F),
        "f32 F at row stride 16,385": lambda: F,
        "f32 F ragged chunk": lambda: f32_slab(F[:AMAZON_RAGGED]),
        "bf16 F at the fold's row stride": lambda: tma_slab(F),
    }
    for label, make in cases.items():
        Fk = make()
        Rk = R[:Fk.shape[0]]
        fresh = cuda_ops.gram_corr_sym_acc(G0, C0, Fk, Rk)
        G, C = G0.clone(), C0.clone()
        cuda_ops.gram_corr_sym_acc(G, C, Fk, Rk, out=(G, C))
        torch.cuda.synchronize()
        want_g, want_c = cuda_ops.gram_corr_sym_acc_ref(G0, C0, Fk, Rk)
        Ff = Fk.float()
        Rq = Rk.to(torch.bfloat16).float() if Fk.dtype == torch.bfloat16 else Rk
        g_scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
        c_scale = torch.addmm(C0.abs(), Ff.abs().T, Rq.abs())
        del Ff
        outs[label] = torch.cat([G[upper], C.flatten()])
        rows[label] = dict(
            gram_rel_err=((G - want_g).abs() / g_scale)[upper].max().item(),
            corr_rel_err=((C - want_c).abs() / c_scale).max().item(),
            in_place_bits_of_new_buffer=bool(torch.equal(G[upper], fresh[0][upper])
                                             and torch.equal(C, fresh[1])),
            lower_tiles_untouched=bool(torch.equal(G[~upper], G0[~upper])),
            ms=time_ms(lambda: cuda_ops.gram_corr_sym_acc(G, C, Fk, Rk, out=(G, C)), 3))
        del Fk, fresh, G, C, want_g, want_c, g_scale, c_scale
    rows["library: two float32 addmm"] = dict(
        ms=time_ms(lambda: (torch.addmm(G0, F.T, F), torch.addmm(C0, F.T, R)), 3))
    del F, R, G0, C0, upper
    torch.cuda.empty_cache()
    return rows, outs


def residual_wrapper_rows(cuda_ops):
    """block_residual_update through its wrapper at the TIMIT window, f32
    and bf16 F; returns the rows and the outputs by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    F = torch.randn((N, D_FEAT), generator=gen, device=dev)
    R = torch.randn((N, K), generator=gen, device=dev)
    dW = torch.randn((BLOCK, K), generator=gen, device=dev) * 0.01
    rows, outs = {}, {}
    for label, dtype in (("f32 F", torch.float32), ("bf16 F", torch.bfloat16)):
        Fk = F.to(dtype)
        Fw = Fk[:, COL_START:COL_START + BLOCK]
        want = cuda_ops.block_residual_update_ref(Fk, COL_START, BLOCK, dW, R)
        got = outs[label] = cuda_ops.block_residual_update(Fk, COL_START, BLOCK, dW, R)
        scale = (R.abs() + Fw.float().abs() @ dW.to(dtype).float().abs()).max().item()

        def call():
            return cuda_ops.block_residual_update(Fk, COL_START, BLOCK, dW, R)

        rows[label] = dict(rel_err=(got - want).abs().max().item() / scale, ms=time_ms(call, 10),
                           device_ms=device_ms(call, 10))
        del Fk, Fw, want, got
    Fw = F[:, COL_START:COL_START + BLOCK]
    rows["library: addmm(R, Fw, dW, alpha=-1)"] = dict(
        ms=time_ms(lambda: torch.addmm(R, Fw, dW, alpha=-1), 10))
    del F, R, dW, Fw
    torch.cuda.empty_cache()
    return rows, outs


def gaussian_wrapper_rows(cuda_ops):
    """gaussian_kernel_block through its wrapper at each CIFAR shape;
    returns the rows and the outputs by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    g = CIFAR_GAMMA
    X = torch.randn((CIFAR_N, CIFAR_D), generator=gen, device=dev)
    Xt = torch.randn((CIFAR_TEST, CIFAR_D), generator=gen, device=dev)
    xn, xtn = (X * X).sum(1), (Xt * Xt).sum(1)
    rows, outs = {}, {}
    for label, (A, B, an, bn, _) in cifar_gaussian_shapes(X, xn, Xt, xtn).items():
        reps = 10 if A.shape[0] > 1000 else 50
        want = cuda_ops.gaussian_kernel_block_ref(A, B, an, bn, g)
        got = outs[label] = cuda_ops.gaussian_kernel_block(A, B, an, bn, g)
        xyn = an[:, None] + bn[None, :]

        def call():
            return cuda_ops.gaussian_kernel_block(A, B, an, bn, g)

        rows[label] = dict(
            abs_err=(got - want).abs().max().item(), ms=time_ms(call, reps),
            device_ms=device_ms(call, reps),
            library_ms=time_ms(lambda: torch.addmm(xyn, A, B.T, beta=-g, alpha=2 * g).exp_(),
                               reps))
        del want, got, xyn
    del X, Xt, xn, xtn
    torch.cuda.empty_cache()
    return rows, outs


def resid_wrapper_rows(cuda_ops):
    """gaussian_resid_block through its wrapper at the CIFAR sweep's two
    block sizes (512 rows and the ragged 336), f32 and bf16 operands;
    returns the rows and the outputs by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    g, k = CIFAR_GAMMA, CIFAR_K
    X = torch.randn((CIFAR_N, CIFAR_D), generator=gen, device=dev)
    xn = (X * X).sum(1)
    W = torch.randn((CIFAR_N, k), generator=gen, device=dev) * 0.01
    last = (CIFAR_BLOCKS - 1) * CIFAR_BLOCK
    rows, outs = {}, {}
    for label, (Y, yn) in {"block": (X[2 * CIFAR_BLOCK:3 * CIFAR_BLOCK],
                                     xn[2 * CIFAR_BLOCK:3 * CIFAR_BLOCK]),
                           "ragged block": (X[last:], xn[last:])}.items():
        for dlabel, dtype in (("f32", torch.float32), ("bf16 operands", torch.bfloat16)):
            want = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g, compute_dtype=dtype)
            K_ = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g, compute_dtype=dtype)
            scale = (K_.T @ W.abs()).max().item()
            got = outs[f"{label}, {dlabel}"] = cuda_ops.gaussian_resid_block(
                X, Y, xn, yn, W, g, compute_dtype=dtype)

            def call():
                return cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g, compute_dtype=dtype)

            rows[f"{label}, {dlabel}"] = dict(
                rel_err=(got - want).abs().max().item() / scale, ms=time_ms(call, 10),
                device_ms=device_ms(call, 10))
            del want, K_
        xyn = xn[:, None] + yn[None, :]
        rows[f"library: exp(addmm(...)).T @ W, {label}"] = dict(
            ms=time_ms(lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_().T @ W, 10))
        del xyn
    del X, W, xn
    torch.cuda.empty_cache()
    return rows, outs


def cosine_wrapper_rows(cuda_ops):
    """cosine_features through its wrapper at one TIMIT branch, f32, bf16
    operands and bf16 output into a fresh (m, n) output, and f32 into its
    column window of the (65,536, 16,384) fused feature matrix (the flat
    route's call); returns the rows and the outputs by row."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    m, d, n = N, D_IN, BLOCK
    X = torch.randn((m, d), generator=gen, device=dev) * 0.6
    W = torch.randn((n, d), generator=gen, device=dev) * 0.05555
    b = torch.rand((n,), generator=gen, device=dev) * 6.283185307179586
    fused = torch.empty((m, D_FEAT), device=dev)
    window = fused[:, COL_START:COL_START + n]
    rows, outs = {}, {}
    cases = {
        "f32": (torch.float32, None, None),
        "bf16 operands": (torch.bfloat16, None, None),
        "bf16 output": (torch.float32, torch.bfloat16, None),
        "f32 into the fused matrix's window": (torch.float32, None, window),
    }
    for label, (compute, out_dtype, out) in cases.items():
        want = cuda_ops.cosine_features_ref(X, W, b, compute, out_dtype)

        def call():
            return cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out_dtype,
                                            out=out)

        got = call()
        outs[label] = got.clone()
        rows[label] = dict(abs_err=(got.float() - want.float()).abs().max().item(),
                           ms=time_ms(call, 10), device_ms=device_ms(call, 10))
        del want, got
    rows["library: cos(addmm(b, X, W.T))"] = dict(
        ms=time_ms(lambda: torch.cos(torch.addmm(b, X, W.T)), 10))
    del X, W, b, fused, window
    torch.cuda.empty_cache()
    return rows, outs


def conv_inputs(count):
    """``count`` CIFAR images (pixels in [0, 255]), 100 unit filters of
    6 x 6 x 3 and whitening means, as phase 1 of chip_smoke.py makes them."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    images = torch.rand((count, 32, 32, 3), generator=gen, device=dev) * 255
    filters = torch.randn((CIFAR_FILTERS, 108), generator=gen, device=dev)
    filters /= filters.norm(dim=1, keepdim=True)
    means = torch.randn((108,), generator=gen, device=dev) * 0.1
    return images, filters, means


def conv_chunk():
    """Images in one row chunk of the fused CIFAR featurizer."""
    from keystone_tpu_torch.workflow import fusion

    return _conv_chunk_rows(fusion)


def conv_rows(cuda_ops, libs, stream, sms):
    """Each conv_featurize variant at one row chunk of the CIFAR
    featurization; held against the plain version (relative to the sums'
    scale, max over entries of |P~| |F|ᵀ, as chip_smoke.py) and the
    as-built variant's bits (every variant keeps each output's fmaf
    chain); beside the product alone on cuBLAS."""
    from keystone_tpu_torch.ops import cuda_images

    c = conv_chunk()
    images, filters, means = conv_inputs(c)
    npix = c * 27 * 27
    out = torch.empty((c, 27, 27, CIFAR_FILTERS), device=images.device)
    want = cuda_images.conv_featurize_ref(images, filters, means, patch_size=6)
    patches = (cuda_images.normalize_patch_rows(cuda_images.im2col(images, 6), 10.0)
               - means).view(npix, 108)
    scale = (patches.abs() @ filters.abs().T).max().item()
    flops = 2 * npix * 108 * CIFAR_FILTERS + 5 * npix * 108
    rows, built = {}, None
    for (kernel, name), lib in libs.items():
        if kernel != "conv_featurize":
            continue
        cfg = (ctypes.c_int * 7)()
        lib.kt_conv_featurize_config(c, 32, 32, 3, 6, CIFAR_FILTERS, cfg)
        blocks, bps, regs, local, ktile, smem, vec = cfg

        def call():
            err = lib.kt_conv_featurize(images.data_ptr(), filters.data_ptr(), means.data_ptr(),
                                        out.data_ptr(), c, 32, 32, 3, 6, CIFAR_FILTERS, 1, 10.0,
                                        stream)
            if err:
                raise RuntimeError(f"conv_featurize {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        if name == "as built":
            built = out.clone()
        ms = time_ms(call, 10)
        rows[name] = dict(rel_err=(out - want).abs().max().item() / scale,
                          bits_of_as_built=bool(torch.equal(out, built)), blocks=blocks,
                          blocks_per_sm=bps, registers=regs, local_bytes=local, ktile=ktile,
                          smem_bytes=smem, vec_stores=bool(vec), ms=ms,
                          device_ms=device_ms(call, 10), tflops=flops / ms / 1e9)
        if name == "as built":
            # The same kernel with the normalisation switched off (no
            # statistics, no division): what they cost.
            def plain_call():
                err = lib.kt_conv_featurize(
                    images.data_ptr(), filters.data_ptr(), means.data_ptr(), out.data_ptr(), c,
                    32, 32, 3, 6, CIFAR_FILTERS, 0, 10.0, stream)
                if err:
                    raise RuntimeError(f"conv_featurize {name}: launch failed ({err})")

            plain_call()
            torch.cuda.synchronize()
            off = cuda_images.conv_featurize_ref(images, filters, means, patch_size=6,
                                                 normalize_patches=False)
            ms = time_ms(plain_call, 10)
            rows["as built, normalisation off"] = dict(
                rel_err=(out - off).abs().max().item() / off.abs().max().item(), ms=ms,
                device_ms=device_ms(plain_call, 10), tflops=flops / ms / 1e9)
            del off
    ms = time_ms(lambda: torch.matmul(patches, filters.T), 10)
    rows["library: matmul(P~, F.T), the product alone"] = dict(
        ms=ms, tflops=2 * npix * 108 * CIFAR_FILTERS / ms / 1e9)
    del images, filters, means, out, want, patches, built
    torch.cuda.empty_cache()
    return rows


# Each checkout's cuda_images, bound to that checkout's cuda_ops, by the
# cuda_ops module's name.
_CUDA_IMAGES = {}


def conv_wrapper_rows(cuda_ops):
    """conv_featurize through the wrapper of the checkout that ``cuda_ops``
    belongs to, at one row chunk of the CIFAR featurization and at the
    one-image first chunk; returns the rows and the outputs by row."""
    images_mod = _CUDA_IMAGES.get(cuda_ops.__name__)
    if images_mod is None:
        path = os.path.join(os.path.dirname(cuda_ops.__file__), "cuda_images.py")
        spec = importlib.util.spec_from_file_location(f"cuda_images_{cuda_ops.__name__}", path)
        images_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(images_mod)
        images_mod.cuda_ops = cuda_ops
        _CUDA_IMAGES[cuda_ops.__name__] = images_mod
    c = conv_chunk()
    images, filters, means = conv_inputs(c)
    rows, outs = {}, {}
    for label, count in ((f"row chunk of {c} images", c), ("one image", 1)):
        batch = images[:count]
        want = images_mod.conv_featurize_ref(batch, filters, means, patch_size=6)

        def call():
            return images_mod.conv_featurize(batch, filters, means, patch_size=6)

        got = outs[label] = call()
        rows[label] = dict(abs_err=(got - want).abs().max().item(), ms=time_ms(call, 10),
                           device_ms=device_ms(call, 10))
        del want
    del images, filters, means
    torch.cuda.empty_cache()
    return rows, outs


# The wrappers timed in --root mode: kernel -> rows function.
WRAPPER_ROWS = {
    "gram_sym_acc": gram_sym_acc_wrapper_rows,
    "gram_corr_sym_acc": gram_corr_sym_acc_wrapper_rows,
    "gram_corr_sym": gram_corr_sym_wrapper_rows,
    "block_gram_sym": block_gram_sym_wrapper_rows,
    "block_residual_update": residual_wrapper_rows,
    "gaussian_kernel_block": gaussian_wrapper_rows,
    "gaussian_resid_block": resid_wrapper_rows,
    "cosine_features": cosine_wrapper_rows,
    "conv_featurize": conv_wrapper_rows,
}


def load_cuda_ops(root, index):
    """The ``cuda_ops`` module of the checkout at ``root``, loaded under a
    name of its own, so several checkouts' kernels run in one process (each
    builds into its own ``build/`` directory)."""
    path = os.path.join(root, "keystone_tpu_torch", "ops", "cuda_ops.py")
    spec = importlib.util.spec_from_file_location(f"cuda_ops_{index}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_roots(roots, kernels):
    """Each checkout's wrappers (WRAPPER_ROWS, those of ``kernels``) in turns,
    first to last and back (parent, change, change, parent for two), in one
    process on one card; every output held against the first checkout's
    first turn: the same bits, or the largest difference."""
    modules = [load_cuda_ops(root, i) for i, root in enumerate(roots)]
    for module in modules:
        module.build(kernels)
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    first, turns = {}, []
    for i in order:
        turn = dict(root=roots[i])
        for kernel in kernels:
            rows, outs = WRAPPER_ROWS[kernel](modules[i])
            for label, out in outs.items():
                if (kernel, label) not in first:
                    first[kernel, label] = out
                ref = first[kernel, label]
                rows[label]["bits_of_first_root"] = bool(torch.equal(out, ref))
                rows[label]["max_diff_from_first_root"] = (
                    out.float() - ref.float()).abs().max().item()
            turn[kernel] = rows
            del outs
        turns.append(turn)
    return turns


def resid_rows(cuda_ops, libs, stream, sms):
    """Each gaussian_resid_block variant at the CIFAR sweep's shapes (one
    512-row block, and the ragged last one of 336 rows, against the 50,000
    training rows; k = 10), with the row chunks gaussian_resid_splits picks
    for its resident blocks an SM; each held against the plain version (the
    error relative to the sums' scale) and against the as-built variant's
    bits (every variant keeps each entry's fmaf chain)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    d, g, k = CIFAR_D, CIFAR_GAMMA, CIFAR_K
    X = torch.randn((CIFAR_N, d), generator=gen, device=dev)
    xn = (X * X).sum(1)
    W = torch.randn((CIFAR_N, k), generator=gen, device=dev) * 0.01
    last = (CIFAR_BLOCKS - 1) * CIFAR_BLOCK
    shapes = {"block": (X[2 * CIFAR_BLOCK:3 * CIFAR_BLOCK], xn[2 * CIFAR_BLOCK:3 * CIFAR_BLOCK]),
              "ragged block": (X[last:], xn[last:])}
    rows, built = {}, {}
    flops = {label: 2 * CIFAR_N * Y.shape[0] * (d + k) for label, (Y, _) in shapes.items()}
    for (kernel, name), lib in libs.items():
        if kernel != "gaussian_resid_block":
            continue
        cfg = (ctypes.c_int * 5)()
        lib.kt_gaussian_resid_block_config(k, 0, 1, cfg)
        ktile, bps, regs, local, smem = cfg
        for label, (Y, yn) in shapes.items():
            n = Y.shape[0]
            splits = cuda_ops.gaussian_resid_splits(CIFAR_N, n, sms, bps)
            P = torch.empty((splits, n, k), device=dev)
            C = torch.empty((n, k), device=dev)

            def call():
                err = lib.kt_gaussian_resid_block(
                    X.data_ptr(), Y.data_ptr(), xn.data_ptr(), yn.data_ptr(), W.data_ptr(),
                    P.data_ptr(), C.data_ptr(), CIFAR_N, n, d, k, X.stride(0), Y.stride(0),
                    W.stride(0), splits, g, 0, stream)
                if err:
                    raise RuntimeError(f"gaussian_resid_block {name}: launch failed ({err})")

            call()
            torch.cuda.synchronize()
            want = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g)
            scale = (cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g).T @ W.abs()).max().item()
            if name == "as built":
                built[label] = C.clone()
            ms = time_ms(call, 10)
            rows[f"{name}, {label}"] = dict(
                rel_err=(C - want).abs().max().item() / scale,
                bits_of_as_built=bool(torch.equal(C, built[label])), splits=splits,
                blocks=-(-n // 128) * splits, ktile=ktile, blocks_per_sm=bps, registers=regs,
                local_bytes=local, smem_bytes=smem, ms=ms, tflops=flops[label] / ms / 1e9)
    for label, (Y, yn) in shapes.items():
        xyn = xn[:, None] + yn[None, :]

        def library():
            return torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_().T @ W

        ms = time_ms(library, 10)
        rows[f"library: exp(addmm(...)).T @ W, {label}"] = dict(
            ms=ms, tflops=flops[label] / ms / 1e9)
    del X, W, xn, shapes
    torch.cuda.empty_cache()
    return rows


def cosine_rows(cuda_ops, libs, stream, sms):
    """Each cosine_features variant at one TIMIT branch (X 65,536 x 440,
    W 4,096 x 440, f32), written as the flat route writes it: into its
    column window of the (65,536, 16,384) fused feature matrix; held
    against the plain version and the as-built variant's bits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    m, d, n = N, D_IN, BLOCK
    X = torch.randn((m, d), generator=gen, device=dev) * 0.6
    W = torch.randn((n, d), generator=gen, device=dev) * 0.05555
    b = torch.rand((n,), generator=gen, device=dev) * 6.283185307179586
    fused = torch.empty((m, D_FEAT), device=dev)
    out = fused[:, COL_START:COL_START + n]
    want = cuda_ops.cosine_features_ref(X, W, b)
    flops = 2 * m * n * d
    rows, built = {}, None
    for (kernel, name), lib in libs.items():
        if kernel != "cosine_features":
            continue
        cfg = (ctypes.c_int * 3)()
        lib.kt_cosine_features_config(0, 0, 1, cfg)
        bps, regs, local = cfg

        def call():
            err = lib.kt_cosine_features(
                X.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d, X.stride(0),
                W.stride(0), out.stride(0), 0, 0, stream)
            if err:
                raise RuntimeError(f"cosine_features {name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        if name == "as built":
            built = out.clone()
        ms = time_ms(call, 10)
        rows[name] = dict(abs_err=(out - want).abs().max().item(),
                          bits_of_as_built=bool(torch.equal(out, built)),
                          blocks=-(-m // 128) * -(-n // 128), blocks_per_sm=bps, registers=regs,
                          local_bytes=local, ms=ms, tflops=flops / ms / 1e9)
    ms = time_ms(lambda: torch.cos(torch.addmm(b, X, W.T)), 10)
    rows["library: cos(addmm(b, X, W.T))"] = dict(ms=ms, tflops=flops / ms / 1e9)
    del X, W, b, fused, out, want, built
    torch.cuda.empty_cache()
    return rows


# Each kernel's rows: (cuda_ops, libs, stream, SM count) -> {variant: numbers}.
ROWS = {
    "block_corr": block_corr_rows,
    "gram_corr": lambda cuda_ops, libs, stream, sms: gram_corr_rows(cuda_ops, libs, stream),
    "block_gram_sym": lambda cuda_ops, libs, stream, sms: block_gram_sym_rows(cuda_ops, libs,
                                                                            stream),
    "block_residual_update": block_residual_rows,
    "gaussian_kernel_block": gaussian_rows,
    "gaussian_resid_block": resid_rows,
    "cosine_features": cosine_rows,
    "gram_sym_acc": lambda cuda_ops, libs, stream, sms: gram_sym_acc_rows(cuda_ops, libs, stream),
    "gram_corr_sym_acc": lambda cuda_ops, libs, stream, sms: gram_corr_sym_acc_rows(
        cuda_ops, libs, stream),
    "conv_featurize": conv_rows,
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/torch_fma_variants.json")
    parser.add_argument("--kernels", nargs="+",
                        help="the kernels to build and time (default: all ten; with --root, "
                        "all nine wrappers of WRAPPER_ROWS)")
    parser.add_argument("--root", nargs="+",
                        help="time the wrappers of the checkouts at these directories in turns "
                        "(first to last and back) instead of building variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fma_variants: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.root:
        turns = compare_roots([os.path.abspath(root) for root in args.root],
                              args.kernels or list(WRAPPER_ROWS))
        result = dict(card=card, turns=turns)
    else:
        from keystone_tpu_torch.ops import cuda_ops

        args.kernels = args.kernels or list(ROWS)
        libs = build(cuda_ops, args.kernels)
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        turns = [dict(root=_REPO, **{kernel: ROWS[kernel](cuda_ops, libs, stream, sms)
                                    for kernel in args.kernels})]
        result = dict(card=card, **turns[0])
    for turn in turns:
        for kernel, rows in turn.items():
            if not isinstance(rows, dict):
                continue
            for name, r in rows.items():
                extra = {key: v for key, v in r.items() if key not in ("ms", "tflops")}
                tflops = f", {r['tflops']:5.1f} TFLOP/s" if "tflops" in r else ""
                print(f"{turn['root']}: {kernel} {name:>24}: {r['ms']:8.3f} ms{tflops}, {extra}")
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
