"""The tensor-core Gramian's tuning constants, measured on one GPU.

    python3 scripts/torch_gram_variants.py [--out build/torch_gram_variants.json]

Builds variants of ``keystone_tpu_torch/csrc/gram_wgmma.cuh``, the TMA +
``wgmma`` mainloop of every bf16 Gramian-alone and accumulating kernel, that
differ from it in one constant each (``STAGES``, the shared-memory ring's
depth; ``PROMOTE``, the 64-row stages the tensor cores sum before one FP32
add; ``GH``, the tile rows of a group in the block order). Each variant is
a directory under ``build/keystone_tpu_torch/variants/`` holding copies of
the headers (its ``gram_wgmma.cuh`` edited) and of the two sources that
include it, ``gram_corr_sym_acc.cu`` and ``gram_corr.cu``; one ``nvcc`` a
source, all started together. Then it times each variant's three
instances on one card, each held against its plain version (the upper
tiles' error relative to the sums' scale, as ``chip_smoke.py`` does) and
against the as-built variant's bits, beside the library yardstick (bf16
operands through ``addmm`` with float32 output):

  - ACC with labels, ``gram_corr_sym_acc`` at the sparse fold's Amazon
    chunk (bf16 F 65,536 x 16,385 at the fold's 64-element row stride, R
    65,536 x 2, random G and C);
  - ACC without labels, ``gram_sym_acc`` at the streamed fit's tile (bf16 F
    32,768 x 16,384, a random G, in place);
  - STORE, ``block_gram_sym`` at the TIMIT window (bf16 F 65,536 x 16,384,
    columns [8192, 12288)).

One set of constants serves all three (their bits are linked), so the
table says which set is fastest for each. Prints one line a variant and
instance and writes the numbers, with the card's name and power limit, as
JSON to ``--out``. Needs a CUDA device; exits non-zero without one.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

# (name, the header's line, its replacement); "as built" is the header.
VARIANTS = [
    ("as built", None, None),
    ("STAGES 5", "constexpr int STAGES = 4;", "constexpr int STAGES = 5;"),
    ("STAGES 6", "constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
    ("PROMOTE 1", "constexpr int PROMOTE = 2;", "constexpr int PROMOTE = 1;"),
    ("PROMOTE 4", "constexpr int PROMOTE = 2;", "constexpr int PROMOTE = 4;"),
    ("GH 4", "constexpr int GH = 8;", "constexpr int GH = 4;"),
    ("GH 16", "constexpr int GH = 8;", "constexpr int GH = 16;"),
]
HEADER = "gram_wgmma.cuh"
SOURCES = ("gram_corr_sym_acc", "gram_corr")
C, D1, K = 65536, 16385, 2  # the Amazon chunk: 16,384 features and the intercept lane
TILE, D = 32768, 16384      # the streamed fit's tile
WN, WS, WB = 65536, 8192, 4096  # the TIMIT window: F 65,536 x 16,384, columns [8192, 12288)


def time_ms(fn, reps=3):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build(cuda_ops):
    """Compile every variant's two sources; returns name -> {symbol: the
    loaded C entry point}."""
    header = (cuda_ops._CSRC / HEADER).read_text()
    root = cuda_ops._BUILD / "variants"
    procs = []
    for i, (name, old, new) in enumerate(VARIANTS):
        if old is not None and old not in header:
            raise RuntimeError(f"{name}: {old!r} is not in {HEADER}")
        vdir = root / f"variant{i}"
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for path in cuda_ops._CSRC.glob("*.cuh"):
            shutil.copy(path, vdir / path.name)
        (vdir / HEADER).write_text(header if old is None else header.replace(old, new))
        for source in SOURCES:
            shutil.copy(cuda_ops._CSRC / f"{source}.cu", vdir / f"{source}.cu")
            cmd = [cuda_ops._nvcc(), *cuda_ops._NVCC_FLAGS, "-o", str(vdir / f"lib{source}.so"),
                   str(vdir / f"{source}.cu")]
            procs.append((name, vdir, source, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, vdir, source, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({source}):\n{log}")
        lib = ctypes.CDLL(str(vdir / f"lib{source}.so"))
        for symbol, argtypes in cuda_ops._symbols(source).items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns.setdefault(name, {})[symbol] = fn
    return fns


def _upper(d, dev):
    tiles = torch.arange(d, device=dev) // 128
    return tiles[:, None] <= tiles[None, :]


def _checked(name, err):
    if err:
        raise RuntimeError(f"{name}: launch failed ({err})")


def amazon_rows(cuda_ops, fns, stream, gen):
    """ACC with k = 2 labels at the Amazon chunk, in place."""
    dev = torch.device("cuda")
    F32 = torch.randn((C, D1), generator=gen, device=dev)
    F = torch.zeros((C, -(-D1 // 64) * 64), dtype=torch.bfloat16, device=dev)[:, :D1]
    F.copy_(F32)
    del F32
    R = torch.randn((C, K), generator=gen, device=dev)
    G0 = torch.randn((D1, D1), generator=gen, device=dev)
    C0 = torch.randn((D1, K), generator=gen, device=dev)
    want_g, _ = cuda_ops.gram_corr_sym_acc_ref(G0, C0, F, R)
    Fa = F.float().abs_()
    scale = torch.addmm(G0.abs(), Fa.T, Fa)
    del Fa
    upper = _upper(D1, dev)
    rows, first = {}, None
    for name, syms in fns.items():
        gout, cout = G0.clone(), C0.clone()

        def call():
            _checked(name, syms["kt_gram_corr_sym_acc"](
                F.data_ptr(), R.data_ptr(), gout.data_ptr(), cout.data_ptr(), gout.data_ptr(),
                cout.data_ptr(), C, D1, K, F.stride(0), R.stride(0), gout.stride(0),
                cout.stride(0), gout.stride(0), cout.stride(0), 1, stream))

        gout.copy_(G0)
        cout.copy_(C0)
        call()
        torch.cuda.synchronize()
        out = gout[upper]
        first = out if first is None else first
        rows[name] = dict(gram_rel_err=((gout - want_g).abs_().div_(scale))[upper].max().item(),
                          bits_of_as_built=bool(torch.equal(out, first)), ms=time_ms(call))
        del gout, cout, out
    R16 = R.to(torch.bfloat16)
    rows["library: two bf16 addmm"] = dict(ms=time_ms(lambda: (
        torch.addmm(G0, F.T, F, out_dtype=torch.float32),
        torch.addmm(C0, F.T, R16, out_dtype=torch.float32))))
    flops = C * D1 * (D1 + 1) + 2 * C * D1 * K
    return rows, flops


def streamed_rows(cuda_ops, fns, stream, gen):
    """ACC without labels (gram_sym_acc) at the streamed fit's tile, in place."""
    dev = torch.device("cuda")
    F = torch.randn((TILE, D), generator=gen, device=dev).to(torch.bfloat16)
    G0 = torch.randn((D, D), generator=gen, device=dev)
    want = cuda_ops.gram_sym_acc_ref(G0, F)
    Fa = F.float().abs_()
    scale = torch.addmm(G0.abs(), Fa.T, Fa)
    del Fa
    upper = _upper(D, dev)
    rows, first = {}, None
    for name, syms in fns.items():
        G = G0.clone()

        def call():
            _checked(name, syms["kt_gram_sym_acc"](
                F.data_ptr(), G.data_ptr(), G.data_ptr(), TILE, D, F.stride(0), G.stride(0),
                G.stride(0), 1, stream))

        call()
        torch.cuda.synchronize()
        out = G[upper]
        first = out if first is None else first
        rows[name] = dict(gram_rel_err=((G - want).abs_().div_(scale))[upper].max().item(),
                          bits_of_as_built=bool(torch.equal(out, first)), ms=time_ms(call))
        del G, out
    rows["library: bf16 addmm(G0, F.T, F)"] = dict(
        ms=time_ms(lambda: torch.addmm(G0, F.T, F, out_dtype=torch.float32)))
    return rows, TILE * D * (D + 1)


def window_rows(cuda_ops, fns, stream, gen):
    """STORE (block_gram_sym) at the TIMIT window."""
    dev = torch.device("cuda")
    F = torch.randn((WN, D), generator=gen, device=dev).to(torch.bfloat16)
    want = cuda_ops.block_gram_sym_ref(F, WS, WB)
    scale = want.diagonal().max().item()
    rows, first = {}, None
    for name, syms in fns.items():
        G = torch.empty((WB, WB), device=dev)

        def call():
            _checked(name, syms["kt_block_gram_sym"](
                F.data_ptr(), G.data_ptr(), WN, WS, WB, F.stride(0), 1, stream))

        call()
        torch.cuda.synchronize()
        first = G.clone() if first is None else first
        rows[name] = dict(gram_rel_err=(G - want).abs().max().item() / scale,
                          symmetric=bool(torch.equal(G, G.T)),
                          bits_of_as_built=bool(torch.equal(G, first)), ms=time_ms(call))
        del G
    Fw = F[:, WS:WS + WB]
    rows["library: bf16 addmm(Fw.T, Fw)"] = dict(ms=time_ms(lambda: torch.addmm(
        torch.zeros((WB, WB), device=dev), Fw.T, Fw, beta=0, out_dtype=torch.float32)))
    return rows, WN * WB * (WB + 1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/torch_gram_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gram_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from keystone_tpu_torch.ops import cuda_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    fns = build(cuda_ops)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    instances = {}
    for label, rows_of in (("ACC k = 2, gram_corr_sym_acc at the Amazon chunk", amazon_rows),
                           ("ACC k = 0, gram_sym_acc at the streamed tile", streamed_rows),
                           ("STORE, block_gram_sym at the TIMIT window", window_rows)):
        rows, flops = rows_of(cuda_ops, fns, stream, gen)
        torch.cuda.empty_cache()
        for name, r in rows.items():
            r["tflops"] = flops / r["ms"] / 1e9
            extra = {key: v for key, v in r.items() if key not in ("ms", "tflops")}
            print(f"{label}: {name:>32}: {r['ms']:8.3f} ms, {r['tflops']:6.1f} TFLOP/s, {extra}",
                  flush=True)
        instances[label] = rows
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, instances=instances), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
