"""The pipelined FP32-FMA kernels' tuning constants, measured on one GPU.

    python3 scripts/torch_fma_variants.py [--out build/torch_fma_variants.json]

Builds variants of ``keystone_tpu_torch/csrc/block_corr.cu`` and
``keystone_tpu_torch/csrc/gram_corr.cu`` that differ from them in one
constant each (``STAGES``, the cp.async ring's depth; ``BK``, the rows a
stage, of the Gramian in ``gram_corr``; ``KT_WIDE``, the label tile of
k > 32: 128 takes k = 147 in two tiles, the second masked past column 19;
``MINB``, the blocks an SM the registers are capped for; ``CORR_MI``, the
columns of A a thread of a ``gram_corr`` correlation block, x 16 a block) into
``build/keystone_tpu_torch/variants/``, one
``nvcc`` each, all started together. Then, at the TIMIT slice's shapes
(``block_corr``: F 65,536 x 16,384 float32, the window [8192, 12288), R
65,536 x 147; ``gram_corr``: A 65,536 x 4,096, R 65,536 x 147), it holds each
variant against the plain version (the error relative to the sums' scale,
as ``chip_smoke.py`` does; a ``gram_corr`` variant's outputs also against
``gram_corr_sym``'s bits) and times it with CUDA events, beside the library
yardstick (``Fw.T @ R``; ``A.T @ A`` and ``A.T @ R``). ``block_corr`` is
also timed as built at other row-chunk counts than the one
``cuda_ops.corr_splits`` picks. Prints one line a variant and writes the
numbers, with the card's name and power limit, as JSON to ``--out``. Needs
a CUDA device; exits non-zero without one.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

# (kernel, name, the source's line, its replacement); "as built" is the source.
VARIANTS = [
    ("block_corr", "as built", None, None),
    ("block_corr", "STAGES 3", "constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
    ("block_corr", "STAGES 4", "constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),
    ("block_corr", "BK 8", "constexpr int BK = 16;", "constexpr int BK = 8;"),
    ("block_corr", "BK 32", "constexpr int BK = 16;", "constexpr int BK = 32;"),
    ("block_corr", "KT_WIDE 128", "constexpr int KT_WIDE = 160;", "constexpr int KT_WIDE = 128;"),
    ("block_corr", "MINB 1", "constexpr int MINB = 2;", "constexpr int MINB = 1;"),
    ("gram_corr", "as built", None, None),
    ("gram_corr", "STAGES 2", "constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
    ("gram_corr", "STAGES 4", "constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
    ("gram_corr", "BK 8", "constexpr int BK = 32;", "constexpr int BK = 8;"),
    ("gram_corr", "BK 16", "constexpr int BK = 32;", "constexpr int BK = 16;"),
    ("gram_corr", "CORR_MI 2", "constexpr int CORR_MI = 4;", "constexpr int CORR_MI = 2;"),
    ("gram_corr", "CORR_MI 8", "constexpr int CORR_MI = 4;", "constexpr int CORR_MI = 8;"),
]
N, D_FEAT, COL_START, BLOCK, K = 65536, 16384, 8192, 4096, 147


def time_ms(fn, reps):
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
    """Compile every variant; returns (kernel, name) -> the loaded library."""
    out_dir = cuda_ops._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (kernel, name, old, new) in enumerate(VARIANTS):
        src = (cuda_ops._CSRC / f"{kernel}.cu").read_text()
        if old is not None:
            if old not in src:
                raise RuntimeError(f"{kernel} {name}: {old!r} is not in the kernel source")
            src = src.replace(old, new)
        path = out_dir / f"fma_variant{i}.cu"
        path.write_text(src)
        cmd = [cuda_ops._nvcc(), *cuda_ops._NVCC_FLAGS, "-I", str(cuda_ops._CSRC), "-o",
               str(out_dir / f"libfma_variant{i}.so"), str(path)]
        procs[kernel, name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libfma_variant{i}.so"))
        for symbol, argtypes in [cuda_ops._ENTRY_POINTS[kernel],
                                 *cuda_ops._EXTRA_SYMBOLS[kernel]]:
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
        cfg = (ctypes.c_int * 8)()
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/torch_fma_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fma_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from keystone_tpu_torch.ops import cuda_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build(cuda_ops)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = dict(card=card, block_corr=block_corr_rows(cuda_ops, libs, stream, sms),
                  gram_corr=gram_corr_rows(cuda_ops, libs, stream))
    for kernel in ("block_corr", "gram_corr"):
        for name, r in result[kernel].items():
            extra = {key: v for key, v in r.items() if key not in ("ms", "tflops")}
            print(f"{kernel} {name:>24}: {r['ms']:8.3f} ms, {r['tflops']:5.1f} TFLOP/s, {extra}")
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
