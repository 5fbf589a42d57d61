"""The bf16 ``gram_corr_sym_acc`` kernel's tuning constants, measured on one GPU.

    python3 scripts/torch_gram_variants.py [--out chiprun_out/torch_gram_variants.json]

Builds variants of ``keystone_tpu_torch/csrc/gram_corr_sym_acc.cu`` that
differ from it in one constant each (``STAGES``, the shared-memory ring's
depth; ``PROMOTE``, the 64-row stages the tensor cores sum before one FP32
add; ``GH``, the tile rows of a group in the block order) into
``build/keystone_tpu_torch/variants/``, one ``nvcc`` each, all started
together. Then, at the sparse fold's Amazon chunk (bf16 F 65,536 x 16,385
at the fold's 64-element row stride, R 65,536 x 2, random G and C), it
holds each variant against the plain version (the upper tiles' error
relative to the sums' scale, as ``chip_smoke.py`` does) and times it with
CUDA events, and does the same for the library yardstick, two bf16
``addmm`` with float32 output. Prints one line a variant and writes the
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

# (name, the source's line, its replacement); "as built" is the source.
VARIANTS = [
    ("as built", None, None),
    ("STAGES 5", "constexpr int STAGES = 4;", "constexpr int STAGES = 5;"),
    ("STAGES 6", "constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
    ("PROMOTE 1", "constexpr int PROMOTE = 2;", "constexpr int PROMOTE = 1;"),
    ("PROMOTE 4", "constexpr int PROMOTE = 2;", "constexpr int PROMOTE = 4;"),
    ("GH 4", "constexpr int GH = 8;", "constexpr int GH = 4;"),
    ("GH 16", "constexpr int GH = 8;", "constexpr int GH = 16;"),
]
C, D1, K = 65536, 16385, 2  # the Amazon chunk: 16,384 features and the intercept lane


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
    """Compile every variant; returns name -> the loaded C entry point."""
    src = (cuda_ops._CSRC / "gram_corr_sym_acc.cu").read_text()
    out_dir = cuda_ops._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, old, new) in enumerate(VARIANTS):
        if old is not None:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is not in the kernel source")
            text = src.replace(old, new)
        else:
            text = src
        path = out_dir / f"variant{i}.cu"
        path.write_text(text)
        cmd = [cuda_ops._nvcc(), *cuda_ops._NVCC_FLAGS, "-I", str(cuda_ops._CSRC), "-o",
               str(out_dir / f"libvariant{i}.so"), str(path)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"libvariant{i}.so")), "kt_gram_corr_sym_acc")
        fn.argtypes = cuda_ops._ENTRY_POINTS["gram_corr_sym_acc"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/torch_gram_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gram_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from keystone_tpu_torch.ops import cuda_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    fns = build(cuda_ops)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
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
    tiles = torch.arange(D1, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    flops = C * D1 * (D1 + 1) + 2 * C * D1 * K
    stream = torch.cuda.current_stream().cuda_stream

    def rel_err(gout):
        return ((gout - want_g).abs_().div_(scale))[upper].max().item()

    rows = {}
    for name, fn in fns.items():
        gout, cout = G0.clone(), C0.clone()

        def call():
            err = fn(F.data_ptr(), R.data_ptr(), G0.data_ptr(), C0.data_ptr(), gout.data_ptr(),
                     cout.data_ptr(), C, D1, K, F.stride(0), R.stride(0), G0.stride(0),
                     C0.stride(0), gout.stride(0), cout.stride(0), 1, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        rows[name] = dict(gram_rel_err=rel_err(gout), ms=time_ms(call))
    R16 = R.to(torch.bfloat16)
    lib_g = torch.addmm(G0, F.T, F, out_dtype=torch.float32)
    rows["library: two bf16 addmm"] = dict(
        gram_rel_err=rel_err(lib_g),
        ms=time_ms(lambda: (torch.addmm(G0, F.T, F, out_dtype=torch.float32),
                            torch.addmm(C0, F.T, R16, out_dtype=torch.float32))))
    for name, r in rows.items():
        r["tflops"] = flops / r["ms"] / 1e9
        print(f"{name:>24}: {r['ms']:8.3f} ms, {r['tflops']:6.1f} TFLOP/s, upper tiles "
              f"{r['gram_rel_err']:.2e} of the sums' scale")
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, shape=dict(c=C, d1=D1, k=K), variants=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
