"""The Gramian kernels' row chunks (``csrc/gram_tile.cuh``) measured on one GPU.

    python3 scripts/torch_gram_chunks.py [--parent DIR] [--out FILE]

Builds variants of ``gram_tile.cuh`` that differ from it in the length of
its row chunks (``CHUNK``, the Gramian's; ``CORR_CHUNK``, the
correlation's) or in how a chunk's sums join the output tile (``red``:
``atomicAdd`` instead of a read and a write), beside the as-built header;
with ``--parent DIR`` also the header and ``fma_pipe.cuh`` of another
checkout (its Gramian kernels, e.g. the parent commit's, unpacked with
``git archive <commit> keystone_tpu_torch | tar -x -C DIR``). Each variant
is built by ``scripts/torch_fma_variants.py``'s ``build`` (one ``nvcc`` a
variant, all started together) and timed by its rows at the main path's
shapes (``gram_corr``: A 65,536 x 4,096, R 65,536 x 147;
``gram_corr_sym_acc``: one Amazon chunk; ``block_gram_sym`` and
``gram_sym_acc`` where ``--kernels`` names them). Then each ``gram_corr``
variant's Gramian and correlation are read against float64 sums made on
the card, as max |err| / max |f64|, beside cuBLAS's FP32 ones, on two
operands: a 589,824 x 4,096 slab of cosine features (``chip_smoke.py``
12(d)'s), MNIST's fit (the centred 60,000 x 2,048 packed-FFT features
of ``synthetic_mnist`` against the centred labels, k = 10) and, with
``--voc``, the blocks of VOCSIFTFisher's fit (``chip_smoke.py`` phase 15:
the centred 5,011 x 4,096 blocks of its 40,960 Fisher-vector features
against the centred labels, k = 20); there the weights each variant's
sums give (a float64 solve of them, with VOC's λ = 0.5 for VOC) are read
against the float64 sums' weights too. Prints a line a reading and writes
them all to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "scripts"))

import torch_fma_variants as tv  # noqa: E402

from keystone_tpu_torch.ops import cuda_ops  # noqa: E402

G, P = "gram_tile.cuh", "fma_pipe.cuh"
CHUNK, CORR = "constexpr int CHUNK = 2048;", "constexpr int CORR_CHUNK = 256;"
ADD = "if (c < cols) out[r * ldo + c] += acc[i][j];"


def chunks(gram=None, corr=None):
    """Edits of gram_tile.cuh to other chunk lengths."""
    edits = []
    if gram:
        edits.append((G, CHUNK, f"constexpr int CHUNK = {gram};"))
    if corr:
        edits.append((G, CORR, f"constexpr int CORR_CHUNK = {corr};"))
    return tuple(edits)


VARIANTS = [
    ("as built", ()),
    ("Gramian 8192, correlation 1024", chunks(8192, 1024)),
    ("Gramian 1024, correlation 256", chunks(1024)),
    ("Gramian 4096, correlation 256", chunks(4096)),
    ("Gramian 2048, correlation 512", chunks(corr=512)),
    ("Gramian 2048, correlation 1024", chunks(corr=1024)),
    ("Gramian 8192, correlation 256", chunks(8192)),
    ("red", ((G, ADD, "if (c < cols) atomicAdd(out + r * ldo + c, acc[i][j]);"),)),
]


def rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def cosine_slab(n=589824, b=4096, k=147):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    X = torch.randn((n, 440), generator=gen, device=dev) * 0.6
    W = torch.randn((b, 440), generator=gen, device=dev) * 0.05555
    bias = torch.rand((b,), generator=gen, device=dev) * 6.283185307179586
    F = cuda_ops.cosine_features(X, W, bias)
    del X
    return F, torch.randn((n, k), generator=gen, device=dev)


def mnist_fit_operands():
    from keystone_tpu_torch.data.loaders import synthetic_mnist
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.pipelines import mnist_random_fft as mnist

    config = mnist.MnistRandomFFTConfig(synthetic_n=60000)
    train = synthetic_mnist(60000, seed=0, device="cuda")
    A = mnist.build_featurizer(config, "cuda").apply(train.data).get().array
    R = ClassLabelIndicatorsFromIntLabels(10)(train.labels).array
    return A - A.mean(dim=0), R - R.mean(dim=0)


def voc_fit_operands():
    """The centred blocks of VOCSIFTFisher's features at chip_smoke.py
    phase 15's size, and the centred labels."""
    import chip_smoke
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.pipelines import voc_sift_fisher as voc

    seen = []
    fit = BlockLeastSquaresEstimator.fit
    BlockLeastSquaresEstimator.fit = lambda self, data, labels: seen.append(
        (data.array, labels.array)) or fit(self, data, labels)
    try:
        voc.run(voc.VOCConfig(lam=chip_smoke.VOC_LAM, descriptor_dim=chip_smoke.VOC_DESC,
                              vocab_size=chip_smoke.VOC_VOCAB, block_size=chip_smoke.VOC_BLOCK,
                              synthetic_n=chip_smoke.VOC_N, synthetic_test_n=chip_smoke.VOC_TEST,
                              synthetic_image_size=chip_smoke.VOC_SIZE))
    finally:
        BlockLeastSquaresEstimator.fit = fit
    (F, Y), = seen
    b = chip_smoke.VOC_BLOCK
    blocks = [(F[:, s:s + b] - F[:, s:s + b].mean(dim=0)).contiguous()
              for s in range(0, F.shape[1], b)]
    return blocks, Y - Y.mean(dim=0)


def voc_times(libs, stream, A, R):
    """Median ms of each gram_corr variant's launch, and of cuBLAS's
    ``A.T @ A``, ``A.T @ R``, on one VOC block (10 launches after one)."""
    n, b = A.shape
    k = R.shape[1]
    G = torch.empty((b, b), device=A.device)
    C = torch.empty((b, k), device=A.device)
    runs = {"cuBLAS": lambda: (A.T @ A, A.T @ R)}
    for (kernel, name), lib in libs.items():
        if kernel == "gram_corr":
            runs[name] = (lambda lib=lib: lib.kt_gram_corr(
                A.data_ptr(), R.data_ptr(), G.data_ptr(), C.data_ptr(), n, b, k, A.stride(0),
                R.stride(0), 0, stream))
    out = {}
    for name, fn in runs.items():
        fn()
        times = []
        for _ in range(10):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = sorted(times)[5]
    return out


def f64_readings(libs, stream, A, R, weights, lam=0.0):
    """Each gram_corr variant's and cuBLAS's sums of (A, R) against float64;
    with ``weights`` also the weights of (G + λI) W = C."""
    n, b = A.shape
    k = R.shape[1]
    g64 = torch.zeros((b, b), dtype=torch.float64, device=A.device)
    c64 = torch.zeros((b, k), dtype=torch.float64, device=A.device)
    for s in range(0, n, 65536):
        Ac = A[s:s + 65536].double()
        g64.addmm_(Ac.T, Ac)
        c64.addmm_(Ac.T, R[s:s + 65536].double())
    del Ac
    eye = lam * torch.eye(b, dtype=torch.float64, device=A.device)
    W64 = torch.linalg.solve(g64 + eye, c64) if weights else None
    sums = {"cuBLAS": (A.T @ A, A.T @ R)}
    for (kernel, name), lib in libs.items():
        if kernel == "gram_corr":
            G = torch.empty((b, b), device=A.device)
            C = torch.empty((b, k), device=A.device)
            err = lib.kt_gram_corr(A.data_ptr(), R.data_ptr(), G.data_ptr(), C.data_ptr(), n,
                                   b, k, A.stride(0), R.stride(0), 0, stream)
            if err:
                raise RuntimeError(f"gram_corr {name}: launch failed ({err})")
            sums[name] = (G, C)
    torch.cuda.synchronize()
    out = {}
    for name, (G, C) in sums.items():
        r = dict(gram=rel(G, g64), corr=rel(C, c64))
        if weights:
            W = torch.linalg.solve(G.double() + eye, C.double())
            r["weights"] = ((W - W64).norm() / W64.norm()).item()
        out[name] = r
    for name, r in out.items():
        r["gram_over_cublas"] = r["gram"] / out["cuBLAS"]["gram"]
        r["corr_over_cublas"] = r["corr"] / out["cuBLAS"]["corr"]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose Gramian headers to build beside")
    parser.add_argument("--out", default="build/torch_gram_chunks.json")
    parser.add_argument("--kernels", nargs="+", default=["gram_corr", "gram_corr_sym_acc"])
    parser.add_argument("--variants", nargs="+", help="build only these (default: all)")
    parser.add_argument("--voc", action="store_true",
                        help="also read VOCSIFTFisher's fit blocks against float64")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gram_chunks: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    variants = [v for v in VARIANTS if not args.variants or v[0] in args.variants]
    if args.parent:
        here = {h: (cuda_ops._CSRC / h).read_text() for h in (G, P)}
        there = os.path.join(args.parent, "keystone_tpu_torch", "csrc")
        variants.append(("parent", tuple(
            (h, here[h], open(os.path.join(there, h)).read()) for h in (G, P))))
    tv.VARIANTS = [(k, name, edits) for k in args.kernels for name, edits in variants]
    libs = tv.build(cuda_ops, args.kernels)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = dict(card=card, time={})
    for kernel in args.kernels:
        rows = result["time"][kernel] = tv.ROWS[kernel](cuda_ops, libs, stream, sms)
        for name, r in rows.items():
            extra = {key: r[key] for key in ("registers", "local_bytes") if key in r}
            print(f"{kernel} {name}: {r['ms']:.3f} ms {extra}", flush=True)
    if "gram_corr" in args.kernels:
        for label, make, weights in (("cosine 589,824 x 4,096", cosine_slab, False),
                                     ("MNIST fit 60,000 x 2,048, k = 10", mnist_fit_operands,
                                      True)):
            A, R = make()
            readings = result[label] = f64_readings(libs, stream, A, R, weights)
            del A, R
            torch.cuda.empty_cache()
            for name, r in readings.items():
                print(f"float64, {label}: {name}: Gramian {r['gram']:.3e} "
                      f"({r['gram_over_cublas']:.3f}x cuBLAS), correlation {r['corr']:.3e} "
                      f"({r['corr_over_cublas']:.3f}x cuBLAS)"
                      + (f", weights {r['weights']:.3e}" if weights else ""), flush=True)
    if "gram_corr" in args.kernels and args.voc:
        import chip_smoke

        blocks, R = voc_fit_operands()
        per_block = [f64_readings(libs, stream, A, R, True, chip_smoke.VOC_LAM) for A in blocks]
        result["VOC fit blocks"] = per_block
        times = result["VOC block ms"] = voc_times(libs, stream, blocks[0], R)
        for name, ms in times.items():
            print(f"VOC block 5,011 x 4,096, k = 20: {name}: {ms:.3f} ms", flush=True)
        for name in per_block[0]:
            worst = {key: max(r[name][key] for r in per_block)
                     for key in ("gram", "corr", "weights", "gram_over_cublas",
                                 "corr_over_cublas")}
            w_ratio = max(r[name]["weights"] / r["cuBLAS"]["weights"] for r in per_block)
            print(f"float64, VOC's 10 blocks of 5,011 x 4,096, k = 20 (worst block): {name}: "
                  f"Gramian {worst['gram']:.3e} ({worst['gram_over_cublas']:.3f}x cuBLAS), "
                  f"correlation {worst['corr']:.3e} ({worst['corr_over_cublas']:.3f}x cuBLAS), "
                  f"ridge weights {worst['weights']:.3e} ({w_ratio:.3f}x cuBLAS's)", flush=True)
    print(card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
