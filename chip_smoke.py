"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's TIMIT and CIFAR paths from
``keystone_tpu_torch/csrc/`` (one ``nvcc`` per source, all started
together), then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the TIMIT and CIFAR slices give it, with float32 and (except the
     convolution) bfloat16 operands, and times the kernel, the plain version
     and a PyTorch library yardstick that computes the same function;
  2. checks that a small run of the three TIMIT routes on the card agrees
     with the plain-PyTorch run of it on the CPU, then drives the
     ``--solver block`` slice end to end through its entry point,
     ``keystone_tpu_torch.pipelines.timit.run``, at the full width of the
     reference's bench headline (440 inputs, 4 x 4096 cosine features,
     147 classes, 65,536 training rows, 3 epochs) by both routes, each with
     every kernel's launch count set to 0 just before and read just after:
       - the stacked route (``fit_first=False``: apply before fit, as the
         reference's ``run`` does), through ``cosine_features`` and
         ``gram_corr_sym``;
       - the fused flat route (``pipeline.fit()`` first), through
         ``cosine_features``, ``block_gram_sym``, ``block_corr`` and
         ``block_residual_update``;
  3. fits and applies the README quick-start composition (one 440 -> 4096
     cosine featurizer, block least squares with block 1024, 3 iterations,
     λ 1e-4, then MaxClassifier) on the same rows, through the fused fit;
  4. drives ``--solver streaming`` at the same width on 275,000 training
     rows (8 full row tiles of 32,768 and a ragged one), launches counted
     from 0: the tile fold through ``gram_sym_acc`` and the tile-wise
     featurizer through ``cosine_features``;
  5. fits and applies the optimizer-bound streamed fit (the TIMIT
     featurizer composed with ``StreamingLeastSquaresChoice``, which
     ``StreamedFitFusionRule`` binds into the fit) on 65,536 rows, and
     holds its errors against ``--solver streaming`` on the same rows;
  6. runs RandomPatchCifarKernel small on the card against its plain run on
     the CPU (equal errors), then through its entry point
     ``keystone_tpu_torch.pipelines.cifar.run_random_patch_cifar_kernel``
     at full width: 50,000 synthetic training and 12,500 test images, 100
     whitened 6 x 6 x 3 filters, rectifier and pool to 1,800 features,
     Gaussian kernel ridge regression with block 512 (98 blocks, the last
     one 336 rows), 1 epoch; launches counted from 0 and checked against
     their expected counts: ``conv_featurize`` once per row chunk of each
     featurization, ``gaussian_kernel_block`` once per block in the
     diagonal pre-pass and in each apply, ``gaussian_resid_block`` once
     per sweep step, every TIMIT kernel 0;
  7. measures where that fit's time goes: its Gauss-Seidel sweep with and
     without the per-step host sync of the solve's rescue decision, and a
     warm fit and apply under ``torch.profiler`` (device time by name, the
     device's busy share).

Prints the card's name and power limit, one JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``. Any failed phase
raises and the script exits non-zero without that line. It needs one CUDA
device and exits non-zero without one.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): float32 outside
# the tensor cores, bf16 tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The TIMIT slice at the bench headline's width.
N_TRAIN, D_IN, BLOCK, NUM_COSINES, K, EPOCHS = 65536, 440, 4096, 4, 147, 3

# The README quick start: one 440 -> 4096 cosine featurizer, block 1024.
QS_WIDTH, QS_BLOCK = 4096, 1024

# The window the column-window kernels are checked on: F as wide as the
# slice's features, the third of its four blocks.
D_FEAT, COL_START = NUM_COSINES * BLOCK, 2 * BLOCK

# The streamed route: 275,000 training rows, tiles of 32,768 rows
# (pick_tile_rows(16384)): 8 full tiles and a ragged 12,856-row one.
STREAM_N, STREAM_TILE = 275000, 32768

# The CIFAR slice at its own width (keystone_tpu/pipelines/cifar.py): 50,000
# training and 12,500 test images of 32 x 32 x 3, 100 filters of 6 x 6 x 3
# (d = 108), 27 x 27 outputs, 2 x 100 rectified channels pooled 3 x 3:
# 1,800 features; 10 classes; KRR block 512, 1 epoch.
CIFAR_N, CIFAR_TEST, CIFAR_FILTERS, CIFAR_D, CIFAR_K = 50000, 12500, 100, 1800, 10
CIFAR_BLOCK, CIFAR_GAMMA = 512, 5e-4
CIFAR_BLOCKS = -(-CIFAR_N // CIFAR_BLOCK)  # 98: 97 full and one of 336 rows
# Bytes per image of the fused featurizer's input and intermediates
# (images, convolution, rectifier, pool, vector), which size its row chunks.
CONV_ROW_BYTES = 4 * (32 * 32 * 3 + 27 * 27 * 100 + 27 * 27 * 200 + 2 * 3 * 3 * 200)

# Each kernel, and the main-path route whose launches the JSON line reports.
FLAT, STACKED = "timit fused flat fit (fit first)", "timit stacked fit (apply first)"
STREAMED = "timit streamed fit (--solver streaming)"
CIFAR = "cifar RandomPatchCifarKernel (fit, then train and test apply)"
KERNELS = {
    "cosine_features": dict(
        source="keystone_tpu_torch/csrc/cosine_features.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:391", path=FLAT,
    ),
    "gram_corr_sym": dict(
        source="keystone_tpu_torch/csrc/gram_corr_sym.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:589", path=STACKED,
    ),
    "block_gram_sym": dict(
        source="keystone_tpu_torch/csrc/block_gram_sym.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:704", path=FLAT,
    ),
    "block_corr": dict(
        source="keystone_tpu_torch/csrc/block_corr.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:978", path=FLAT,
    ),
    "block_residual_update": dict(
        source="keystone_tpu_torch/csrc/block_residual_update.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:1030", path=FLAT,
    ),
    "gram_sym_acc": dict(
        source="keystone_tpu_torch/csrc/gram_sym_acc.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:769", path=STREAMED,
    ),
    "gaussian_kernel_block": dict(
        source="keystone_tpu_torch/csrc/gaussian_kernel_block.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:164", path=CIFAR,
    ),
    "gaussian_resid_block": dict(
        source="keystone_tpu_torch/csrc/gaussian_resid_block.cu",
        replaces="keystone_tpu/ops/pallas_ops.py:266", path=CIFAR,
    ),
    "conv_featurize": dict(
        source="keystone_tpu_torch/csrc/conv_featurize.cu",
        replaces="keystone_tpu/ops/pallas_images.py:118", path=CIFAR,
    ),
}
# Launches of the flat route: 4 blocks, 3 epochs, Gramians stashed after
# the first epoch; 4 cosine branches in the fit and in each of two applies.
FLAT_LAUNCHES = {
    "cosine_features": 3 * NUM_COSINES, "gram_corr_sym": 0,
    "block_gram_sym": D_FEAT // BLOCK, "block_corr": EPOCHS * D_FEAT // BLOCK,
    "block_residual_update": EPOCHS * D_FEAT // BLOCK, "gram_sym_acc": 0,
    "gaussian_kernel_block": 0, "gaussian_resid_block": 0, "conv_featurize": 0,
}
# Launches of the streamed route: one fold per row tile (9), one cosine bank
# launch per tile in the fit (9), the train apply (9) and the test apply of
# 68,750 rows (3).
STREAM_TILES = -(-STREAM_N // STREAM_TILE)
STREAMED_LAUNCHES = {
    "cosine_features": 2 * STREAM_TILES + -(-(STREAM_N // 4) // STREAM_TILE),
    "gram_corr_sym": 0, "block_gram_sym": 0, "block_corr": 0, "block_residual_update": 0,
    "gram_sym_acc": STREAM_TILES, "gaussian_kernel_block": 0, "gaussian_resid_block": 0,
    "conv_featurize": 0,
}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
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


def bound_ms(nbytes, flops, peak_flops):
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / peak_flops * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def check(name, ok, detail):
    log(f"  {'PASS' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def phase_kernels(cuda_ops):
    """Each kernel against its plain version at the slice's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # cosine_features: one branch of the training featurization.
    m, d, n = N_TRAIN, D_IN, BLOCK
    X = torch.randn((m, d), generator=gen, device=dev) * 0.6
    W = torch.randn((n, d), generator=gen, device=dev) * 0.05555
    b = torch.rand((n,), generator=gen, device=dev) * 6.283185307179586
    for label, compute, out, tol in (
        ("f32", torch.float32, torch.float32, 1e-5),
        ("bf16 operands", torch.bfloat16, torch.float32, 1e-5),
        ("bf16 output", torch.float32, torch.bfloat16, 2.0 ** -7),
    ):
        got = cuda_ops.cosine_features(X, W, b, compute_dtype=compute, out_dtype=out)
        want = cuda_ops.cosine_features_ref(X, W, b, compute, out)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(f"cosine_features {label} {m}x{d} @ {n}x{d}", err <= tol,
              f"max_abs_err {err:.3e} (tol {tol:.1e})")
        if label == "f32":
            results["cosine_features"] = dict(max_abs_err=err)
        del got, want
    nbytes = 4 * (m * d + n * d + n + m * n)
    flops = 2 * m * n * d + 16 * m * n  # GEMM + bias add, range reduction, polynomial
    r = results["cosine_features"]
    r["ms"] = time_ms(lambda: cuda_ops.cosine_features(X, W, b), 10)
    r["plain_ms"] = time_ms(lambda: cuda_ops.cosine_features_ref(X, W, b), 10)
    r["library_ms"] = time_ms(lambda: torch.cos(torch.addmm(b, X, W.T)), 10)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    X16, W16 = X.to(torch.bfloat16), W.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: cuda_ops.cosine_features(X16, W16, b), 5)
    bf16_bound, _ = bound_ms(2 * (m * d + n * d) + 4 * (n + m * n), flops, PEAK_BF16_FLOPS)
    log(f"  cosine_features f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 operands: {bf16_ms:.3f} ms (bound {bf16_bound:.3f})")

    # gram_corr_sym: one centered 4096-wide feature block and the residual.
    A = cuda_ops.cosine_features(X, W, b)
    A -= A.mean(dim=0)
    labels = torch.randint(0, K, (m,), generator=gen, device=dev)
    R = 2.0 * torch.nn.functional.one_hot(labels, K).float() - 1.0
    R -= R.mean(dim=0)
    del X, W, X16, W16
    d, k = BLOCK, K
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ak = A.to(dtype)
        gram, corr = cuda_ops.gram_corr_sym(Ak, R)
        gram_r, corr_r = cuda_ops.gram_corr_sym_ref(Ak, R)
        torch.cuda.synchronize()
        g_err = (gram - gram_r).abs().max().item()
        c_err = (corr - corr_r).abs().max().item()
        # Errors relative to the scale of the sums, max over entries of
        # sum_r |a_ri| |y_rj|: the centered entries cancel, so their own
        # size says nothing of the rounding. For the Gramian that scale is
        # its largest diagonal entry. Two f32 sums of 65,536 terms in
        # different orders differ by about sqrt(n) * 2^-24 of it.
        g_rel = g_err / gram_r.diagonal().max().item()
        c_rel = c_err / (Ak.float().abs().T @ R.abs()).max().item()
        check(f"gram_corr_sym {label} A {m}x{d}, R {m}x{k}",
              g_rel <= 1e-4 and c_rel <= 1e-4 and torch.equal(gram, gram.T),
              f"gram max_abs_err {g_err:.3e} ({g_rel:.2e} of scale), corr max_abs_err "
              f"{c_err:.3e} ({c_rel:.2e} of scale), tol 1e-4 of scale, symmetric")
        if label == "f32":
            results["gram_corr_sym"] = dict(max_abs_err=max(g_err, c_err))
        del Ak, gram, corr, gram_r, corr_r
    nbytes = 4 * (m * d + m * k + d * d + d * k)
    flops = m * d * (d + 1) + 2 * m * d * k  # upper triangle (syrk) + correlation
    r = results["gram_corr_sym"]
    r["ms"] = time_ms(lambda: cuda_ops.gram_corr_sym(A, R), 5)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_corr_sym_ref(A, R), 5)
    r["library_ms"] = time_ms(lambda: (A.T @ A, A.T @ R), 5)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    A16 = A.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: cuda_ops.gram_corr_sym(A16, R), 3)
    bf16_bound, _ = bound_ms(2 * m * d + 4 * (m * k + d * d + d * k), flops, PEAK_BF16_FLOPS)
    log(f"  gram_corr_sym f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 operands: {bf16_ms:.3f} ms (bound {bf16_bound:.3f})")
    del A, A16, R
    torch.cuda.empty_cache()
    results.update(phase_window_kernels(cuda_ops, gen))
    results.update(phase_gram_sym_acc(cuda_ops, gen))
    return results


def phase_window_kernels(cuda_ops, gen):
    """The flat solver's column-window kernels on one window of a
    full-width feature matrix, F 65,536 x 16,384 at column 8,192."""
    dev = torch.device("cuda")
    n, d, s, b, k = N_TRAIN, D_FEAT, COL_START, BLOCK, K
    F = torch.randn((n, d), generator=gen, device=dev)
    R = torch.randn((n, k), generator=gen, device=dev)
    dW = torch.randn((b, k), generator=gen, device=dev) * 0.01
    results = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Fk = F.to(dtype)
        Fw = Fk[:, s:s + b].float()
        # Errors relative to the scale of the sums, max over entries of
        # sum |f||r| (for the Gramian its largest diagonal entry): sums of
        # 65,536 (Gramian, correlation) or 4,096 (residual) float32 terms in
        # different orders differ by about sqrt(terms) * 2^-24 of it.
        checks = {
            "block_gram_sym": (
                cuda_ops.block_gram_sym(Fk, s, b), cuda_ops.block_gram_sym_ref(Fk, s, b),
                lambda want: want.diagonal().max().item(),
            ),
            "block_corr": (
                cuda_ops.block_corr(Fk, s, b, R), cuda_ops.block_corr_ref(Fk, s, b, R),
                lambda want: (Fw.abs().T @ R.abs()).max().item(),
            ),
            "block_residual_update": (
                cuda_ops.block_residual_update(Fk, s, b, dW, R),
                cuda_ops.block_residual_update_ref(Fk, s, b, dW, R),
                lambda want: (R.abs() + Fw.abs() @ dW.to(dtype).float().abs()).max().item(),
            ),
        }
        torch.cuda.synchronize()
        for name, (got, want, scale) in checks.items():
            err = (got - want).abs().max().item()
            rel = err / scale(want)
            ok = rel <= 1e-4 and (name != "block_gram_sym" or torch.equal(got, got.T))
            check(f"{name} {label} F {n}x{d}, window [{s}, {s + b}), k {k}", ok,
                  f"max_abs_err {err:.3e} ({rel:.2e} of scale), tol 1e-4 of scale"
                  + (", symmetric" if name == "block_gram_sym" else ""))
            if label == "f32":
                results[name] = dict(max_abs_err=err)
        del Fk, Fw, checks
    Fw = F[:, s:s + b]
    yardsticks = {
        # (kernel, plain, library call, bytes, flops)
        "block_gram_sym": (
            lambda: cuda_ops.block_gram_sym(F, s, b),
            lambda: cuda_ops.block_gram_sym_ref(F, s, b),
            lambda: Fw.T @ Fw,
            4 * (n * b + b * b), n * b * (b + 1),
        ),
        "block_corr": (
            lambda: cuda_ops.block_corr(F, s, b, R),
            lambda: cuda_ops.block_corr_ref(F, s, b, R),
            lambda: Fw.T @ R,
            4 * (n * b + n * k + b * k), 2 * n * b * k,
        ),
        "block_residual_update": (
            lambda: cuda_ops.block_residual_update(F, s, b, dW, R),
            lambda: cuda_ops.block_residual_update_ref(F, s, b, dW, R),
            lambda: torch.addmm(R, Fw, dW, alpha=-1),
            4 * (n * b + b * k + 2 * n * k), 2 * n * b * k,
        ),
    }
    F16 = F.to(torch.bfloat16)
    bf16_calls = {
        "block_gram_sym": lambda: cuda_ops.block_gram_sym(F16, s, b),
        "block_corr": lambda: cuda_ops.block_corr(F16, s, b, R),
        "block_residual_update": lambda: cuda_ops.block_residual_update(F16, s, b, dW, R),
    }
    for name, (kernel, plain, library, nbytes, flops) in yardsticks.items():
        r = results[name]
        r["ms"] = time_ms(kernel, 5)
        r["plain_ms"] = time_ms(plain, 5)
        r["library_ms"] = time_ms(library, 5)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        bf16_ms = time_ms(bf16_calls[name], 3)
        log(f"  {name} f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
            f"bf16 F: {bf16_ms:.3f} ms")
    del F, F16, Fw, R, dW
    torch.cuda.empty_cache()
    return results


def phase_gram_sym_acc(cuda_ops, gen):
    """The streamed fold's kernel on one full row tile of the streamed fit:
    F 32,768 x 16,384, a random G0, in place and into a new buffer."""
    dev = torch.device("cuda")
    n, d = STREAM_TILE, D_FEAT
    F = torch.randn((n, d), generator=gen, device=dev)
    G0 = torch.randn((d, d), generator=gen, device=dev)
    tiles = torch.arange(d, device=dev) // 128
    upper = tiles[:, None] <= tiles[None, :]
    results = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Fk = F.to(dtype)
        want = cuda_ops.gram_sym_acc_ref(G0, Fk)
        Ff = Fk.float()
        # Errors relative to the scale of the sums, |G0| + sum |f_i||f_j|: two
        # f32 sums of 32,768 terms in different orders differ by about
        # sqrt(n) * 2^-24 of it.
        scale = torch.addmm(G0.abs(), Ff.abs().T, Ff.abs())
        del Ff
        G = G0.clone()
        for how, got in (("new buffer", cuda_ops.gram_sym_acc(G0, Fk)),
                         ("in place", cuda_ops.gram_sym_acc(G, Fk, out=G))):
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff[upper].max().item()
            rel = (diff / scale)[upper].max().item()
            ok = rel <= 1e-4 and (how == "new buffer" or torch.equal(G[~upper], G0[~upper]))
            check(f"gram_sym_acc {label} {how}, G0 {d}x{d}, F {n}x{d}", ok,
                  f"upper tiles max_abs_err {err:.3e} ({rel:.2e} of scale), tol 1e-4 of "
                  f"scale" + (", lower tiles untouched" if how == "in place" else ""))
            if label == "f32" and how == "in place":
                results["gram_sym_acc"] = dict(max_abs_err=err)
            del diff, got
        del Fk, want, scale, G
    G = G0.clone()
    r = results["gram_sym_acc"]
    r["ms"] = time_ms(lambda: cuda_ops.gram_sym_acc(G, F, out=G), 5)
    r["plain_ms"] = time_ms(lambda: cuda_ops.gram_sym_acc_ref(G0, F), 5)
    r["library_ms"] = time_ms(lambda: torch.addmm(G0, F.T, F), 5)
    flops = n * d * (d + 1)  # the upper triangle (syrk)
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (n * d + 2 * d * d), flops, PEAK_F32_FLOPS)
    F16 = F.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: cuda_ops.gram_sym_acc(G, F16, out=G), 3)
    bf16_bound, _ = bound_ms(2 * n * d + 8 * d * d, flops, PEAK_BF16_FLOPS)
    log(f"  gram_sym_acc f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
        f"bf16 F: {bf16_ms:.3f} ms (bound {bf16_bound:.3f})")
    del F, F16, G, G0, upper
    torch.cuda.empty_cache()
    return results


def phase_small_reference(timit, TimitConfig):
    """The three routes at a small size on the card (kernels) and on the
    CPU (plain versions), same data and weights: errors must agree."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import PipelineEnv

    for solver, fit_first, route in (("block", True, FLAT), ("block", False, STACKED),
                                     ("streaming", True, STREAMED)):
        config = TimitConfig(solver=solver, num_cosines=2, block_size=256, synthetic_n=2048,
                             num_epochs=2)
        runs = {}
        for device in ("cuda", "cpu"):
            PipelineEnv.get_or_create().reset()
            models = [
                CosineRandomFeatures(D_IN, config.block_size, config.gamma,
                                     seed=config.seed + i, device=device)
                for i in range(config.num_cosines)
            ]
            runs[device] = timit.run(config, device=device, cosine_models=models,
                                     fit_first=fit_first)
        PipelineEnv.get_or_create().reset()
        errs = {dev: (r.train_eval.total_error, r.test_eval.total_error)
                for dev, r in runs.items()}
        same = all(abs(a - b) <= 0.005 for a, b in zip(errs["cuda"], errs["cpu"]))
        check(f"small {route}, card against CPU plain versions", same,
              f"train/test error cuda {errs['cuda']}, cpu {errs['cpu']} (within 0.5 points)")


def check_metrics(what, train_eval, test_eval, n_train):
    train_err, test_err = train_eval.total_error, test_eval.total_error
    check(f"{what} metrics", all(0.0 <= e <= 1.0 for e in (train_err, test_err))
          and test_err < 0.5 and train_eval.total == n_train
          and test_eval.total == n_train // 4,
          f"errors in [0, 1], test error below 50% (chance is {100 * (K - 1) / K:.1f}%), "
          f"every row scored")


def phase_timit_route(cuda_ops, timit, TimitConfig, fit_first):
    """One TIMIT route at full width, launches counted from 0."""
    from keystone_tpu_torch.workflow import PipelineEnv

    route = FLAT if fit_first else STACKED
    PipelineEnv.get_or_create().reset()
    config = TimitConfig(num_cosines=NUM_COSINES, block_size=BLOCK, synthetic_n=N_TRAIN,
                         num_epochs=EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = timit.run(config, device="cuda", fit_first=fit_first)
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    fit_what = "fit" if fit_first else "fit + train apply"
    apply_what = "apply (train + test)" if fit_first else "test apply"
    log(f"  {route}, n={N_TRAIN}, d={D_FEAT}, k={K}, block {BLOCK}, {EPOCHS} epochs: "
        f"train error {100 * train_err:.3f}%, test error {100 * test_err:.3f}%, "
        f"{fit_what} {result.fit_seconds:.3f} s, {apply_what} {result.apply_seconds:.3f} s, "
        f"run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    if fit_first:
        check(f"{route} launches", counts == FLAT_LAUNCHES,
              f"{counts}, expected {FLAT_LAUNCHES}")
    else:
        ok = counts["gram_corr_sym"] > 0 and counts["cosine_features"] > 0
        check(f"{route} launches", ok, f"gram_corr_sym {counts['gram_corr_sym']}, "
              f"cosine_features {counts['cosine_features']}, both > 0")
    check_metrics(route, result.train_eval, result.test_eval, N_TRAIN)
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err,
                        test_error=test_err)


def phase_quickstart(cuda_ops):
    """The README quick-start composition on the slice's rows."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    train = synthetic_timit(N_TRAIN, seed=123, device="cuda")
    test = synthetic_timit(N_TRAIN // 4, seed=124, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline = (
        CosineRandomFeatures(D_IN, QS_WIDTH, gamma=0.05, seed=7, device="cuda")
        .and_then(BlockLeastSquaresEstimator(block_size=QS_BLOCK, num_iter=3, lam=1e-4),
                  train.data, labels)
        .and_then(MaxClassifier())
    )
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_pred, test_pred = fitted.apply(train.data), fitted.apply(test.data)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    evaluator = MulticlassClassifierEvaluator(K)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    PipelineEnv.get_or_create().reset()
    log(f"  quick start, n={N_TRAIN}, 440 -> {QS_WIDTH} cosines, block {QS_BLOCK}, 3 iterations: "
        f"train error {100 * train_eval.total_error:.3f}%, test error "
        f"{100 * test_eval.total_error:.3f}%, fit {fit_s:.3f} s, apply {apply_s:.3f} s, "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts}")
    check("quick start went through the fused fit",
          all(counts[name] > 0 for name in ("block_gram_sym", "block_corr",
                                            "block_residual_update", "cosine_features"))
          and counts["gram_corr_sym"] == 0, f"launches {counts}")
    check_metrics("quick start", train_eval, test_eval, N_TRAIN)


def phase_streamed(cuda_ops, timit, TimitConfig):
    """--solver streaming at full width on 275,000 rows, launches counted
    from 0."""
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    config = TimitConfig(solver="streaming", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=STREAM_N, num_epochs=EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = timit.run(config, device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    log(f"  {STREAMED}, n={STREAM_N}, d={D_FEAT}, k={K}, block {BLOCK}, tile {STREAM_TILE}, "
        f"{EPOCHS} epochs: train error {100 * train_err:.3f}%, test error "
        f"{100 * test_err:.3f}%, fit {result.fit_seconds:.3f} s, apply (train + test) "
        f"{result.apply_seconds:.3f} s, run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    check(f"{STREAMED} launches", counts == STREAMED_LAUNCHES,
          f"{counts}, expected {STREAMED_LAUNCHES}")
    check_metrics(STREAMED, result.train_eval, result.test_eval, STREAM_N)
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err, test_error=test_err)


def phase_optimizer_bound(cuda_ops, timit, TimitConfig):
    """The TIMIT featurizer composed with StreamingLeastSquaresChoice: the
    optimizer binds the featurizer into a streamed fit. Held against
    --solver streaming on the same rows and draws."""
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.streaming_ls import (
        StreamingFeaturizedLinearModel,
        StreamingLeastSquaresChoice,
    )
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.workflow import DefaultOptimizer, PipelineEnv

    config = TimitConfig(solver="streaming", num_cosines=NUM_COSINES, block_size=BLOCK,
                         synthetic_n=N_TRAIN, num_epochs=EPOCHS)
    PipelineEnv.get_or_create().reset()
    flag = timit.run(config, device="cuda")
    PipelineEnv.get_or_create().reset()
    train = synthetic_timit(N_TRAIN, seed=config.seed, device="cuda")
    test = synthetic_timit(N_TRAIN // 4, seed=config.seed + 1, device="cuda")
    labels = ClassLabelIndicatorsFromIntLabels(K)(train.labels)
    pipeline = timit.build_featurizer(config, "cuda").and_then(
        StreamingLeastSquaresChoice(num_iter=EPOCHS, lam=0.0, block_size_hint=BLOCK),
        train.data, labels,
    ).and_then(MaxClassifier())
    plan, _ = DefaultOptimizer().execute(pipeline.executor.graph, {})
    streamed = [op.label for op in plan.operators.values() if op.label.startswith("StreamedFit[")]
    check("optimizer binds the featurizer into a streamed fit", len(streamed) == 1,
          f"plan labels {sorted(op.label for op in plan.operators.values())}")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_pred, test_pred = fitted.apply(train.data), fitted.apply(test.data)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    evaluator = MulticlassClassifierEvaluator(K)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    PipelineEnv.get_or_create().reset()
    errs = (train_eval.total_error, test_eval.total_error)
    flag_errs = (flag.train_eval.total_error, flag.test_eval.total_error)
    log(f"  optimizer-bound streamed fit ({streamed[0]}), n={N_TRAIN}: train error "
        f"{100 * errs[0]:.3f}%, test error {100 * errs[1]:.3f}%, fit {fit_s:.3f} s, apply "
        f"{apply_s:.3f} s, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {counts}; --solver streaming on the same rows: fit "
        f"{flag.fit_seconds:.3f} s, errors {flag_errs}")
    tiles = -(-N_TRAIN // STREAM_TILE)
    check("optimizer-bound fit went through the streamed fold",
          counts["gram_sym_acc"] == tiles and counts["cosine_features"] > 0
          and all(counts[name] == 0 for name in ("gram_corr_sym", "block_gram_sym",
                                                 "block_corr", "block_residual_update")),
          f"launches {counts}: gram_sym_acc {tiles}, cosine_features > 0, the others 0")
    check("optimizer-bound errors match --solver streaming",
          all(abs(a - b) <= 0.005 for a, b in zip(errs, flag_errs)),
          f"{errs} against {flag_errs} (within 0.5 points)")
    # The two routes fold the same bank over the same rows in the same
    # tiles: the fitted models agree to rounding.
    (got,), (want,) = (
        [op for op in f.transformer_graph.operators.values()
         if isinstance(op, StreamingFeaturizedLinearModel)]
        for f in (fitted, flag.fitted)
    )
    rel = {
        name: float((getattr(got, name) - getattr(want, name)).norm()
                    / getattr(want, name).norm())
        for name in ("W_stack", "fmean", "ymean")
    }
    log(f"  optimizer-bound model against --solver streaming, relative Frobenius: {rel}")
    check("optimizer-bound model matches --solver streaming",
          all(v <= 1e-4 for v in rel.values()), f"{rel} (each within 1e-4)")
    check_metrics("optimizer-bound streamed fit", train_eval, test_eval, N_TRAIN)


def _conv_chunk_rows(fusion):
    """Images per row chunk of the fused CIFAR featurizer (after its first,
    one-image chunk): the chunk budget over the bytes per image."""
    return fusion.CHUNK_BUDGET_BYTES // CONV_ROW_BYTES


def _conv_launches(fusion, n):
    return 1 + -(-(n - 1) // _conv_chunk_rows(fusion))


def phase_cifar_kernels(cuda_ops, cuda_images, fusion, gen):
    """The CIFAR slice's kernels at its shapes: the Gaussian kernel block of
    one train block against all 50,000 standardized training rows (the
    apply's shape; a diagonal block is timed beside it), the residual of
    one sweep step, and the convolution of one row chunk of images."""
    dev = torch.device("cuda")
    m, n, d, k, g = CIFAR_N, CIFAR_BLOCK, CIFAR_D, CIFAR_K, CIFAR_GAMMA
    X = torch.randn((m, d), generator=gen, device=dev)  # standardized features
    xn = (X * X).sum(1)
    Y, yn = X[2 * n:3 * n], xn[2 * n:3 * n]
    W = torch.randn((m, k), generator=gen, device=dev) * 0.01
    results = {}
    for label, dtype in (("f32", torch.float32), ("bf16 operands", torch.bfloat16)):
        got = cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g, compute_dtype=dtype)
        want = cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g, compute_dtype=dtype)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(f"gaussian_kernel_block {label} X {m}x{d} @ Y {n}x{d}", err <= 1e-5,
              f"max_abs_err {err:.3e} (tol 1e-5; K in [{want.min().item():.3f}, "
              f"{want.max().item():.3f}])")
        if label == "f32":
            results["gaussian_kernel_block"] = dict(max_abs_err=err)
        # Errors relative to the scale of the sums, max over entries of
        # K^T |W|: 50,000 f32 terms summed in other orders.
        got = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g, compute_dtype=dtype)
        again = cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g, compute_dtype=dtype)
        want_r = cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g, compute_dtype=dtype)
        scale = (want.T @ W.abs()).max().item()
        torch.cuda.synchronize()
        err = (got - want_r).abs().max().item()
        check(f"gaussian_resid_block {label} X {m}x{d}, Y {n}x{d}, W {m}x{k}",
              err <= 1e-4 * scale and torch.equal(got, again),
              f"max_abs_err {err:.3e} ({err / scale:.2e} of scale), tol 1e-4 of scale, "
              f"the same bits on a second call")
        if label == "f32":
            results["gaussian_resid_block"] = dict(max_abs_err=err)
        del got, again, want, want_r
    xyn = xn[:, None] + yn[None, :]
    yardsticks = {
        # (kernel, plain, library yardstick, bytes, flops)
        "gaussian_kernel_block": (
            lambda: cuda_ops.gaussian_kernel_block(X, Y, xn, yn, g),
            lambda: cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, g),
            lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_(),
            4 * (m * d + n * d + m + n + m * n), 2 * m * n * d + 6 * m * n,
        ),
        "gaussian_resid_block": (
            lambda: cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, g),
            lambda: cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, g),
            lambda: torch.addmm(xyn, X, Y.T, beta=-g, alpha=2 * g).exp_().T @ W,
            4 * (m * d + n * d + m + n + m * k + n * k), 2 * m * n * d + 6 * m * n + 2 * m * n * k,
        ),
    }
    X16, Y16 = X.to(torch.bfloat16), Y.to(torch.bfloat16)
    bf16_calls = {
        "gaussian_kernel_block": lambda: cuda_ops.gaussian_kernel_block(X16, Y16, xn, yn, g),
        "gaussian_resid_block": lambda: cuda_ops.gaussian_resid_block(X16, Y16, xn, yn, W, g),
    }
    for name, (kernel, plain, library, nbytes, flops) in yardsticks.items():
        r = results[name]
        r["ms"] = time_ms(kernel, 10)
        r["plain_ms"] = time_ms(plain, 10)
        r["library_ms"] = time_ms(library, 10)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        bf16_ms = time_ms(bf16_calls[name], 5)
        log(f"  {name} f32: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, library "
            f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}); "
            f"bf16 operands: {bf16_ms:.3f} ms")
    Xb, xb = X[:n], xn[:n]
    diag_ms = time_ms(lambda: cuda_ops.gaussian_kernel_block(Xb, Xb, xb, xb, g), 20)
    diag_bound, _ = bound_ms(4 * (n * d + n + n * n), 2 * n * n * d, PEAK_F32_FLOPS)
    log(f"  gaussian_kernel_block diagonal block {n}x{d}: {diag_ms:.3f} ms "
        f"(bound {diag_bound:.3f})")
    del X, Y, W, X16, Y16, xyn, xn, yn, Xb, xb
    torch.cuda.empty_cache()

    # conv_featurize: one row chunk of the featurization, CIFAR images
    # (pixels in [0, 255]), 100 unit filters of 6 x 6 x 3, whitening means.
    c = _conv_chunk_rows(fusion)
    p, f, dp = 6, CIFAR_FILTERS, 108
    images = torch.rand((c, 32, 32, 3), generator=gen, device=dev) * 255
    filters = torch.randn((f, dp), generator=gen, device=dev)
    filters /= filters.norm(dim=1, keepdim=True)
    means = torch.randn((dp,), generator=gen, device=dev) * 0.1

    def conv():
        return cuda_images.conv_featurize(images, filters, means, patch_size=p)

    def plain():
        return cuda_images.conv_featurize_ref(images, filters, means, patch_size=p)

    def library():  # F.unfold (NCHW im2col) + normalise + matmul
        cols = torch.nn.functional.unfold(images.permute(0, 3, 1, 2), p)  # (c, 3*36, 729)
        cols = cols.view(c, 3, p, p, -1).permute(0, 4, 2, 3, 1).reshape(c, -1, dp)
        cols = cuda_images.normalize_patch_rows(cols, 10.0) - means
        return (cols @ filters.T).view(c, 27, 27, f)

    got, want = conv(), plain()
    patches = cuda_images.normalize_patch_rows(cuda_images.im2col(images, p), 10.0) - means
    scale = (patches.abs() @ filters.abs().T).max().item()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lib_err = (library() - want).abs().max().item()
    check(f"conv_featurize f32 images {c}x32x32x3, filters {f}x{dp}",
          err <= 1e-4 * scale and lib_err <= 1e-4 * scale,
          f"max_abs_err {err:.3e} ({err / scale:.2e} of scale), tol 1e-4 of scale; "
          f"the library yardstick's {lib_err:.3e}")
    del got, want, patches
    npix = c * 27 * 27
    r = results["conv_featurize"] = dict(max_abs_err=err)
    r["ms"] = time_ms(conv, 10)
    r["plain_ms"] = time_ms(plain, 5)
    r["library_ms"] = time_ms(library, 5)
    r["bound_ms"], r["bound_by"] = bound_ms(
        4 * (c * 32 * 32 * 3 + f * dp + dp + npix * f),
        2 * npix * dp * f + 5 * npix * dp,  # filter product + patch mean, variance, scaling
        PEAK_F32_FLOPS,
    )
    log(f"  conv_featurize f32 ({c} images): {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']})")
    del images, filters, means
    torch.cuda.empty_cache()
    return results


def phase_cifar(cuda_ops, fusion):
    """RandomPatchCifarKernel: small on the card against the CPU plain run,
    then at full width through its entry point, launches counted from 0."""
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    small = cifar.CifarConfig(synthetic_n=640, num_filters=32, whitener_size=400,
                              block_size=256)
    errs = {}
    for device in ("cuda", "cpu"):
        PipelineEnv.get_or_create().reset()
        run = cifar.run_random_patch_cifar_kernel(small, device=device)
        errs[device] = (run.train_eval.total_error, run.test_eval.total_error)
    PipelineEnv.get_or_create().reset()
    check("small RandomPatchCifarKernel (640 images, 32 filters, 3 blocks), card against "
          "CPU plain versions", errs["cuda"] == errs["cpu"],
          f"train/test error cuda {errs['cuda']}, cpu {errs['cpu']} (equal)")

    config = cifar.CifarConfig(synthetic_n=CIFAR_N, num_filters=CIFAR_FILTERS,
                               block_size=CIFAR_BLOCK, kernel_gamma=CIFAR_GAMMA, num_epochs=1)
    expected = {name: 0 for name in cuda_ops.launches}
    expected.update(
        conv_featurize=2 * _conv_launches(fusion, CIFAR_N) + _conv_launches(fusion, CIFAR_TEST),
        gaussian_kernel_block=3 * CIFAR_BLOCKS,  # diagonal pre-pass, train apply, test apply
        gaussian_resid_block=CIFAR_BLOCKS,  # one per sweep step, 1 epoch
    )
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = cifar.run_random_patch_cifar_kernel(config, device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(cuda_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    PipelineEnv.get_or_create().reset()
    train_err, test_err = result.train_eval.total_error, result.test_eval.total_error
    log(f"  {CIFAR}, n={CIFAR_N}, test {CIFAR_TEST}, d={CIFAR_D}, block {CIFAR_BLOCK} "
        f"({CIFAR_BLOCKS} blocks), 1 epoch: train error {100 * train_err:.3f}%, test error "
        f"{100 * test_err:.3f}%, fit {result.fit_seconds:.3f} s, apply (train + test) "
        f"{result.apply_seconds:.3f} s, run {wall:.3f} s (data generation included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {counts}")
    check(f"{CIFAR} launches", counts == expected, f"{counts}, expected {expected}")
    check(f"{CIFAR} metrics",
          0.0 <= train_err <= 1.0 and 0.0 <= test_err < 0.9
          and result.train_eval.total == CIFAR_N and result.test_eval.total == CIFAR_TEST,
          "errors in [0, 1], test error below chance (90%), every image scored")
    return counts, dict(fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
                        peak_allocated_bytes=peak, train_error=train_err,
                        test_error=test_err), result, config


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def phase_cifar_time(result, config):
    """Where the full-width CIFAR fit's time goes. (a) The Gauss-Seidel
    sweep on the run's own train features, timed as it is (each step's
    solve reads its rescue decision on the host: one sync a step) and with
    the solve's acceptance check taken out (the same Cholesky solve, no
    sync), in turns; the two give the same weights. (b) A warm fit and
    apply under ``torch.profiler``: device time by name and the device's
    busy share of the wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.ops.learning import kernel
    from keystone_tpu_torch.pipelines import cifar
    from keystone_tpu_torch.workflow import PipelineEnv

    (mapper,) = [op for op in result.fitted.transformer_graph.operators.values()
                 if isinstance(op, kernel.KernelBlockLinearMapper)]
    kt, bs, lam = mapper.kernel_transformer, mapper.block_size, float(config.lam)
    n = kt.n_train
    nb = -(-n // bs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    labels = torch.randint(0, CIFAR_K, (n,), generator=gen, device=dev)
    Y = 2.0 * torch.nn.functional.one_hot(labels, CIFAR_K).float() - 1.0
    grams, chols = kernel._diag_factor_prepass(kt, lam, bs, nb)
    order = np.arange(nb)
    with_sync = kernel._solve_psd

    def without_sync(gram, rhs, lam, chol=None):
        return torch.cholesky_solve(rhs, chol)

    times, stacks = {"with sync": [], "without": []}, {}
    for label in ("with sync", "without", "without", "with sync"):
        kernel._solve_psd = with_sync if label == "with sync" else without_sync
        try:
            stack = torch.zeros((nb, bs, CIFAR_K), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stacks[label] = kernel._krr_sweep(kt, Y, order, grams, chols, lam, bs, stack)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
        finally:
            kernel._solve_psd = with_sync
    sync_s, free_s = (statistics.median(times[k]) for k in ("with sync", "without"))
    log(f"  sweep of {nb} steps: {sync_s:.4f} s with the per-step host sync, {free_s:.4f} s "
        f"without (runs {times}); the syncs cost {1e3 * (sync_s - free_s) / nb:.3f} ms a step")
    check("sweep without the host sync gives the same weights",
          torch.equal(stacks["with sync"], stacks["without"]), "bitwise equal")
    del grams, chols, stacks, Y

    PipelineEnv.get_or_create().reset()
    pipeline, train, test = cifar.build_pipeline(config, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted = pipeline.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fitted.apply(train.data)
        fitted.apply(test.data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    PipelineEnv.get_or_create().reset()
    rows = sorted(
        ((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
         if str(getattr(e, "device_type", "")).endswith("CUDA")),
        key=lambda row: -row[1],
    )
    rows = [row for row in rows if row[1] > 0]
    busy_ms = sum(row[1] for row in rows)
    log(f"  profiled warm fit {fit_s:.3f} s, fit + apply {wall:.3f} s; device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f}% of fit + apply)")
    for name, ms, count in rows[:14]:
        log(f"    {ms:10.3f} ms  {count:6d}x  {name[:90]}")
    return dict(sweep_seconds_with_sync=sync_s, sweep_seconds_without_sync=free_s,
                profiled_fit_seconds=fit_s, profiled_fit_apply_seconds=wall,
                device_busy_ms=busy_ms)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from keystone_tpu_torch.ops import cuda_images, cuda_ops
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.pipelines.timit import TimitConfig
    from keystone_tpu_torch.workflow import fusion

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = cuda_ops.build()
    log(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    log("[phase 1] kernels against their plain versions")
    cuda_ops.reset_launch_counts()
    results = phase_kernels(cuda_ops)
    results.update(phase_cifar_kernels(
        cuda_ops, cuda_images, fusion, torch.Generator(device="cuda").manual_seed(1)))
    log(f"  phase 1 launches (checks and timing, not the main path): {cuda_ops.launches}")
    log("[phase 2] TIMIT slice: three routes small against the CPU; --solver block at full width")
    phase_small_reference(timit, TimitConfig)
    stacked_counts, stacked = phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=False)
    flat_counts, flat = phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=True)
    log("[phase 3] README quick-start composition")
    phase_quickstart(cuda_ops)
    log("[phase 4] TIMIT --solver streaming at full width")
    streamed_counts, streamed = phase_streamed(cuda_ops, timit, TimitConfig)
    log("[phase 5] optimizer-bound streamed fit")
    phase_optimizer_bound(cuda_ops, timit, TimitConfig)
    log("[phase 6] RandomPatchCifarKernel: small against the CPU; full width")
    cifar_counts, cifar_run, cifar_result, cifar_config = phase_cifar(cuda_ops, fusion)
    log("[phase 7] where the full-width CIFAR fit's time goes")
    cifar_run["time"] = phase_cifar_time(cifar_result, cifar_config)

    route_counts = {FLAT: flat_counts, STACKED: stacked_counts, STREAMED: streamed_counts,
                    CIFAR: cifar_counts}
    kernels = [
        dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
             launches=route_counts[meta["path"]][name], path=meta["path"], **results[name])
        for name, meta in KERNELS.items()
    ]
    main_path = {FLAT: flat, STACKED: stacked, STREAMED: streamed, CIFAR: cifar_run}
    log(f"main path: {json.dumps(main_path)}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
