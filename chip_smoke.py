"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's TIMIT ``--solver block`` paths from
``keystone_tpu_torch/csrc/`` (one ``nvcc`` per source, all started
together), then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the TIMIT slice gives it, with float32 and bfloat16 operands, and
     times the kernel, the plain version and one PyTorch library call that
     computes the same function;
  2. checks that a small run of both TIMIT routes on the card agrees with
     the plain-PyTorch run of it on the CPU, then drives the slice end to
     end through its entry point, ``keystone_tpu_torch.pipelines.timit.run``,
     at the full width of the reference's bench headline (440 inputs,
     4 x 4096 cosine features, 147 classes, 65,536 training rows, 3 epochs)
     by both routes, each with every kernel's launch count set to 0 just
     before and read just after:
       - the stacked route (``fit_first=False``: apply before fit, as the
         reference's ``run`` does), through ``cosine_features`` and
         ``gram_corr_sym``;
       - the fused flat route (``pipeline.fit()`` first), through
         ``cosine_features``, ``block_gram_sym``, ``block_corr`` and
         ``block_residual_update``;
  3. fits and applies the README quick-start composition (one 440 -> 4096
     cosine featurizer, block least squares with block 1024, 3 iterations,
     λ 1e-4, then MaxClassifier) on the same rows, through the fused fit.

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

# Each kernel, and the main-path route whose launches the JSON line reports.
FLAT, STACKED = "timit fused flat fit (fit first)", "timit stacked fit (apply first)"
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
}
# Launches of the flat route: 4 blocks, 3 epochs, Gramians stashed after
# the first epoch; 4 cosine branches in the fit and in each of two applies.
FLAT_LAUNCHES = {
    "cosine_features": 3 * NUM_COSINES, "gram_corr_sym": 0,
    "block_gram_sym": D_FEAT // BLOCK, "block_corr": EPOCHS * D_FEAT // BLOCK,
    "block_residual_update": EPOCHS * D_FEAT // BLOCK,
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


def phase_small_reference(timit, TimitConfig):
    """Both routes at a small size on the card (kernels) and on the CPU
    (plain versions), same data and weights: errors must agree."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import PipelineEnv

    config = TimitConfig(num_cosines=2, block_size=256, synthetic_n=2048, num_epochs=2)
    for fit_first, route in ((True, FLAT), (False, STACKED)):
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from keystone_tpu_torch.ops import cuda_ops
    from keystone_tpu_torch.pipelines import timit
    from keystone_tpu_torch.pipelines.timit import TimitConfig

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
    log(f"  phase 1 launches (checks and timing, not the main path): {cuda_ops.launches}")
    log("[phase 2] TIMIT --solver block slice, both routes")
    phase_small_reference(timit, TimitConfig)
    stacked_counts, stacked = phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=False)
    flat_counts, flat = phase_timit_route(cuda_ops, timit, TimitConfig, fit_first=True)
    log("[phase 3] README quick-start composition")
    phase_quickstart(cuda_ops)

    route_counts = {FLAT: flat_counts, STACKED: stacked_counts}
    kernels = [
        dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
             launches=route_counts[meta["path"]][name], path=meta["path"], **results[name])
        for name, meta in KERNELS.items()
    ]
    log(f"main path: {json.dumps({FLAT: flat, STACKED: stacked})}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
