"""Command-line entry point: ``python -m keystone_tpu_torch.run <Pipeline> [flags]``.

Port of ``keystone_tpu/run.py``: all 13 of the reference's pipeline names
(``Timit`` is an alias of ``TimitPipeline``):

  - TimitPipeline, with ``--solver auto`` (the cost-model selector, the
    default: the block chain at resident sizes, the streamed fit past the
    device's memory), ``--solver block`` (the resident block solver) and
    ``--solver streaming`` (the out-of-core tile-streamed fit);
  - the five CIFAR runners, LinearPixels, RandomCifar, RandomPatchCifar,
    RandomPatchCifarKernel (Gaussian kernel ridge regression) and
    RandomPatchCifarAugmented (random training crops, voted test crops),
    with the reference's flags plus ``--syntheticN`` (training images of
    the synthetic data), e.g.
    ``python -m keystone_tpu_torch.run RandomPatchCifar --syntheticN 50000``;
  - MnistRandomFFT (random-sign padded FFTs and block least squares), with
    the reference's flags plus ``--syntheticN``, e.g.
    ``python -m keystone_tpu_torch.run MnistRandomFFT --syntheticN 60000``;
  - AmazonReviewsPipeline (n-gram term frequencies and logistic regression
    by L-BFGS) and NewsgroupsPipeline (n-gram log term frequencies and
    multinomial naive Bayes), with the reference's flags plus
    ``--syntheticN``;
  - StupidBackoffPipeline (an n-gram language model with stupid-backoff
    scores, host work), with the reference's flags plus ``--syntheticN``;
  - VOCSIFTFisher (dense SIFT, column PCA, GMM Fisher vectors, block least
    squares, mean average precision) and ImageNetSiftLcsFV (SIFT and LCS
    Fisher-vector branches, block weighted least squares, top-5 error), on
    synthetic images, with the reference's model flags plus
    ``--syntheticN`` and ``--imageSize`` (and ``--syntheticClasses`` for
    ImageNet), e.g. ``python -m keystone_tpu_torch.run VOCSIFTFisher
    --vocabSize 256 --syntheticN 5011 --imageSize 64``.

Pipelines run on the CUDA device unless given ``--device cpu``.

``python -m keystone_tpu_torch.run serve [--model fitted.pkl | --pipeline
MnistRandomFFT] --rate 200 --duration-s 5`` starts the online serving
path instead: export the fitted pipeline (one CUDA graph per padding
bucket), run the deadline-aware micro-batch server under open-loop
Poisson load, and print the p50/p99 latency + throughput summary line
with the reference's keys (plus ``export_s``, the export's seconds, kept
out of ``single_request_s``). ``--replicas N`` serves through the
replicated plane (least-loaded routing, per-replica breakers, watchdog
restarts, hot swap). Serve runs on the CUDA device unless given
``--device cpu``, and raises without one. The reference's ``--autoscale``,
``--tenants`` / ``--tenant-spec`` / ``--zoo-budget-mb``, ``--fleet``,
``--from-plan`` and ``--metrics-port`` / ``--metrics-dir``, and its
``learn`` command, are not ported yet.

Global flags (any pipeline, and serve), popped before the pipeline's own
parser: ``--trace=DIR`` runs the invocation under the obs tracer and
writes ``DIR/trace.json`` (Perfetto-loadable), ``DIR/events.jsonl`` and
``DIR/meta.json``; ``--fault-plan=JSON|@file.json`` installs a
deterministic fault-injection plan (``utils/faults.py``).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict


def _mnist(argv):
    from keystone_tpu_torch.pipelines import mnist_random_fft

    mnist_random_fft.main(argv)


def _timit(argv):
    from keystone_tpu_torch.pipelines import timit

    timit.main(argv)


def _cifar(variant: str) -> Callable:
    def runner(argv):
        from keystone_tpu_torch.pipelines import cifar

        cifar.main(argv, variant=variant)

    return runner


def _amazon(argv):
    from keystone_tpu_torch.pipelines import amazon_reviews

    amazon_reviews.main(argv)


def _voc(argv):
    from keystone_tpu_torch.pipelines import voc_sift_fisher

    voc_sift_fisher.main(argv)


def _imagenet(argv):
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv

    imagenet_sift_lcs_fv.main(argv)


def _newsgroups(argv):
    from keystone_tpu_torch.pipelines import newsgroups

    newsgroups.main(argv)


def _stupid_backoff(argv):
    from keystone_tpu_torch.pipelines import stupid_backoff

    stupid_backoff.main(argv)


def _serve(argv):
    """``serve`` mode: load (or quick-fit) a pipeline, export the serving
    plan, start the micro-batch server (or the replicated plane), drive
    it with open-loop Poisson load, and print the percentile summary line.

    ``python -m keystone_tpu_torch.run serve --model fitted.pkl
    --input-dim 784`` serves a saved FittedPipeline; without ``--model``
    it fits the named ``--pipeline`` (MnistRandomFFT) on synthetic data
    first.
    """
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser("keystone-serve")
    parser.add_argument("--model", default="", help="FittedPipeline pickle")
    parser.add_argument("--pipeline", default="MnistRandomFFT",
                        help="pipeline to quick-fit when no --model is given")
    parser.add_argument("--input-dim", type=int, default=784)
    parser.add_argument("--numFFTs", type=int, default=4)
    parser.add_argument("--blockSize", type=int, default=2048)
    parser.add_argument("--fit-n", type=int, default=4096)
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--queue-depth", type=int, default=1024)
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve through a ReplicatedServer with this "
                        "many replicas (1 = single MicroBatchServer)")
    parser.add_argument("--restart-budget", type=int, default=3,
                        help="replica respawn attempts before permanent "
                        "eviction (with --replicas > 1)")
    parser.add_argument("--rate", type=float, default=200.0,
                        help="offered Poisson rate (requests/s)")
    parser.add_argument("--duration-s", type=float, default=5.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slo-p99-ms", type=float, default=0.0,
                        help="declare a p99 latency SLO objective at this "
                        "bound (plus an availability objective); the "
                        "summary line then carries the live verdict and "
                        "budget spent (0 = no SLO)")
    parser.add_argument("--slo-target", type=float, default=0.99,
                        help="good-fraction target of the latency "
                        "objective (error budget = 1 - target)")
    parser.add_argument("--device", default=None,
                        help="serving device (default: the CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    import numpy as np

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.serving import (
        MicroBatchServer,
        ReplicatedServer,
        export_plan,
        run_open_loop,
    )

    device = resolve_device(args.device)
    # Load/fit and export fail as a ONE-LINE diagnostic + non-zero exit,
    # not a bare traceback: serve is the operator-facing entry point, and
    # a supervisor restarting it needs the exit code, not a stack.
    phase = "load" if args.model else "quick-fit"
    try:
        fitted, d_in = _serve_build_fitted(args, device)
        phase = "export"
        t0 = time.perf_counter()
        plan = export_plan(
            fitted, np.zeros(d_in, np.float32), max_batch=args.max_batch,
            device=device,
        )
        export_s = time.perf_counter() - t0
    except SystemExit:
        raise
    except Exception as e:
        print(
            f"serve: {phase} failed: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 1
    single_s = plan.measure_single_request_s()
    rng = np.random.default_rng(args.seed + 1)
    pool = rng.normal(size=(256, d_in)).astype(np.float32)

    # Live SLO objectives: a p99 latency bound plus availability,
    # publishing slo.state/burn gauges into their own registry.
    slo_tracker = None
    if args.slo_p99_ms > 0:
        slo_tracker = obs.SLOTracker([
            obs.SLOObjective(
                "latency", kind="latency",
                threshold_s=args.slo_p99_ms / 1e3, target=args.slo_target,
            ),
            obs.SLOObjective(
                "availability", kind="availability", target=0.999,
            ),
        ], metrics=obs.MetricsRegistry())
    if args.replicas > 1:
        server = ReplicatedServer(
            plan, num_replicas=args.replicas, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_queue_depth=args.queue_depth,
            restart_budget=args.restart_budget, slo=slo_tracker,
        )
    else:
        server = MicroBatchServer(
            plan, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_queue_depth=args.queue_depth, slo=slo_tracker,
        )
    try:
        report = run_open_loop(
            server.submit, lambda i: pool[i % len(pool)],
            rate_hz=args.rate, duration_s=args.duration_s, seed=args.seed,
            slo=slo_tracker,
        )
        stats = server.stats()
    finally:
        server.close()
    summary = report.to_row_dict()
    summary.update({
        "single_request_s": round(single_s, 6),
        "export_s": round(export_s, 6),
        "buckets": plan.buckets,
        "plan_compiled": plan.compiled,
        "max_wait_ms": args.max_wait_ms,
        "plan_fingerprint": plan.fingerprint,
    })
    if slo_tracker is not None:
        # The verdict and the budget, on the one line an operator reads.
        verdict = report.slo or slo_tracker.verdict()
        summary.update({
            "slo_state": verdict["state"],
            "slo_budget_spent_fraction": max(
                o["budget_spent_fraction"]
                for o in verdict["objectives"].values()
            ),
        })
    if args.replicas > 1:
        summary.update({
            "replicas": stats.get("num_replicas"),
            "healthy_replicas": stats.get("healthy_replicas"),
            "restarts_total": stats.get("restarts_total"),
            "evicted_replicas": stats.get("evicted_replicas"),
            "degraded": stats.get("degraded"),
        })
    else:
        summary.update({
            "mean_pad_fraction": stats.get("mean_pad_fraction"),
            "breaker_state": stats.get("breaker_state"),
        })
    print(json.dumps(summary))
    return 0


def _serve_build_fitted(args, device):
    """(fitted, d_in) for serve mode: load a saved FittedPipeline or
    quick-fit the named pipeline on synthetic data on ``device`` (the
    featurizer fused into the block fit: ``block_gram_sym``,
    ``block_corr`` and ``block_residual_update`` once each at one block)."""
    import numpy as np
    import torch

    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    if args.model:
        return FittedPipeline.load(args.model), args.input_dim
    if args.pipeline.rsplit(".", 1)[-1] == "MnistRandomFFT":
        from keystone_tpu_torch.data import Dataset
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
        from keystone_tpu_torch.pipelines.mnist_random_fft import (
            MnistRandomFFTConfig,
            build_featurizer,
        )

        d_in = args.input_dim
        rng = np.random.default_rng(args.seed)
        X = torch.from_numpy(rng.normal(size=(args.fit_n, d_in)).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.integers(0, 10, size=args.fit_n)).to(device)
        labels = ClassLabelIndicatorsFromIntLabels(10)(Dataset.of(y))
        cfg = MnistRandomFFTConfig(
            num_ffts=args.numFFTs, block_size=args.blockSize, image_size=d_in
        )
        fitted = build_featurizer(cfg, device=device).and_then(
            BlockLeastSquaresEstimator(args.blockSize, 1, 1e-3),
            Dataset.of(X), labels,
        ).fit()
        return fitted, d_in
    raise SystemExit(
        f"serve quick-fit supports MnistRandomFFT (got "
        f"{args.pipeline!r}); pass --model for anything else"
    )


PIPELINES: Dict[str, Callable] = {
    "MnistRandomFFT": _mnist,
    "TimitPipeline": _timit,
    "Timit": _timit,
    "LinearPixels": _cifar("LinearPixels"),
    "RandomCifar": _cifar("RandomCifar"),
    "RandomPatchCifar": _cifar("RandomPatchCifar"),
    "RandomPatchCifarKernel": _cifar("RandomPatchCifarKernel"),
    "RandomPatchCifarAugmented": _cifar("RandomPatchCifarAugmented"),
    "VOCSIFTFisher": _voc,
    "ImageNetSiftLcsFV": _imagenet,
    "AmazonReviewsPipeline": _amazon,
    "NewsgroupsPipeline": _newsgroups,
    "StupidBackoffPipeline": _stupid_backoff,
}


def resolve(name: str) -> Callable:
    """Accept bare or fully-qualified (dotted) pipeline names."""
    bare = name.rsplit(".", 1)[-1]
    if bare not in PIPELINES:
        known = ", ".join(sorted(PIPELINES))
        raise SystemExit(f"Unknown pipeline {name!r}. Known pipelines: {known}")
    return PIPELINES[bare]


# Global flags popped before any per-pipeline parser sees them; each
# becomes the env knob the library layer reads:
#   --fault-plan=JSON|@f   -> KEYSTONE_FAULT_PLAN (utils/faults.py: install
#       a deterministic fault-injection plan for manual chaos drills)
#   --trace=DIR            -> KEYSTONE_TRACE (obs: run under the tracer,
#       write the Perfetto trace + event log to DIR)
_GLOBAL_FLAGS = {
    "--fault-plan=": "KEYSTONE_FAULT_PLAN",
    "--trace=": "KEYSTONE_TRACE",
}


def _extract_global_flags(argv):
    """Pop the global flags into their env knobs — per-pipeline flag
    parsers never see them, and the library layer picks them up with no
    plumbing."""
    out = []
    for a in argv:
        for prefix, env in _GLOBAL_FLAGS.items():
            if a.startswith(prefix):
                os.environ[env] = a.split("=", 1)[1]
                break
        else:
            out.append(a)
    return out


def _usage() -> int:
    print(__doc__)
    print("Pipelines:", ", ".join(sorted(PIPELINES)))
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        return _usage()
    argv = _extract_global_flags(argv)
    if not argv:  # invocation was ONLY global flags — show help, no crash
        return _usage()
    # The whole invocation runs under the obs tracer when KEYSTONE_TRACE
    # (or --trace=DIR above) names a directory; a no-op context otherwise.
    from keystone_tpu_torch import obs

    with obs.tracing_from_env():
        if argv[0] in ("serve", "--serve"):
            return _serve(argv[1:])
        resolve(argv[0])(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
