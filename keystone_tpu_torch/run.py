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
restarts, hot swap). ``--autoscale --slo-p99-ms MS`` closes the SLO loop
on the replicated plane (replicas between ``--min-replicas`` and
``--max-replicas``, the brownout ladder past the top, ``--scale-cooldown-s``
between actions). ``--tenants N`` or ``--tenant-spec FILE`` serves N
tenants through the model zoo, one exported plan each, under a device
budget of ``--zoo-budget-mb`` (0: every tenant fits; a budget that binds
pages weights in and out). ``--metrics-port P`` (0: an ephemeral port)
serves Prometheus text (``/metrics``), ``/healthz`` and ``/snapshot.json``
while the server runs, and ``--metrics-dir D`` writes atomic
``live_metrics.json`` snapshots there every ``--metrics-interval-s``
(``python -m keystone_tpu_torch.tools.slo D`` renders them).
``--from-plan P.json`` consumes a ``python -m keystone_tpu_torch.tools.plan
--apply`` artifact: serve flags left at their defaults are filled from its
measured baseline, and the summary line stamps its provenance. Serve runs
on the CUDA device unless given ``--device cpu``, and raises without one.
The reference's ``--fleet`` (the process fleet, ROADMAP A.16d) is not
ported yet: argparse refuses it.

``python -m keystone_tpu_torch.run learn [--input-dim 16 --out-dim 4
--segments 24 --rate 200 --duration-s 8]`` runs the continuous-learning
loop: a trainer re-fits a linear model over arriving synthetic segments
while two replicas serve Poisson load, and every candidate publishes
through the lifecycle gate (finite weights, bucket bit identity, held-out
quality), a canary and promotion; one summary line reports the books,
the publications and the measured model staleness. ``--metrics-port`` /
``--metrics-dir`` / ``--metrics-interval-s`` publish the live plane as in
``serve``. On the CUDA device unless given ``--device cpu``.

Global flags (any pipeline, serve and learn), popped before the
pipeline's own parser: ``--trace=DIR`` runs the invocation under the obs
tracer and writes ``DIR/trace.json`` (Perfetto-loadable),
``DIR/events.jsonl`` and ``DIR/meta.json``; ``--fault-plan=JSON|@file.json``
installs a deterministic fault-injection plan (``utils/faults.py``);
``--checkpoint-dir=DIR`` sets ``KEYSTONE_CHECKPOINT_DIR``: the trainer of
``learn`` and every segmented streamed fit (the disk tier's folds)
snapshot their carry there, and a restarted one resumes from it;
``--host-budget-bytes=N`` sets ``KEYSTONE_HOST_BUDGET_BYTES``, the host
RAM a dataset may claim before the cost model routes it through disk
shards.
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
    parser.add_argument("--autoscale", action="store_true",
                        help="close the SLO loop: an Autoscaler thread "
                        "drives replica add/remove (and the brownout "
                        "ladder past --max-replicas) from the declared "
                        "SLO's burn-rate state machine; requires "
                        "--slo-p99-ms > 0")
    parser.add_argument("--min-replicas", type=int, default=1,
                        help="autoscaler floor (with --autoscale)")
    parser.add_argument("--max-replicas", type=int, default=8,
                        help="autoscaler ceiling; past it admission "
                        "degrades down the brownout ladder "
                        "(with --autoscale)")
    parser.add_argument("--scale-cooldown-s", type=float, default=2.0,
                        help="minimum spacing between any two autoscale "
                        "actions — the no-flapping window "
                        "(with --autoscale)")
    parser.add_argument("--tenants", type=int, default=1,
                        help="serve N tenants through the multi-tenant "
                        "model zoo (each tenant gets its own exported "
                        "plan, SLO tracker, and fair admission share; "
                        "--rate is split uniformly across tenants)")
    parser.add_argument("--tenant-spec", default="",
                        help="JSON tenant spec file: {\"tenants\": "
                        "[{\"id\": \"a\", \"weight\": 1.0, \"rate_hz\": "
                        "100}, ...]} — overrides --tenants/--rate with "
                        "a skewed per-tenant mix")
    parser.add_argument("--zoo-budget-mb", type=float, default=0.0,
                        help="device-memory budget for the zoo's "
                        "resident weights (0 = size to fit every "
                        "tenant; a binding budget exercises paging)")
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
    _add_metrics_flags(parser)
    parser.add_argument("--from-plan", default="", metavar="PATH",
                        help="consume a tools.plan --apply defaults "
                        "artifact: its measured-baseline knobs "
                        "(replicas, queue depth, SLO bound) fill in "
                        "any flag left at its default, and the summary "
                        "line stamps the artifact's provenance")
    parser.add_argument("--device", default=None,
                        help="serving device (default: the CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    import numpy as np

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.serving import (
        Autoscaler,
        MicroBatchServer,
        ReplicatedServer,
        export_plan,
        run_open_loop,
    )

    plan_stamp = None
    if args.from_plan:
        try:
            plan_stamp = _serve_apply_plan_defaults(args, parser)
        except (OSError, ValueError, KeyError) as e:
            print(
                f"serve: --from-plan failed: {type(e).__name__}: {e}",
                file=sys.stderr,
            )
            return 2

    if args.autoscale and args.slo_p99_ms <= 0:
        print(
            "serve: --autoscale needs a declared SLO objective "
            "(--slo-p99-ms > 0) — the control loop consumes the "
            "burn-rate state machine",
            file=sys.stderr,
        )
        return 2
    if args.autoscale and not 1 <= args.min_replicas <= args.max_replicas:
        # Validate BEFORE any server threads start: a ValueError out of
        # Autoscaler.__init__ after ReplicatedServer construction would
        # leak running workers and break the one-line-diagnostic
        # contract below.
        print(
            f"serve: need 1 <= --min-replicas ({args.min_replicas}) <= "
            f"--max-replicas ({args.max_replicas})",
            file=sys.stderr,
        )
        return 2
    tenant_specs = _serve_tenant_specs(args)
    if tenant_specs is not None and args.autoscale:
        print(
            "serve: --tenants/--tenant-spec and --autoscale are "
            "mutually exclusive (the zoo's admission plane does its own "
            "per-tenant degradation)",
            file=sys.stderr,
        )
        return 2

    device = resolve_device(args.device)
    # Load/fit and export fail as a ONE-LINE diagnostic + non-zero exit,
    # not a bare traceback: serve is the operator-facing entry point, and
    # a supervisor restarting it needs the exit code, not a stack.
    phase = "load" if args.model else "quick-fit"
    if tenant_specs is not None:
        try:
            fitted, d_in = _serve_build_fitted(args, device)
        except SystemExit:
            raise
        except Exception as e:
            print(
                f"serve: {phase} failed: {type(e).__name__}: {e}",
                file=sys.stderr,
            )
            return 1
        return _serve_zoo(args, fitted, d_in, tenant_specs, device,
                          plan_stamp=plan_stamp)
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
    # publishing slo.state/burn gauges into their own registry, which the
    # live exporter renders beside the serving counters.
    slo_tracker = None
    slo_registry = None
    if args.slo_p99_ms > 0:
        slo_registry = obs.MetricsRegistry()
        slo_tracker = obs.SLOTracker([
            obs.SLOObjective(
                "latency", kind="latency",
                threshold_s=args.slo_p99_ms / 1e3, target=args.slo_target,
            ),
            obs.SLOObjective(
                "availability", kind="availability", target=0.999,
            ),
        ], metrics=slo_registry)
    replicated = args.replicas > 1 or args.autoscale
    if replicated:
        # Autoscale always rides the replicated plane (the elasticity
        # primitives live there), starting inside the configured bounds.
        n0 = args.replicas
        if args.autoscale:
            n0 = min(max(n0, args.min_replicas), args.max_replicas)
        server = ReplicatedServer(
            plan, num_replicas=n0, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_queue_depth=args.queue_depth,
            restart_budget=args.restart_budget, slo=slo_tracker,
        )
    else:
        server = MicroBatchServer(
            plan, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_queue_depth=args.queue_depth, slo=slo_tracker,
        )
    autoscaler = None
    exporter = None
    try:
        # Inside the try: from here on, any construction failure must
        # still close() the already-running server threads.
        if args.autoscale:
            autoscaler = Autoscaler(
                server, slo_tracker,
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                cooldown_s=args.scale_cooldown_s,
                metrics=server.metrics,
            ).start()
        sources = {"metrics": server.metrics, "serving": server.stats}
        if slo_registry is not None:
            sources["slo_metrics"] = slo_registry
        if autoscaler is not None:
            # tools.slo renders this block (decision log and scale
            # counters) beside the SLO verdict table.
            sources["autoscale"] = autoscaler.stats
        exporter = _live_exporter(args, sources, slo_tracker)
        report = run_open_loop(
            server.submit, lambda i: pool[i % len(pool)],
            rate_hz=args.rate, duration_s=args.duration_s, seed=args.seed,
            slo=slo_tracker,
        )
        stats = server.stats()
    finally:
        if autoscaler is not None:
            autoscaler.close()
        if exporter is not None:
            exporter.close()
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
    if plan_stamp is not None:
        summary["plan_artifact"] = plan_stamp
    if exporter is not None and exporter.port is not None:
        summary["metrics_port"] = exporter.port
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
    if autoscaler is not None:
        a_stats = autoscaler.stats()
        summary.update({
            "replicas_low": a_stats["replicas_low"],
            "replicas_high": a_stats["replicas_high"],
            "scale_ups": a_stats["scale_ups"],
            "scale_downs": a_stats["scale_downs"],
            "brownout_steps_entered": a_stats["brownout_steps_entered"],
            # The audit companions of any scale_ups/scale_downs claim.
            "num_decisions": a_stats["num_decisions"],
            "min_replicas": a_stats["min_replicas"],
            "max_replicas": a_stats["max_replicas"],
        })
    if replicated:
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


def _learn(argv):
    """``learn`` mode: the continuous-learning closed loop — a
    ContinuousTrainer re-fitting over arriving synthetic segments while
    the replicated plane serves live Poisson traffic, every candidate
    publishing through the lifecycle gate → canary → promote/rollback
    path. Prints one summary line with the publication counters and
    measured model staleness; exits non-zero with a one-line diagnostic
    on failure (the serve contract). Runs on the CUDA device unless
    given ``--device cpu``; ``--metrics-port`` / ``--metrics-dir`` publish
    the live plane (serving, lifecycle and trainer sections)."""
    import argparse
    import json

    parser = argparse.ArgumentParser("keystone-learn")
    parser.add_argument("--input-dim", type=int, default=16)
    parser.add_argument("--out-dim", type=int, default=4)
    parser.add_argument("--segments", type=int, default=24,
                        help="how many shard segments arrive over the run")
    parser.add_argument("--segment-rows", type=int, default=256)
    parser.add_argument("--arrival-spread-s", type=float, default=-1.0,
                        help="segments arrive uniformly over this window "
                        "(default: 60%% of --duration-s)")
    parser.add_argument("--publish-every-k", type=int, default=4,
                        help="trainer publishes a candidate every K "
                        "segments (the final segment always publishes)")
    parser.add_argument("--quality-bound", type=float, default=0.05,
                        help="max held-out score regression a candidate "
                        "may show vs the incumbent before the gate "
                        "rejects it")
    parser.add_argument("--canary-sustain-s", type=float, default=1.0,
                        help="canary window before full promotion "
                        "(0 disables the canary)")
    parser.add_argument("--canary-latency-factor", type=float, default=3.0)
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--queue-depth", type=int, default=1024)
    parser.add_argument("--replicas", type=int, default=2,
                        help="replicated-plane size (>= 2 so the canary "
                        "has incumbents to compare against)")
    parser.add_argument("--restart-budget", type=int, default=3)
    parser.add_argument("--rate", type=float, default=200.0)
    parser.add_argument("--duration-s", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slo-p99-ms", type=float, default=0.0)
    parser.add_argument("--slo-target", type=float, default=0.99)
    _add_metrics_flags(parser)
    parser.add_argument("--device", default=None,
                        help="serving device (default: the CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    import numpy as np

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.learning import ContinuousTrainer, TimedSegmentFeed
    from keystone_tpu_torch.serving import (
        LifecycleController,
        ReplicatedServer,
        export_plan,
        run_open_loop,
    )

    if args.replicas < 1:
        print("learn: --replicas must be >= 1", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    # Synthesize / fit / export fail as a ONE-LINE diagnostic + non-zero
    # exit (the serve contract — learn is operator-facing too).
    phase = "synthesize"
    try:
        d, k = args.input_dim, args.out_dim
        rng = np.random.default_rng(args.seed)
        W_true = rng.normal(size=(d, k)).astype(np.float32)
        def segment(n):
            X = rng.normal(size=(n, d)).astype(np.float32)
            y = (X @ W_true
                 + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
            return X, y
        segments = [segment(args.segment_rows)
                    for _ in range(args.segments)]
        holdout = segment(4 * args.segment_rows)
        phase = "quick-fit"
        from keystone_tpu_torch.ops.learning.linear import LinearMapper
        from keystone_tpu_torch.workflow.pipeline import (
            FittedPipeline,
            TransformerGraph,
        )

        X0, y0 = segments[0]
        X64 = X0.astype(np.float64)
        W0 = np.linalg.solve(
            X64.T @ X64 + 1e-3 * np.eye(d), X64.T @ y0.astype(np.float64)
        ).astype(np.float32)
        pipe0 = LinearMapper(W0).to_pipeline()
        fitted0 = FittedPipeline(
            TransformerGraph.from_graph(pipe0.executor.graph),
            pipe0.source, pipe0.sink,
        )
        phase = "export"
        plan0 = export_plan(
            fitted0, np.zeros(d, np.float32), max_batch=args.max_batch,
            device=device,
        )
    except SystemExit:
        raise
    except Exception as e:
        print(f"learn: {phase} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    slo_tracker = None
    slo_registry = None
    if args.slo_p99_ms > 0:
        slo_registry = obs.MetricsRegistry()
        slo_tracker = obs.SLOTracker([
            obs.SLOObjective(
                "latency", kind="latency",
                threshold_s=args.slo_p99_ms / 1e3, target=args.slo_target,
            ),
            obs.SLOObjective(
                "availability", kind="availability", target=0.999,
            ),
        ], metrics=slo_registry)

    spread = (args.arrival_spread_s if args.arrival_spread_s >= 0
              else 0.6 * args.duration_s)
    offsets = [spread * i / max(args.segments - 1, 1)
               for i in range(args.segments)]
    server = ReplicatedServer(
        plan0, num_replicas=args.replicas, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue_depth=args.queue_depth,
        restart_budget=args.restart_budget, slo=slo_tracker,
    )
    controller = None
    trainer = None
    exporter = None
    try:
        controller = LifecycleController(
            server, plan0, holdout=holdout,
            quality_bound=args.quality_bound,
            canary_sustain_s=args.canary_sustain_s,
            canary_latency_factor=args.canary_latency_factor,
            slo=slo_tracker,
        ).start()
        feed = TimedSegmentFeed(segments, arrival_offsets=offsets)
        # --checkpoint-dir (KEYSTONE_CHECKPOINT_DIR) flows through
        # checkpoint=None exactly like the streamed solvers.
        trainer = ContinuousTrainer(
            feed, controller, publish_every_k=args.publish_every_k,
        )
        sources = {
            "metrics": server.metrics,
            "serving": server.stats,
            "lifecycle": controller.stats,
            "trainer": trainer.stats,
        }
        if slo_registry is not None:
            sources["slo_metrics"] = slo_registry
        exporter = _live_exporter(args, sources, slo_tracker)
        trainer.start()
        rng_req = np.random.default_rng(args.seed + 1)
        pool = rng_req.normal(size=(256, d)).astype(np.float32)
        report = run_open_loop(
            server.submit, lambda i: pool[i % len(pool)],
            rate_hz=args.rate, duration_s=args.duration_s,
            seed=args.seed, slo=slo_tracker,
        )
        trainer.join(timeout=60.0)
        controller.poll()  # settle the last staleness clock
        lc_stats = controller.stats()
        tr_stats = trainer.stats()
        stats = server.stats()
    finally:
        if trainer is not None:
            trainer.stop()
        if controller is not None:
            controller.close()
        if exporter is not None:
            exporter.close()
        server.close()
    if trainer.error is not None:
        print(
            f"learn: trainer died mid-fit: "
            f"{type(trainer.error).__name__}: {trainer.error} — "
            "re-run with the same --checkpoint-dir to resume",
            file=sys.stderr,
        )
        return 1
    summary = report.to_row_dict()
    # The lifecycle claims (staleness*/rollbacks) ride in the SAME dict
    # as num_published and the offered rate — the make_row audit shape.
    summary.update({
        "published": lc_stats["published"],
        "num_published": lc_stats["num_published"],
        # NOT "rejected": that key is the LOAD accounting (sheds) from
        # the report above; gate rejections are a different book.
        "gate_rejected": lc_stats["rejected"],
        "rollbacks": lc_stats["rollbacks"],
        "canary_promotions": lc_stats["canary_promotions"],
        "staleness_s": lc_stats["staleness_s"],
        "staleness_median_s": lc_stats["staleness_median_s"],
        "trainer_segments_fit": tr_stats["segments_fit"],
        "trainer_resumes": tr_stats["resumes"],
        "incumbent_fingerprint": lc_stats["incumbent_fingerprint"],
        "replicas": stats.get("num_replicas"),
        "healthy_replicas": stats.get("healthy_replicas"),
        "accounting_ok": (
            report.num_offered
            == report.completed + report.rejected + report.failed
        ),
    })
    if slo_tracker is not None:
        verdict = report.slo or slo_tracker.verdict()
        summary.update({
            "slo_state": verdict["state"],
            "slo_budget_spent_fraction": max(
                o["budget_spent_fraction"]
                for o in verdict["objectives"].values()
            ),
        })
    if exporter is not None and exporter.port is not None:
        summary["metrics_port"] = exporter.port
    print(json.dumps(summary))
    return 0


def _add_metrics_flags(parser) -> None:
    """The live plane's flags, shared by serve and learn."""
    parser.add_argument("--metrics-port", type=int, default=-1,
                        help="serve Prometheus text-format + JSON "
                        "snapshots over HTTP on this port (0 = ephemeral, "
                        "-1 = off)")
    parser.add_argument("--metrics-dir", default="",
                        help="write atomic live_metrics.json snapshots "
                        "here every --metrics-interval-s (scrape-less "
                        "environments; tools.slo reads them)")
    parser.add_argument("--metrics-interval-s", type=float, default=1.0)


def _live_exporter(args, sources, slo_tracker):
    """The live exporter over ``sources`` plus the data-plane runtime's
    lanes when ``--metrics-port`` or ``--metrics-dir`` asks for one, else
    None. Its collectors read host-side ``stats()`` only: the publisher
    thread makes no CUDA call."""
    if args.metrics_port < 0 and not args.metrics_dir:
        return None
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.data.runtime import default_runtime

    return obs.LiveExporter(
        sources={**sources, "runtime": default_runtime().stats},
        slo=slo_tracker,
        snapshot_dir=args.metrics_dir or None,
        port=args.metrics_port if args.metrics_port >= 0 else None,
        interval_s=args.metrics_interval_s,
    )


def _serve_apply_plan_defaults(args, parser):
    """Consume a ``tools.plan --apply`` artifact: every serve flag left at
    its parser default is filled from the artifact's measured-baseline
    ``serve_defaults`` block (an explicit flag always wins). Returns the
    provenance stamp the serve summary line carries, so the plane's
    configuration is auditable back to the trace it was sized from."""
    import json

    from keystone_tpu_torch.tools.plan import PLAN_ARTIFACT_KIND

    with open(args.from_plan) as f:
        doc = json.load(f)
    if doc.get("artifact") != PLAN_ARTIFACT_KIND:
        raise ValueError(
            f"{args.from_plan!r} is not a tools.plan --apply artifact "
            f"(artifact={doc.get('artifact')!r})"
        )
    applied = {}
    for key, value in sorted(doc["serve_defaults"].items()):
        if not hasattr(args, key):
            continue
        if getattr(args, key) == parser.get_default(key):
            setattr(args, key, value)
            applied[key] = value
    return {
        "path": args.from_plan,
        "applied": applied,
        "source_traces": doc.get("source_traces", []),
        "fidelity_max_abs_log_error": doc.get("fidelity", {}).get(
            "max_abs_log_error"
        ),
        "written_at_unix_s": doc.get("written_at_unix_s"),
    }


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


def _serve_tenant_specs(args):
    """``[{"id", "weight", "rate_hz"}, ...]`` from --tenant-spec (the
    skewed-mix form) or --tenants N (uniform — --rate split evenly);
    None when serve should run the single-tenant path."""
    import json

    if args.tenant_spec:
        with open(args.tenant_spec) as f:
            doc = json.load(f)
        specs = doc.get("tenants") if isinstance(doc, dict) else doc
        if not isinstance(specs, list) or not specs:
            raise SystemExit(
                f"--tenant-spec {args.tenant_spec!r}: expected "
                '{"tenants": [{"id": ..., "weight": ..., "rate_hz": '
                "...}, ...]}"
            )
        return [
            {
                "id": str(s["id"]),
                "weight": float(s.get("weight", 1.0)),
                "rate_hz": float(s.get("rate_hz", args.rate / len(specs))),
            }
            for s in specs
        ]
    if args.tenants > 1:
        return [
            {
                "id": f"t{i}",
                "weight": 1.0,
                "rate_hz": args.rate / args.tenants,
            }
            for i in range(args.tenants)
        ]
    return None


def _serve_zoo(args, fitted, d_in, tenant_specs, device, plan_stamp=None):
    """Multi-tenant serve: one zoo, one exported plan per tenant (the
    fitted pipeline is cloned per tenant — paging mutates operator
    state in place, so tenants must never share operator objects), a
    per-tenant SLO tracker when an SLO is declared, skewed open-loop
    Poisson load, and a summary line with the per-tenant verdicts plus
    the zoo's paging/quarantine/cold-start counters."""
    import json
    import pickle

    import numpy as np

    from keystone_tpu_torch import obs
    from keystone_tpu_torch.serving import (
        ModelZoo,
        export_plan,
        run_multi_tenant_open_loop,
    )

    names = [s["id"] for s in tenant_specs]
    if len(set(names)) != len(names):
        print(f"serve: duplicate tenant ids: {names}", file=sys.stderr)
        return 2

    slos = {}
    if args.slo_p99_ms > 0:
        # No shared registry across trackers: every tracker would
        # register the SAME (slo.*, objective=) gauge keys and stomp
        # each other last-writer-wins. The per-tenant verdicts ride the
        # zoo's stats block.
        for name in names:
            slos[name] = obs.SLOTracker([
                obs.SLOObjective(
                    "latency", kind="latency",
                    threshold_s=args.slo_p99_ms / 1e3,
                    target=args.slo_target,
                ),
                obs.SLOObjective(
                    "availability", kind="availability", target=0.999,
                ),
            ])

    plans = {}
    try:
        for spec in tenant_specs:
            # Clone per tenant: a pickle round trip (the FittedPipeline
            # copy path; tensors on the card come back on it).
            clone = pickle.loads(pickle.dumps(fitted))
            plans[spec["id"]] = export_plan(
                clone, np.zeros(d_in, np.float32), max_batch=args.max_batch,
                device=device,
            )
    except Exception as e:
        print(
            f"serve: tenant export failed: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 1

    per_tenant_bytes = {
        name: max(p.pinned_bytes, 1) for name, p in plans.items()
    }
    budget = (
        int(args.zoo_budget_mb * (1 << 20)) if args.zoo_budget_mb > 0
        else sum(per_tenant_bytes.values()) + len(plans)
    )
    zoo = ModelZoo(
        budget_bytes=budget,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue_depth=args.queue_depth,
    )
    exporter = None
    try:
        for spec in tenant_specs:
            zoo.add_tenant(
                spec["id"], plans.pop(spec["id"]), weight=spec["weight"],
                slo=slos.get(spec["id"]),
            )
        exporter = _live_exporter(
            args, {"metrics": zoo.metrics, "zoo": zoo.stats}, None,
        )
        rng = np.random.default_rng(args.seed + 1)
        pool = rng.normal(size=(256, d_in)).astype(np.float32)
        report = run_multi_tenant_open_loop(
            zoo.submit,
            lambda tenant, i: pool[i % len(pool)],
            rates_hz={s["id"]: s["rate_hz"] for s in tenant_specs},
            duration_s=args.duration_s, seed=args.seed,
            slos=slos or None,
        )
        stats = zoo.stats()
    except ValueError as e:
        # A tenant larger than the whole budget (add_tenant's refusal).
        print(f"serve: {e}", file=sys.stderr)
        return 2
    finally:
        if exporter is not None:
            exporter.close()
        zoo.close()
    summary = report.to_row_dict()
    # The summary line keeps the per-tenant report blocks under
    # ``per_tenant``; ``tenants`` is the headline COUNT.
    summary["per_tenant"] = summary.pop("tenants")
    summary.update({
        "tenants": stats["num_tenants"],
        "residents": stats["residents"],
        "quarantined": stats["quarantined"],
        "coldstart_failfast": stats["coldstart_failfast"],
        "page_ins": stats["page_ins"],
        "page_outs": stats["page_outs"],
        "zoo_budget_bytes": stats["budget_bytes"],
        "tenant_resident_bytes": {
            name: t["resident_bytes"] for name, t in stats["tenants"].items()
        },
        "accounting_ok": stats["accounting_ok"]
        and report.accounting_ok(),
    })
    if slos:
        summary["tenant_slo_states"] = report.tenant_states()
    if exporter is not None and exporter.port is not None:
        summary["metrics_port"] = exporter.port
    if plan_stamp is not None:
        summary["plan_artifact"] = plan_stamp
    print(json.dumps(summary))
    return 0


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
#   --host-budget-bytes=N  -> KEYSTONE_HOST_BUDGET_BYTES (ops/learning/
#       cost.py: caps the host RAM a dataset claims before routing through
#       disk shards)
#   --checkpoint-dir=DIR   -> KEYSTONE_CHECKPOINT_DIR (data/durable.py:
#       the continuous trainer and the segmented streamed fits snapshot +
#       resume their fold carry)
#   --fault-plan=JSON|@f   -> KEYSTONE_FAULT_PLAN (utils/faults.py: install
#       a deterministic fault-injection plan for manual chaos drills)
#   --trace=DIR            -> KEYSTONE_TRACE (obs: run under the tracer,
#       write the Perfetto trace + event log to DIR)
_GLOBAL_FLAGS = {
    "--host-budget-bytes=": "KEYSTONE_HOST_BUDGET_BYTES",
    "--checkpoint-dir=": "KEYSTONE_CHECKPOINT_DIR",
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
        if argv[0] in ("learn", "--learn"):
            return _learn(argv[1:])
        resolve(argv[0])(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
