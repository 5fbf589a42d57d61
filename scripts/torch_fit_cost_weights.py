"""Fit the solver cost-model weights from fits timed on the card.

The port's twin of ``scripts/fit_cost_weights.py``: only the measurement
harness. Every timed (engine, geometry) point is recorded as a
``calibration_sweep`` cost decision with its measured seconds stamped on,
and the fit is the calibration plane's trace-driven refit
(``keystone_tpu_torch/obs/calibrate.py``), the same join and fit that
``python -m keystone_tpu_torch.tools.calibrate --refit`` runs on production
traces.

Measurement discipline:

  - a point is the minimum of 2 warm fits after one warm-up fit, each
    closed by ``torch.cuda.synchronize()``, less the null round trip (a
    one-element kernel and a synchronize, measured the same way);
  - the grid is the reference's ``--quick`` set plus its TIMIT-block-shaped
    point: dense exact / L-BFGS / block (blocks of :data:`BLOCK`) at
    16,384 x 1,024 x 16, 65,536 x
    2,048 x 32 and 262,144 x 4,096 x 147; the sparse gather engine, the
    gram engine as the selector builds it (float32 slabs, label
    ``SparseLBFGSwithL2[gram]``) and the bf16 gram engine (label
    ``SparseLBFGSwithL2[gram,bf16]``) at 250,000 and 500,000 rows x 16,384
    features, 82 active a row, k = 2 (the reference's Amazon geometry, not
    cut). Data is made on the device from a seed;
  - each sparse point records the L-BFGS iterations the stop test let run
    (the ``lbfgs.solve`` span's ``iterations``);
  - the predictions recorded beside each point are the active weight
    family's (``KEYSTONE_COST_WEIGHTS``, ``ec2`` unless set), which is also
    the refit's base. The refit pins the network weight, which one card
    cannot observe (``obs.calibrate.refit``: under the EC2 family, to
    ``ONE_CARD_NETWORK_PIN``).

Usage: python3 scripts/torch_fit_cost_weights.py [--out ART.json]
                                                 [--trace-dir DIR]
       python3 scripts/torch_fit_cost_weights.py --from-trace DIR [--out ...]

Activate the written artifact with ``KEYSTONE_COST_WEIGHTS=calibrated:ART.json``.
Runs on the CUDA device and raises without one unless given ``--device cpu``
(where the grid is far too large: call :func:`run_sweep` with small shapes).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

DENSE_SHAPES = ((16384, 1024, 16), (65536, 2048, 32), (262144, 4096, 147))
SPARSE_SHAPES = ((250_000, 16_384, 82, 2), (500_000, 16_384, 82, 2))
LAM = 1e-3
ITERATIONS = 20
# The block engine's block: the reference's sweep takes 1,000, which splits
# these widths unevenly onto the stepwise solver's plain products; 1,024
# gives equal blocks, the stacked solver that the card's selector routes
# take (``gram_corr_sym``). The calibration plane re-prices the label at
# 1,000 (2.4% fewer operations a sweep).
BLOCK = 1024


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def null_round_trip(device, reps: int = 5) -> float:
    """The least seconds of one one-element kernel and a synchronize: what
    every timed fit pays on top of its work."""
    x = torch.zeros(1, device=device)
    x.zero_()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        x.zero_()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def time_fit(est, data, labels, device, null_s: float, reps: int = 2) -> float:
    """One warm-up fit, then the least of ``reps`` warm fits, each closed by
    a synchronize, less the null round trip (floored at 1 µs)."""
    est.fit(data, labels)
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        est.fit(data, labels)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return max(best - null_s, 1e-6)


def record_point(est, context, measured_s: float):
    """Record one timed point as a single-candidate ``calibration_sweep``
    decision, its prediction under the active family, with the measured
    seconds stamped on (``min_of_N_warm``). Returns the prediction."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.ops.learning import cost as cost_mod

    label = cost_mod.candidate_label(est)
    cpu, mem, net = cost_mod.active_weights()
    predicted = float(est.cost(context["n"], context["d"], context["k"],
                               context["sparsity"], context["machines"], cpu, mem, net))
    ref = obs.record_cost_decision(obs.CostDecision(
        decision="calibration_sweep",
        winner=label,
        candidates=[{"label": label, "cost_s": predicted, "feasible": True}],
        reason="sweep",
        context={**context, "weights": {"cpu": cpu, "mem": mem, "network": net,
                                        "family": cost_mod.weights_family_name()}},
    ))
    if ref is not None:
        ref.stamp(measured_s, timing="min_of_N_warm")
    return predicted


def dense_rows(n, d, k, device, gen):
    from keystone_tpu_torch.data import Dataset

    X = torch.randn((n, d), generator=gen, device=device)
    Y = torch.randn((n, k), generator=gen, device=device)
    return Dataset.of(X), Dataset.of(Y)


def sparse_rows(n, d, nnz, k, device, gen):
    """Padded-COO rows as the reference's sweep makes them: ``nnz`` uniform
    column indices a row, sorted, standard normal values."""
    from keystone_tpu_torch.data import Dataset

    idx = torch.randint(0, d, (n, nnz), generator=gen, device=device, dtype=torch.int32)
    idx = torch.sort(idx, dim=1).values
    vals = torch.randn((n, nnz), generator=gen, device=device)
    Y = torch.randn((n, k), generator=gen, device=device)
    return Dataset({"indices": idx, "values": vals}, n=n), Dataset.of(Y)


def _iterations(tracer, before: int):
    """The ``iterations`` of the last ``lbfgs.solve`` span recorded after
    the tracer's first ``before`` events, or None."""
    spans = [r for r in tracer.events[before:]
             if r.get("type") == "span" and r.get("name") == "lbfgs.solve"]
    return spans[-1]["args"].get("iterations") if spans else None


def run_sweep(device, dense_shapes=DENSE_SHAPES, sparse_shapes=SPARSE_SHAPES, seed=0,
              log=print):
    """Time the grid on ``device``, recording every point into the active
    tracer (required) as a stamped ``calibration_sweep`` decision. Returns
    one dict a point: engine, label, n, d, k, measured_s, predicted_s and,
    for the sparse engines, the iterations run."""
    from keystone_tpu_torch import obs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.cost import candidate_label
    from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator

    tracer = obs.active_tracer()
    if tracer is None:
        raise RuntimeError("run_sweep records its points on the active tracer: run it "
                           "under obs.tracing()")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    null_s = null_round_trip(device)
    log(f"null round trip (one-element kernel + synchronize): {null_s * 1e3:.4f} ms, "
        "subtracted")
    points = []

    def point(name, est, data, labels, context):
        before = len(tracer.events)
        secs = time_fit(est, data, labels, device, null_s)
        iters = _iterations(tracer, before)
        predicted = record_point(est, context, secs)
        row = dict(engine=name, label=candidate_label(est), n=context["n"], d=context["d"],
                   k=context["k"], measured_s=secs, predicted_s=predicted)
        if iters is not None:
            row["iterations"] = iters
        points.append(row)
        log(f"  {name:<16} n={context['n']:>7} d={context['d']:>5} k={context['k']:>3}: "
            f"{secs:.6f} s measured, {predicted:.6g} s predicted"
            + (f", {iters} iterations" if iters is not None else ""))

    for n, d, k in dense_shapes:
        data, labels = dense_rows(n, d, k, device, gen)
        ctx = {"n": n, "d": d, "k": k, "sparsity": 1.0, "machines": 1}
        for name, est in (
                ("exact", LinearMapEstimator(LAM)),
                ("lbfgs", DenseLBFGSwithL2(lam=LAM, num_iterations=ITERATIONS)),
                ("block", BlockLeastSquaresEstimator(min(BLOCK, d), 3, lam=LAM))):
            point(name, est, data, labels, ctx)
        del data, labels
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for n, d, nnz, k in sparse_shapes:
        data, labels = sparse_rows(n, d, nnz, k, device, gen)
        ctx = {"n": n, "d": d, "k": k, "sparsity": nnz / d, "machines": 1}
        # The selector's own candidates (the gram engine's slab follows the
        # float32 values), then the bf16 gram engine, labelled apart.
        for name, kw in (("sparse-gather", {}), ("sparse-gram", dict(solver="gram")),
                         ("sparse-gram-bf16", dict(solver="gram", gram_dtype="bf16"))):
            est = SparseLBFGSwithL2(lam=LAM, num_iterations=ITERATIONS, num_features=d, **kw)
            point(name, est, data, labels, ctx)
        del data, labels
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return points


def print_refit(result) -> None:
    w = result["weights"]
    print("\nrefit weights (activate the artifact with "
          "KEYSTONE_COST_WEIGHTS=calibrated:<out>):")
    for key in ("cpu", "mem", "network", "sparse_gather_overhead"):
        v = w[key]
        print(f"  {key} = {v:.6e}" if v is not None else f"  {key} = null"
              + ("  # pinned: one card cannot observe it" if key == "network" else ""))
    fmt = lambda v: "?" if v is None else f"{v:.3f}"  # noqa: E731
    print(f"\nresiduals (median |log error|): "
          f"{fmt(result['before']['median_abs_log_error'])} under the base family -> "
          f"{fmt(result['after']['median_abs_log_error'])} refit")
    for label, eng in sorted(result["after"]["per_engine"].items()):
        print(f"  {label:<40} n={eng['count']:<3} "
              f"med|err|={fmt(eng['median_abs_log_error'])}")
    by_geom = {}
    for o in result["outcomes"]:
        if o.measured_s is not None:
            key = (o.context.get("n"), o.context.get("d"), o.context.get("k"))
            by_geom.setdefault(key, []).append(o)
    print("\nmeasured orderings:")
    for geom, rows in sorted(by_geom.items()):
        if len(rows) > 1:
            rows.sort(key=lambda o: o.measured_s)
            print(f"  n,d,k={geom}: " + " < ".join(o.winner for o in rows))
    if result["artifact_path"]:
        print(f"\nartifact: {result['artifact_path']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="", metavar="ART.json",
                        help="write the calibration artifact here")
    parser.add_argument("--trace-dir", default="", metavar="DIR",
                        help="also keep the sweep's trace (decisions and outcomes)")
    parser.add_argument("--from-trace", default="", metavar="DIR",
                        help="skip the sweep: refit from an existing traced run")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device; 'cpu' for the plain versions")
    args = parser.parse_args(argv)

    from keystone_tpu_torch import obs, resolve_device
    from keystone_tpu_torch.obs import calibrate as cal

    if args.from_trace:
        records = obs.load_events(args.from_trace)
    else:
        device = resolve_device(args.device)
        if device.type == "cuda":
            import subprocess

            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip())
        with obs.tracing(args.trace_dir or None) as tracer:
            run_sweep(device)
            records = tracer.events
    print_refit(cal.refit(records, out_path=args.out or None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
