"""Cost-model calibration plane (port of ``keystone_tpu/obs/calibrate.py``).

Every routing decision (gram, gather or BCD engine; resident, compressed or
streamed tier) flows through ``ops/learning/cost.py``, whose weights were
fitted once, elsewhere: the port's default family is the reference's 2015
EC2 cluster set. The obs plane records the measured cost of the work, and
a ``cost.decision`` event for every prediction. This module is the
feedback path between the two:

  - :func:`join_decisions` joins each ``cost.decision`` event with the
    measured seconds of the work it priced: the ``outcome`` the fit stamps
    onto the decision record (``workflow/pipeline.py``: span id and wall of
    the winning fit, read after a synchronize of its CUDA device), or, for
    decisions without one, the span-window join over the work spans that
    followed it (``estimator.fit`` / ``fold.segment`` / the IO spans),
    matched by ``run_id`` and timestamps.
  - :func:`calibration_report`: the per-engine, per-weight-family
    prediction-error report (log error = ln(measured/predicted)), the
    ``calibration.error`` histograms, and the mis-route table, decisions
    where a measured-faster feasible candidate lost, with the regret in
    seconds. A mis-route claim cites a measured outcome of the losing
    engine at the same geometry, or the losing engine's prediction
    corrected by its own measured error ratio, never the raw prediction
    under audit.
  - :func:`fit_weights` / :func:`refit`: re-estimate a weight family from
    joined outcomes: (cpu, mem) by a median-relative-error grid search
    under the ``max(cpu·flops, mem·bytes)`` form the selector evaluates,
    ``sparse_gather_overhead`` from the gather-engine rows given (cpu,
    mem), the sketch and zoo overheads from their rows, the network weight
    pinned, not fit (one card cannot observe it): the base family's, or
    :data:`ONE_CARD_NETWORK_PIN` where the base is the EC2 cluster family.
  - :func:`write_calibration_artifact` / :func:`load_calibration_artifact`:
    the refit as a versioned, provenance-stamped JSON artifact
    (``data/durable.atomic_write_json``), which ``cost.py`` loads under
    ``KEYSTONE_COST_WEIGHTS=calibrated:<path>``.
  - :func:`drift_gate`: when fresh traces disagree with the weights past
    the threshold (median |log error|, default
    :data:`DEFAULT_DRIFT_THRESHOLD`, a 2x median miss), publish
    ``calibration.drift`` and leave a WARN flight note and a log line.

Difference from the reference: a ``fold.segment`` span on a CUDA device
closes when the segment's launches are queued, not when they finish (the
port's folds keep up to ``inflight`` segments ahead of the card), so it
carries ``queued=True``. A decision joined through such spans gets the
timing ``"spans_queued"``: the report counts those rows in its timing mix,
and :func:`fit_weights` leaves them out of the refit, since their seconds
are enqueue time.

No torch at module level; estimator reconstruction for re-prediction
imports the learning modules lazily.
"""

from __future__ import annotations

import logging
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from keystone_tpu_torch.obs.metrics import (
    METRIC_CALIBRATION_DECISIONS,
    METRIC_CALIBRATION_DRIFT,
    METRIC_CALIBRATION_ERROR,
    METRIC_CALIBRATION_MISROUTES,
    METRIC_CALIBRATION_REGRET_S,
    MetricsRegistry,
)

logger = logging.getLogger("keystone_tpu_torch.obs.calibrate")

__all__ = [
    "ARTIFACT_FORMAT",
    "ARTIFACT_VERSION",
    "DEFAULT_DRIFT_THRESHOLD",
    "DecisionOutcome",
    "ONE_CARD_NETWORK_PIN",
    "calibration_report",
    "drift_gate",
    "estimator_for_label",
    "family_weights",
    "fit_weights",
    "join_decisions",
    "load_calibration_artifact",
    "predict_seconds",
    "refit",
    "write_calibration_artifact",
]

ARTIFACT_FORMAT = "keystone-cost-calibration"
ARTIFACT_VERSION = 1

# The network weight (seconds a float) that a refit pins where its base is
# the EC2 cluster family, whose 1.32 s a float prices a cluster's network:
# the cost models charge even one machine a reduction of 2·d·k floats,
# which on one card moves through device memory. One float is priced at 4
# bytes over an H100 SXM's data-sheet memory rate, 3.35 TB/s (not measured).
ONE_CARD_NETWORK_PIN = 4.0 / 3.35e12

# Drift threshold in ln units: a median |ln(measured/predicted)| past
# this is a detected regression (0.7 ≈ a 2x median miss, the reference's
# bound).
DEFAULT_DRIFT_THRESHOLD = 0.7

# Decision kinds the calibrator prices. ``least_squares_solver`` is the
# production selector (cost.py); ``calibration_sweep`` is the measurement
# harness (scripts/torch_fit_cost_weights.py), which records one
# single-candidate decision a timed (engine, geometry) point so that the
# refit path is the same for sweeps and production runs; ``mesh_layout``
# is the reference's mesh-shape selector (not ported: ROADMAP A.15);
# ``placement.zoo_page_in`` is the zoo's priced page fault
# (placement/engine.py price_page_in), stamped with the measured restore
# wall so refit can recover the paging overhead.
CALIBRATED_DECISIONS = (
    "least_squares_solver", "calibration_sweep", "mesh_layout",
    "placement.zoo_page_in",
)

# Work spans a decision's measured seconds may be joined from, by
# priority: the executor's fit bracket first (it IS the priced work),
# then the fold chunks (the dominant term of every streamed fit).
_FIT_SPAN = "estimator.fit"
_FOLD_SPAN = "fold.segment"
# The timing of a decision joined through fold spans that closed when
# their launches were queued (``queued=True``): enqueue time, kept out of
# the refit.
QUEUED_TIMING = "spans_queued"
# Span families counted per decision window for provenance (the
# span_counts block the artifact records).
WORK_SPAN_NAMES = (
    _FIT_SPAN, _FOLD_SPAN, "prefetch.read", "runtime.task",
    "serving.batch",
)


@dataclass
class DecisionOutcome:
    """One ``cost.decision`` event joined with the measured seconds of
    the work it priced."""

    run_id: str
    decision: str                      # kind, e.g. "least_squares_solver"
    winner: str                        # candidate label of the selection
    reason: str
    predicted_s: Optional[float]       # the winner's RECORDED prediction
    measured_s: Optional[float]        # joined measurement (None: no join)
    span_id: Optional[int] = None      # the measured span, when stamped
    joined_via: Optional[str] = None   # "outcome" | "spans" | None
    # Measurement convention of the stamped wall: "min_of_N_warm" (the
    # sweep harness: warm, synchronized, the null round trip subtracted),
    # "single_run_cold" (the executor's one production fit, first-call
    # costs included), "spans" (window-joined), "spans_queued" (joined
    # from fold spans that closed at enqueue), or None.
    timing: Optional[str] = None
    context: Dict[str, Any] = field(default_factory=dict)
    weights: Dict[str, Any] = field(default_factory=dict)  # as recorded
    candidates: List[Dict[str, Any]] = field(default_factory=list)
    span_counts: Dict[str, int] = field(default_factory=dict)

    def log_error(self, predicted: Optional[float] = None
                  ) -> Optional[float]:
        """ln(measured / predicted): positive = the model was optimistic
        (work ran slower than priced). None when either side is missing
        or non-positive (an infeasible winner has no prediction)."""
        p = self.predicted_s if predicted is None else predicted
        if p is None or self.measured_s is None:
            return None
        if p <= 0 or self.measured_s <= 0:
            return None
        return math.log(self.measured_s / p)


def _geometry(ctx: Dict[str, Any]) -> Tuple[int, int, int, float, int]:
    return (
        int(ctx.get("n", 0)), int(ctx.get("d", 0)), int(ctx.get("k", 1)),
        float(ctx.get("sparsity", 1.0)), int(ctx.get("machines", 1)),
    )


def _geometry_key(label: str, ctx: Dict[str, Any]) -> Tuple:
    n, d, k, s, m = _geometry(ctx)
    return label, n, d, k, round(s, 8), m


def join_decisions(
    records: Iterable[Dict[str, Any]],
    kinds: Sequence[str] = CALIBRATED_DECISIONS,
) -> List[DecisionOutcome]:
    """Join every ``cost.decision`` event with its measured outcome.

    Preferred evidence is the back-annotated ``outcome`` block the
    executor stamped onto the decision record (span id + wall of the
    winning fit). Decisions without one fall back to the span-window
    join: within the same ``run_id``, the work spans opening between
    this decision's timestamp and the next decision's (or the end of
    the trace) are the work it priced — measured seconds is the
    ``estimator.fit`` bracket when present, else the sum of the
    ``fold.segment`` chunks. Span counts per family are kept either way
    (the provenance block of the calibration artifact).
    """
    records = list(records)
    decisions = [
        r for r in records
        if r.get("type") == "event"
        and r.get("name") in ("cost.decision", "placement.decision")
        and (r.get("args") or {}).get("decision") in kinds
    ]
    spans_by_run: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("type") == "span" and r.get("name") in WORK_SPAN_NAMES:
            spans_by_run.setdefault(r.get("run_id", ""), []).append(r)
    # Decision windows are per run, in timestamp order.
    by_run: Dict[str, List[Dict[str, Any]]] = {}
    for ev in decisions:
        by_run.setdefault(ev.get("run_id", ""), []).append(ev)
    out: List[DecisionOutcome] = []
    for run_id, evs in by_run.items():
        evs.sort(key=lambda e: e.get("ts_us", 0))
        spans = sorted(
            spans_by_run.get(run_id, []), key=lambda s: s.get("ts_us", 0)
        )
        for i, ev in enumerate(evs):
            args = ev.get("args") or {}
            t0 = ev.get("ts_us", 0)
            t1 = evs[i + 1].get("ts_us") if i + 1 < len(evs) else None
            window = [
                s for s in spans
                if s.get("ts_us", 0) >= t0
                and (t1 is None or s.get("ts_us", 0) < t1)
            ]
            counts: Dict[str, int] = {}
            for s in window:
                counts[s["name"]] = counts.get(s["name"], 0) + 1
            cands = [dict(c) for c in args.get("candidates", [])]
            winner = args.get("winner", "?")
            predicted = next(
                (c.get("cost_s") for c in cands
                 if c.get("label") == winner), None,
            )
            outcome = args.get("outcome") or {}
            measured = outcome.get("measured_s")
            span_id = outcome.get("span_id")
            timing = outcome.get("timing")
            via: Optional[str] = "outcome" if measured is not None else None
            if measured is None:
                timing = "spans"
                fits = [s for s in window if s["name"] == _FIT_SPAN]
                folds = [s for s in window if s["name"] == _FOLD_SPAN]
                if fits:
                    measured = fits[0].get("dur_us", 0) / 1e6
                    span_id = fits[0].get("span_id")
                    via = "spans"
                elif folds:
                    measured = sum(
                        s.get("dur_us", 0) for s in folds
                    ) / 1e6
                    via = "spans"
                    if any((s.get("args") or {}).get("queued")
                           for s in folds):
                        timing = QUEUED_TIMING
            ctx = {
                k: v for k, v in args.items()
                if k not in ("decision", "winner", "reason", "candidates",
                             "outcome", "weights", "weights_family")
            }
            weights = dict(args.get("weights") or {})
            if "family" not in weights and args.get("weights_family"):
                weights["family"] = args["weights_family"]
            out.append(DecisionOutcome(
                run_id=run_id,
                decision=args.get("decision", "?"),
                winner=winner,
                reason=args.get("reason", "?"),
                predicted_s=predicted,
                measured_s=(
                    float(measured) if measured is not None else None
                ),
                span_id=span_id,
                joined_via=via,
                timing=(timing if measured is not None else None),
                context=ctx,
                weights=weights,
                candidates=cands,
                span_counts=counts,
            ))
    out.sort(key=lambda o: (o.run_id, o.decision))
    return out


# ---------------------------------------------------------------------------
# Weight families + candidate reconstruction
# ---------------------------------------------------------------------------


def family_weights(spec: Optional[str] = None) -> Dict[str, Any]:
    """Resolve a weight-family spec to its constants.

    ``spec``: None / ``"active"`` (whatever ``KEYSTONE_COST_WEIGHTS``
    selects right now: ``ec2`` unless set), ``"ec2"``, ``"tpu"`` (the
    reference's TPU constants), or ``"calibrated:<path>"`` (a refit
    artifact). Returns
    ``{"name", "cpu", "mem", "network", "sparse_gather_overhead",
    "srht_sketch_overhead", "countsketch_overhead",
    "zoo_page_overhead"}``.
    """
    from keystone_tpu_torch.ops.learning import cost as cost_mod

    raw = (spec or "active").strip()
    low = raw.lower()
    if low == "active":
        cpu, mem, net = cost_mod.active_weights()
        return {
            "name": cost_mod.weights_family_name(),
            "cpu": cpu, "mem": mem, "network": net,
            "sparse_gather_overhead": cost_mod.sparse_gather_overhead(),
            "srht_sketch_overhead": cost_mod.srht_sketch_overhead(),
            "countsketch_overhead": cost_mod.countsketch_overhead(),
            "zoo_page_overhead": cost_mod.zoo_page_overhead(),
        }
    if low == "tpu":
        return {
            "name": "tpu",
            "cpu": cost_mod.TPU_CPU_WEIGHT,
            "mem": cost_mod.TPU_MEM_WEIGHT,
            "network": cost_mod.TPU_NETWORK_WEIGHT,
            "sparse_gather_overhead": cost_mod.TPU_SPARSE_GATHER_OVERHEAD,
            "srht_sketch_overhead": cost_mod.TPU_SRHT_SKETCH_OVERHEAD,
            "countsketch_overhead": cost_mod.TPU_COUNTSKETCH_OVERHEAD,
            "zoo_page_overhead": cost_mod.TPU_ZOO_PAGE_OVERHEAD,
        }
    if low == "ec2":
        return {
            "name": "ec2",
            "cpu": cost_mod.EC2_CPU_WEIGHT,
            "mem": cost_mod.EC2_MEM_WEIGHT,
            "network": cost_mod.EC2_NETWORK_WEIGHT,
            "sparse_gather_overhead": cost_mod.EC2_SPARSE_GATHER_OVERHEAD,
            "srht_sketch_overhead": cost_mod.EC2_SRHT_SKETCH_OVERHEAD,
            "countsketch_overhead": cost_mod.EC2_COUNTSKETCH_OVERHEAD,
            "zoo_page_overhead": cost_mod.EC2_ZOO_PAGE_OVERHEAD,
        }
    if low.startswith(cost_mod.CALIBRATED_PREFIX):
        art = load_calibration_artifact(
            raw[len(cost_mod.CALIBRATED_PREFIX):]
        )
        w = dict(art["weights"])
        w["name"] = "calibrated"
        return w
    raise ValueError(
        f"unknown weight-family spec {spec!r}: expected 'active', 'tpu', "
        f"'ec2' or 'calibrated:<path>'"
    )


def estimator_for_label(label: str):
    """Reconstruct the cost-model candidate a ``candidate_label`` names,
    at the constructor defaults ``LeastSquaresEstimator`` builds its
    candidate set with — the analytic ``cost()`` extractors are what the
    calibrator needs, not a fit-capable configuration. Returns None for
    labels this registry does not know (the caller counts skips; an
    unknown engine must not silently drop out of a report)."""
    name, _, qual = label.partition("[")
    quals = [q for q in qual.rstrip("]").split(",") if q] if qual else []
    if name == "DenseLBFGSwithL2":
        from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSwithL2

        return DenseLBFGSwithL2(lam=1e-4, num_iterations=20)
    if name == "SparseLBFGSwithL2":
        from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2

        solver = "gram" if "gram" in quals else "gather"
        compress = "int16_bf16" if "int16_bf16" in quals else None
        gram_dtype = next((q for q in quals if q in ("f32", "bf16")), None)
        return SparseLBFGSwithL2(
            lam=1e-4, num_iterations=20, solver=solver, compress=compress,
            gram_dtype=gram_dtype,
        )
    if name == "BlockLeastSquaresEstimator":
        from keystone_tpu_torch.ops.learning.block import (
            BlockLeastSquaresEstimator,
        )

        return BlockLeastSquaresEstimator(1000, 3, lam=1e-4)
    if name == "LinearMapEstimator":
        from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator

        return LinearMapEstimator(1e-4)
    if name == "SketchedLeastSquaresEstimator":
        from keystone_tpu_torch.ops.learning.linear import (
            SketchedLeastSquaresEstimator,
        )

        return SketchedLeastSquaresEstimator(lam=1e-4)
    if name == "StreamingLeastSquaresChoice":
        from keystone_tpu_torch.ops.learning.streaming_ls import (
            StreamingLeastSquaresChoice,
        )

        return StreamingLeastSquaresChoice(
            num_iter=3, lam=1e-4, block_size_hint=1024
        )
    if name == "SketchedLeastSquares":
        from keystone_tpu_torch.ops.learning.sketch import SketchedLeastSquares

        return SketchedLeastSquares(lam=1e-4)
    if name == "IterativeHessianSketch":
        from keystone_tpu_torch.ops.learning.sketch import IterativeHessianSketch

        compress = "int16_bf16" if "int16_bf16" in quals else None
        return IterativeHessianSketch(lam=1e-4, compress=compress)
    return None


def _cost_under(est, ctx: Dict[str, Any], cpu: float, mem: float,
                net: float, sparse_overhead: Optional[float],
                srht_overhead: Optional[float] = None,
                cs_overhead: Optional[float] = None) -> float:
    n, d, k, s, m = _geometry(ctx)
    from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.ops.learning.sketch import (
        IterativeHessianSketch, SketchedLeastSquares,
    )

    if isinstance(est, SparseLBFGSwithL2):
        return est.cost(
            n, d, k, s, m, cpu, mem, net,
            sparse_overhead=sparse_overhead,
        )
    if isinstance(est, SketchedLeastSquares):
        return est.cost(
            n, d, k, s, m, cpu, mem, net,
            sketch_overhead=srht_overhead, gather_overhead=sparse_overhead,
        )
    if isinstance(est, IterativeHessianSketch):
        return est.cost(
            n, d, k, s, m, cpu, mem, net,
            sketch_overhead=cs_overhead, gather_overhead=sparse_overhead,
        )
    return est.cost(n, d, k, s, m, cpu, mem, net)


def predict_seconds(label: str, ctx: Dict[str, Any],
                    weights: Dict[str, Any]) -> Optional[float]:
    """Price one candidate at one recorded geometry under an arbitrary
    weight family — how the report re-evaluates a trace under weights
    it was NOT recorded with (drift A/B, refit validation). None when
    the label cannot be reconstructed."""
    est = estimator_for_label(label)
    if est is None:
        return None
    return _cost_under(
        est, ctx, float(weights["cpu"]), float(weights["mem"]),
        float(weights["network"]), weights.get("sparse_gather_overhead"),
        srht_overhead=weights.get("srht_sketch_overhead"),
        cs_overhead=weights.get("countsketch_overhead"),
    )


# ---------------------------------------------------------------------------
# The prediction-error report + mis-route table
# ---------------------------------------------------------------------------


def _median(vals: List[float]) -> Optional[float]:
    return statistics.median(vals) if vals else None


def calibration_report(
    records_or_outcomes,
    weights: Optional[Dict[str, Any]] = None,
    registry: Optional[MetricsRegistry] = None,
    kinds: Sequence[str] = CALIBRATED_DECISIONS,
) -> Dict[str, Any]:
    """The per-engine, per-weight-family prediction-error report.

    ``weights``: a :func:`family_weights` dict to RE-predict every
    candidate under (drift A/B against a family the trace was not
    recorded with); None evaluates the predictions as recorded.
    ``registry``: when given, the ``calibration.*`` metric family is
    published into it — the per-engine ``|log error|`` distributions on
    bucketed histograms plus decision/mis-route counters.
    """
    if records_or_outcomes and isinstance(records_or_outcomes[0], dict):
        outcomes = join_decisions(records_or_outcomes, kinds=kinds)
    else:
        outcomes = list(records_or_outcomes)

    fam_name = (weights or {}).get("name")
    if fam_name is None:
        # As-recorded evaluation: name the family the trace itself
        # carries (all-equal), else "mixed".
        seen = {
            tuple(sorted(o.weights.items()))
            for o in outcomes if o.weights
        }
        fam_name = "as-recorded" if len(seen) <= 1 else "mixed"

    per_engine: Dict[str, Dict[str, Any]] = {}
    errors: List[float] = []
    rows: List[Tuple[DecisionOutcome, float, float]] = []
    skipped_unknown = 0
    measured_by_geometry: Dict[Tuple, List[float]] = {}
    for o in outcomes:
        if o.measured_s is None:
            continue
        measured_by_geometry.setdefault(
            _geometry_key(o.winner, o.context), []
        ).append(o.measured_s)
        if weights is not None:
            predicted = predict_seconds(o.winner, o.context, weights)
            if predicted is None:
                # Not a solver-estimator label (e.g. a mesh_layout
                # decision): it cannot be RE-priced under an arbitrary
                # family, but a joined row with its recorded prediction
                # still belongs in the drift verdict — score it
                # as-recorded, count the skip only when even that is
                # missing. (fit_weights independently excludes these
                # rows from the regression.)
                predicted = o.predicted_s
                if predicted is None:
                    skipped_unknown += 1
                    continue
        else:
            predicted = o.predicted_s
        err = o.log_error(predicted)
        if err is None:
            continue
        rows.append((o, predicted, err))
        errors.append(err)

    for o, predicted, err in rows:
        eng = per_engine.setdefault(o.winner, {
            "count": 0, "_pred": [], "_meas": [], "_err": [],
        })
        eng["count"] += 1
        eng["_pred"].append(predicted)
        eng["_meas"].append(o.measured_s)
        eng["_err"].append(err)

    ratios: Dict[str, float] = {}
    for label, eng in per_engine.items():
        errs = eng.pop("_err")
        med = _median(errs)  # never None: the bucket was fed >= 1 row
        abs_errs = sorted(abs(e) for e in errs)
        eng["median_predicted_s"] = _median(eng.pop("_pred"))
        eng["median_measured_s"] = _median(eng.pop("_meas"))
        eng["median_log_error"] = med
        eng["median_abs_log_error"] = _median(abs_errs)
        eng["max_abs_log_error"] = abs_errs[-1]
        ratios[label] = math.exp(med)

    misroutes = _misroute_table(
        outcomes, weights, ratios, measured_by_geometry
    )
    med_abs = _median([abs(e) for e in errors])
    report = {
        "weights_family": fam_name,
        "weights": {
            k: v for k, v in (weights or {}).items() if k != "name"
        } or None,
        "num_decisions": len(outcomes),
        "num_measured": sum(
            1 for o in outcomes if o.measured_s is not None
        ),
        "num_scored": len(errors),
        # Measurement-convention mix of the scored rows: cold
        # single-run stamps include first-call costs (the executor fits
        # each estimator once) and "spans_queued" rows are enqueue time,
        # so the drift verdict carries this mix for an operator to read.
        "timings": _count_timings(rows),
        "skipped_unknown_engine": skipped_unknown,
        "run_ids": sorted({o.run_id for o in outcomes}),
        "span_counts": _sum_span_counts(outcomes),
        "per_engine": per_engine,
        "median_abs_log_error": med_abs,
        "median_log_error": _median(errors),
        "misroutes": misroutes,
        "total_regret_s": round(
            sum(m["regret_s"] for m in misroutes), 6
        ),
    }
    if registry is not None:
        _publish_metrics(report, rows, registry)
    return report


def _count_timings(rows) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for o, _predicted, _err in rows:
        key = o.timing or "unknown"
        counts[key] = counts.get(key, 0) + 1
    return counts


def _sum_span_counts(outcomes: List[DecisionOutcome]) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for o in outcomes:
        for name, c in o.span_counts.items():
            total[name] = total.get(name, 0) + c
    return total


def _misroute_table(
    outcomes: List[DecisionOutcome],
    weights: Optional[Dict[str, Any]],
    ratios: Dict[str, float],
    measured_by_geometry: Dict[Tuple, List[float]],
) -> List[Dict[str, Any]]:
    """Decisions where a measured-faster feasible candidate lost.

    Evidence per claim, strongest first: a measured outcome of the
    losing engine at the SAME geometry elsewhere in the trace set
    (``evidence="measured"``), else the loser's prediction corrected by
    its engine's own measured error ratio (``evidence="calibrated"``).
    Candidates whose engine has no measured outcomes anywhere make no
    claim at all — a mis-route table must not be built from the very
    predictions under audit."""
    table: List[Dict[str, Any]] = []
    for idx, o in enumerate(outcomes):
        if o.measured_s is None:
            continue
        for c in o.candidates:
            label = c.get("label")
            if label == o.winner or not c.get("feasible"):
                continue
            key = _geometry_key(label, o.context)
            same_geom = measured_by_geometry.get(key)
            if same_geom:
                estimate = _median(same_geom)
                evidence = "measured"
            else:
                if weights is not None:
                    predicted = predict_seconds(label, o.context, weights)
                else:
                    predicted = c.get("cost_s")
                if predicted is None or label not in ratios:
                    continue
                estimate = predicted * ratios[label]
                evidence = "calibrated"
            if estimate is not None and estimate < o.measured_s:
                table.append({
                    "decision_index": idx,
                    "decision": o.decision,
                    "run_id": o.run_id,
                    "winner": o.winner,
                    "winner_measured_s": round(o.measured_s, 6),
                    "faster_candidate": label,
                    "faster_estimate_s": round(estimate, 6),
                    "evidence": evidence,
                    "regret_s": round(o.measured_s - estimate, 6),
                })
    table.sort(key=lambda m: m["regret_s"], reverse=True)
    return table


def _publish_metrics(report, rows, registry: MetricsRegistry) -> None:
    registry.counter(METRIC_CALIBRATION_DECISIONS).add(
        report["num_decisions"]
    )
    registry.counter(METRIC_CALIBRATION_MISROUTES).add(
        len(report["misroutes"])
    )
    registry.counter(METRIC_CALIBRATION_REGRET_S).add(
        report["total_regret_s"]
    )
    for o, _predicted, err in rows:
        registry.bucketed_histogram(
            METRIC_CALIBRATION_ERROR, engine=o.winner,
        ).observe(max(abs(err), 1e-9))


# ---------------------------------------------------------------------------
# Trace-driven refit — THE weight-fitting implementation
# ---------------------------------------------------------------------------


def fit_weights(
    outcomes: List[DecisionOutcome],
    base: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Re-estimate a weight family from measured outcomes.

    (cpu, mem) fit on the SEQUENTIAL-engine rows (dense LBFGS / block /
    exact / streaming — everything whose model has no random-access
    multiplier) under the ``max(cpu·flops, mem·bytes)`` form the
    selector evaluates: closed-form per-row medians seed a log-grid
    search minimizing the median relative error (the one weight-fitting
    implementation; ``scripts/torch_fit_cost_weights.py`` drives it). ``sparse_gather_overhead`` refit from the
    gather-engine rows GIVEN (cpu, mem). The network weight is PINNED
    from ``base`` — single-chip traces cannot observe it. Gram-engine
    rows are evaluation-only (their model mixes the overhead factor
    with a capacity term; the report scores them, the fit does not
    regress on them). The sketched-engine overheads
    (``srht_sketch_overhead`` / ``countsketch_overhead``) refit from
    their engines' rows GIVEN the fitted (cpu, mem, gather overhead):
    each engine's model is AFFINE in its own overhead, so the per-row
    estimate is ``(measured − cost@0) / (cost@1 − cost@0)`` and the
    family takes the median. Row families without measurements keep
    ``base``'s constants, and the result says so (``fitted`` lists what
    was actually re-estimated — no silent caps). Rows timed as
    ``"spans_queued"`` (enqueue time) are left out."""
    from keystone_tpu_torch.ops.learning.lbfgs import SparseLBFGSwithL2
    from keystone_tpu_torch.ops.learning.sketch import (
        IterativeHessianSketch, SketchedLeastSquares,
    )

    base = dict(base or family_weights("active"))
    dense_rows: List[Tuple[float, float, float]] = []  # f_cpu, f_mem, s
    gather_rows: List[Tuple[Any, DecisionOutcome]] = []
    srht_rows: List[Tuple[Any, DecisionOutcome]] = []
    cs_rows: List[Tuple[Any, DecisionOutcome]] = []
    zoo_rows: List[DecisionOutcome] = []
    for o in outcomes:
        if o.measured_s is None or o.measured_s <= 0:
            continue
        if o.timing == QUEUED_TIMING:
            continue
        if o.decision == "placement.zoo_page_in":
            # Zoo page faults carry a tenant id as the winner label, not
            # an estimator name — intercepted here, BEFORE the registry
            # lookup treats them as unknown engines.
            zoo_rows.append(o)
            continue
        est = estimator_for_label(o.winner)
        if est is None:
            continue
        if isinstance(est, SparseLBFGSwithL2):
            if est.solver == "gather":
                gather_rows.append((est, o))
            continue
        if isinstance(est, SketchedLeastSquares):
            srht_rows.append((est, o))
            continue
        if isinstance(est, IterativeHessianSketch):
            cs_rows.append((est, o))
            continue
        f_cpu = _cost_under(est, o.context, 1.0, 0.0, 0.0, None)
        f_mem = _cost_under(est, o.context, 0.0, 1.0, 0.0, None)
        dense_rows.append((f_cpu, f_mem, o.measured_s))

    fitted: List[str] = []
    cpu_w, mem_w = float(base["cpu"]), float(base["mem"])
    if dense_rows:
        cpu_w, mem_w = _fit_max_form(dense_rows, anchor=(cpu_w, mem_w))
        fitted += ["cpu", "mem"]

    overhead = base.get("sparse_gather_overhead")
    if gather_rows:
        samples = []
        for est, o in gather_rows:
            unit = _cost_under(est, o.context, cpu_w, mem_w, 0.0, 1.0)
            if unit > 0:
                samples.append(o.measured_s / unit)
        if samples:
            overhead = _median(samples)
            fitted.append("sparse_gather_overhead")

    def _affine_overhead(rows, kwarg):
        # cost(ov) = c0 + ov·(c1 − c0) given (cpu, mem, gather), so each
        # measured row pins one overhead sample; non-positive samples
        # (the measured wall under the overhead-free floor — a
        # mis-joined or noise row) are dropped, not clamped into the
        # median.
        samples = []
        for est, o in rows:
            c0 = _cost_under(
                est, o.context, cpu_w, mem_w, 0.0, overhead,
                **{kwarg: 0.0},
            )
            c1 = _cost_under(
                est, o.context, cpu_w, mem_w, 0.0, overhead,
                **{kwarg: 1.0},
            )
            if c1 - c0 > 0:
                sample = (o.measured_s - c0) / (c1 - c0)
                if sample > 0:
                    samples.append(sample)
        return _median(samples)

    srht_ov = base.get("srht_sketch_overhead")
    if srht_rows:
        fit = _affine_overhead(srht_rows, "srht_overhead")
        if fit is not None:
            srht_ov = fit
            fitted.append("srht_sketch_overhead")
    cs_ov = base.get("countsketch_overhead")
    if cs_rows:
        fit = _affine_overhead(cs_rows, "cs_overhead")
        if fit is not None:
            cs_ov = fit
            fitted.append("countsketch_overhead")

    zoo_ov = base.get("zoo_page_overhead")
    if zoo_rows:
        # price_page_in is mem_w · overhead · resident_bytes, so each
        # measured page fault pins one overhead sample GIVEN the fitted
        # mem weight; the family takes the median.
        samples = []
        for o in zoo_rows:
            rb = next(
                (c.get("resident_bytes") for c in o.candidates
                 if c.get("label") == o.winner), None,
            )
            if rb is not None and float(rb) > 0 and mem_w > 0:
                sample = o.measured_s / (mem_w * float(rb))
                if sample > 0:
                    samples.append(sample)
        fit = _median(samples)
        if fit is not None:
            zoo_ov = fit
            fitted.append("zoo_page_overhead")

    return {
        "cpu": cpu_w,
        "mem": mem_w,
        "network": float(base["network"]),  # pinned, not fit
        "sparse_gather_overhead": (
            float(overhead) if overhead is not None else None
        ),
        "srht_sketch_overhead": (
            float(srht_ov) if srht_ov is not None else None
        ),
        "countsketch_overhead": (
            float(cs_ov) if cs_ov is not None else None
        ),
        "zoo_page_overhead": (
            float(zoo_ov) if zoo_ov is not None else None
        ),
        "fitted": fitted,
        "num_rows": {
            "sequential": len(dense_rows), "gather": len(gather_rows),
            "srht": len(srht_rows), "countsketch": len(cs_rows),
            "zoo_page": len(zoo_rows),
        },
    }


def _fit_max_form(
    rows: List[Tuple[float, float, float]],
    anchor: Optional[Tuple[float, float]] = None,
) -> Tuple[float, float]:
    """Median-relative-error fit of ``max(cpu·f_cpu, mem·f_mem)`` to the
    measured seconds: per-row closed forms seed a log grid (each row
    pins cpu OR mem exactly when its term dominates).

    ``anchor``: the base family's (cpu, mem). Under the max() form a
    small trace can leave one weight UNDER-determined (every row
    cpu-bound ⇒ any small-enough mem fits equally well) — among grid
    points within 25% of the best median error, the one closest to the
    anchor in log space wins, so a refit deviates from the base
    constants only as far as the measured evidence demands."""

    def rel_err(cpu: float, mem: float) -> float:
        errs = [
            abs(max(cpu * fc, mem * fm) - s) / max(s, 1e-9)
            for fc, fm, s in rows
        ]
        return float(statistics.median(errs))

    cpu0 = statistics.median(
        [s / max(fc, 1e-9) for fc, _fm, s in rows]
    )
    mem0 = statistics.median(
        [s / max(fm, 1e-9) for _fc, fm, s in rows]
    )
    grid = [10.0 ** (e / 4.0) for e in range(-8, 9)]
    candidates = [(cpu0 * s0, mem0 * s1) for s0 in grid for s1 in grid]
    errs = [rel_err(*w) for w in candidates]
    best = min(errs)
    near = [
        w for w, e in zip(candidates, errs)
        if e <= best * 1.25 + 1e-12
    ]
    if anchor is None or anchor[0] <= 0 or anchor[1] <= 0:
        return near[0]

    def log_dist(w: Tuple[float, float]) -> float:
        return abs(math.log(w[0] / anchor[0])) + abs(
            math.log(w[1] / anchor[1])
        )

    return min(near, key=log_dist)


def refit(
    records: Iterable[Dict[str, Any]],
    out_path: Optional[str] = None,
    base: Optional[Dict[str, Any]] = None,
    kinds: Sequence[str] = CALIBRATED_DECISIONS,
) -> Dict[str, Any]:
    """Trace-driven refit: join → fit → (optionally) persist.

    Returns ``{"weights", "before", "after", "artifact_path",
    "outcomes"}`` where ``before``/``after`` are
    :func:`calibration_report` dicts under the base family and the
    refit weights respectively — the evidence a refit must present
    (median |log error| after ≤ before, on the very rows it was fit
    from) — and ``outcomes`` is the joined row list (so callers never
    re-join the trace set). The network weight is pinned from ``base``,
    or to :data:`ONE_CARD_NETWORK_PIN` where ``base`` is the EC2 family;
    ``before`` scores ``base`` as it is."""
    records = list(records)
    outcomes = join_decisions(records, kinds=kinds)
    base = dict(base or family_weights("active"))
    fit_base = dict(base)
    if base.get("name") == "ec2":
        fit_base["network"] = ONE_CARD_NETWORK_PIN
    weights = fit_weights(outcomes, base=fit_base)
    # (Callers print orderings etc. from the returned outcomes — the
    # join over a large trace set runs once, here.)
    eval_weights = {
        "name": "refit",
        "cpu": weights["cpu"], "mem": weights["mem"],
        "network": weights["network"],
        "sparse_gather_overhead": weights["sparse_gather_overhead"],
        "srht_sketch_overhead": weights["srht_sketch_overhead"],
        "countsketch_overhead": weights["countsketch_overhead"],
        "zoo_page_overhead": weights["zoo_page_overhead"],
    }
    before = calibration_report(outcomes, weights=base, kinds=kinds)
    after = calibration_report(outcomes, weights=eval_weights, kinds=kinds)
    artifact_path = None
    if out_path is not None:
        provenance = {
            "base_family": base.get("name", "?"),
            "run_ids": after["run_ids"],
            "num_decisions": after["num_decisions"],
            "num_measured": after["num_measured"],
            "span_counts": after["span_counts"],
            "residuals": {
                "median_abs_log_error": after["median_abs_log_error"],
                "median_abs_log_error_before": (
                    before["median_abs_log_error"]
                ),
                "per_engine": {
                    label: eng["median_abs_log_error"]
                    for label, eng in after["per_engine"].items()
                },
            },
            "fitted": weights["fitted"],
            "num_rows": weights["num_rows"],
        }
        write_calibration_artifact(out_path, weights, provenance)
        artifact_path = out_path
    return {
        "weights": weights,
        "before": before,
        "after": after,
        "artifact_path": artifact_path,
        "outcomes": outcomes,
    }


# ---------------------------------------------------------------------------
# The calibration artifact
# ---------------------------------------------------------------------------


def write_calibration_artifact(
    path: str, weights: Dict[str, Any], provenance: Dict[str, Any],
) -> None:
    """Persist a refit as the versioned, provenance-stamped artifact
    ``KEYSTONE_COST_WEIGHTS=calibrated:<path>`` loads. Atomic
    (``durable.atomic_write_json``): a reader never sees a torn file."""
    from keystone_tpu_torch.data.durable import atomic_write_json

    now = time.time()
    doc = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "weights": {
            "cpu": float(weights["cpu"]),
            "mem": float(weights["mem"]),
            "network": float(weights["network"]),
            "sparse_gather_overhead": (
                float(weights["sparse_gather_overhead"])
                if weights.get("sparse_gather_overhead") is not None
                else None
            ),
            "srht_sketch_overhead": (
                float(weights["srht_sketch_overhead"])
                if weights.get("srht_sketch_overhead") is not None
                else None
            ),
            "countsketch_overhead": (
                float(weights["countsketch_overhead"])
                if weights.get("countsketch_overhead") is not None
                else None
            ),
            "zoo_page_overhead": (
                float(weights["zoo_page_overhead"])
                if weights.get("zoo_page_overhead") is not None
                else None
            ),
        },
        "provenance": {
            **provenance,
            "fit_unix_s": now,
            "fit_date": time.strftime(
                "%Y-%m-%d %H:%M:%S UTC", time.gmtime(now)
            ),
        },
    }
    atomic_write_json(path, doc)


def load_calibration_artifact(path: str) -> Dict[str, Any]:
    """Read + validate a calibration artifact. Raises ValueError naming
    the path on any malformed content — a weight family that cannot be
    parsed must fail loudly at selection time, not mis-price silently."""
    import json

    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(
            f"calibration artifact {path!r} is unreadable: {e}"
        ) from e
    except json.JSONDecodeError as e:
        raise ValueError(
            f"calibration artifact {path!r} is not valid JSON: {e}"
        ) from e
    if not isinstance(doc, dict) or doc.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"calibration artifact {path!r}: format is not "
            f"{ARTIFACT_FORMAT!r}"
        )
    if doc.get("version") != ARTIFACT_VERSION:
        raise ValueError(
            f"calibration artifact {path!r}: version "
            f"{doc.get('version')!r} != supported {ARTIFACT_VERSION}"
        )
    weights = doc.get("weights")
    if not isinstance(weights, dict):
        raise ValueError(
            f"calibration artifact {path!r}: missing weights block"
        )
    for key in ("cpu", "mem", "network"):
        v = weights.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not v > 0:
            raise ValueError(
                f"calibration artifact {path!r}: weights.{key} must be "
                f"a positive number, got {v!r}"
            )
    for opt_key in (
        "sparse_gather_overhead", "srht_sketch_overhead",
        "countsketch_overhead", "zoo_page_overhead",
    ):
        so = weights.get(opt_key)
        if so is not None and (
            not isinstance(so, (int, float)) or isinstance(so, bool)
            or not so > 0
        ):
            raise ValueError(
                f"calibration artifact {path!r}: "
                f"weights.{opt_key} must be a positive number "
                f"or null, got {so!r}"
            )
    return doc


# ---------------------------------------------------------------------------
# The drift gate
# ---------------------------------------------------------------------------


def drift_gate(
    report: Dict[str, Any],
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    registry: Optional[MetricsRegistry] = None,
) -> Dict[str, Any]:
    """State the drift verdict for one calibration report: median
    absolute log error past ``threshold`` is a DETECTED regression —
    published as ``calibration.drift``, flight-noted at WARN, and
    logged, so a mis-predicting cost model fails loudly everywhere the
    obs plane is read instead of silently mis-routing fits."""
    med = report.get("median_abs_log_error")
    worst_engine, worst = None, None
    for label, eng in (report.get("per_engine") or {}).items():
        e = eng.get("median_abs_log_error")
        if e is not None and (worst is None or e > worst):
            worst_engine, worst = label, e
    drifted = med is not None and med > threshold
    verdict = {
        "drifted": drifted,
        "median_abs_log_error": med,
        "threshold": threshold,
        "weights_family": report.get("weights_family"),
        "num_decisions": report.get("num_decisions"),
        "num_scored": report.get("num_scored"),
        "timings": report.get("timings"),
        "worst_engine": worst_engine,
        "worst_engine_median_abs_log_error": worst,
    }
    if registry is not None:
        registry.gauge(METRIC_CALIBRATION_DRIFT).set(1.0 if drifted else 0.0)
    if drifted:
        from keystone_tpu_torch.obs import flight

        flight.flight_note(
            "warn", "calibration.drift",
            weights_family=report.get("weights_family"),
            median_abs_log_error=round(med, 4),
            threshold=threshold,
            worst_engine=worst_engine,
        )
        logger.warning(
            "cost-model drift detected: median |log error| %.3f > %.3f "
            "under the %r weights over %d measured decisions (worst "
            "engine: %s at %.3f) — refit with "
            "python -m keystone_tpu_torch.tools.calibrate --refit",
            med, threshold, report.get("weights_family"),
            report.get("num_scored", 0), worst_engine,
            worst if worst is not None else float("nan"),
        )
    return verdict
