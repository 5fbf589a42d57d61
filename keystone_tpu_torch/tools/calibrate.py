"""Cost-model calibration CLI: ``python -m keystone_tpu_torch.tools.calibrate
TRACE_DIR [TRACE_DIR ...]`` (port of ``keystone_tpu/tools/calibrate.py``).

Reads the ``events.jsonl`` of one or more traced runs
(``KEYSTONE_TRACE=dir`` / ``run.py --trace=dir`` / ``obs.tracing(dir)``)
and renders the predicted-vs-measured audit of every ``cost.decision``
the traces carry (``obs/calibrate.py``):

  - **per-engine error table**: decisions joined with the measured
    seconds of the work they priced (back-annotated outcome or
    span-window join), summarized per engine as median predicted /
    measured / signed and absolute log error;
  - **mis-route table**: decisions where a measured-faster feasible
    candidate lost, with the regret in seconds and the evidence class
    (a measured same-geometry outcome, or the loser's calibrated
    estimate);
  - **drift verdict**: OK or DRIFT against the stated threshold —
    DRIFT exits 2, so a mis-predicting cost model fails a scripted
    calibration check the way a failing test fails CI. NO-DATA (no
    decision could be joined with a measurement — tracing was off, or
    the trace holds no cost decisions) exits 3: a gate with zero
    evidence fails closed, it does not pass vacuously.

``--refit OUT.json`` re-estimates the weight family from the traces and
writes the versioned, provenance-stamped calibration artifact that
``KEYSTONE_COST_WEIGHTS=calibrated:OUT.json`` activates, printing the
before/after residuals. The refit pins the network weight, since one
device cannot observe it: the base family's (the ``--weights`` one), or,
where that is the EC2 cluster family, ``cal.ONE_CARD_NETWORK_PIN``.
``--weights ec2|tpu|calibrated:<path>``
evaluates the traces under a family other than the active one (the
drift A/B; the active family is ``ec2`` unless ``KEYSTONE_COST_WEIGHTS``
says otherwise). Exits non-zero on an unreadable trace dir (1), a DRIFT
verdict (2), or NO-DATA (3).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.obs import calibrate as cal
from keystone_tpu_torch.obs.export import load_events

__all__ = ["main", "render_report"]


def _fmt_s(v: Any) -> str:
    return f"{v:.4g}s" if isinstance(v, (int, float)) else "?"


def _fmt_err(v: Any) -> str:
    return f"{v:+.3f}" if isinstance(v, (int, float)) else "?"


def render_report(report: Dict[str, Any], verdict: Dict[str, Any],
                  top_misroutes: int = 10) -> str:
    """The operator view the CLI prints (and tests assert on)."""
    lines: List[str] = []
    lines.append(
        f"calibration: {report['num_decisions']} decisions "
        f"({report['num_measured']} measured, {report['num_scored']} "
        f"scored) under the {report['weights_family']!r} weights, "
        f"runs {', '.join(report['run_ids']) or '?'}"
    )
    if report["skipped_unknown_engine"]:
        lines.append(
            f"  NOTE: {report['skipped_unknown_engine']} measured "
            "decision(s) skipped — engine label unknown to the "
            "candidate registry"
        )
    spans = report.get("span_counts") or {}
    if spans:
        lines.append(
            "  joined spans: " + ", ".join(
                f"{name}={count}" for name, count in sorted(spans.items())
            )
        )
    per_engine = report.get("per_engine") or {}
    if per_engine:
        lines.append("")
        lines.append("per-engine predicted vs measured (log error = "
                     "ln(measured/predicted)):")
        lines.append(
            f"  {'engine':<40} {'n':>4} {'med_pred':>10} {'med_meas':>10} "
            f"{'med_err':>8} {'med|err|':>9} {'max|err|':>9}"
        )
        ranked = sorted(
            per_engine.items(),
            key=lambda kv: kv[1]["median_abs_log_error"], reverse=True,
        )
        for label, eng in ranked:
            lines.append(
                f"  {label:<40} {eng['count']:>4} "
                f"{_fmt_s(eng['median_predicted_s']):>10} "
                f"{_fmt_s(eng['median_measured_s']):>10} "
                f"{_fmt_err(eng['median_log_error']):>8} "
                f"{eng['median_abs_log_error']:>9.3f} "
                f"{eng['max_abs_log_error']:>9.3f}"
            )
    misroutes = report.get("misroutes") or []
    if misroutes:
        lines.append("")
        lines.append(
            f"mis-routes ({len(misroutes)} total, "
            f"{report['total_regret_s']:.3f}s total regret):"
        )
        lines.append(
            f"  {'winner':<36} {'measured':>10} "
            f"{'faster candidate':<36} {'estimate':>10} {'regret':>9} "
            f"evidence"
        )
        for m in misroutes[:top_misroutes]:
            lines.append(
                f"  {m['winner']:<36} {_fmt_s(m['winner_measured_s']):>10} "
                f"{m['faster_candidate']:<36} "
                f"{_fmt_s(m['faster_estimate_s']):>10} "
                f"{m['regret_s']:>8.3f}s {m['evidence']}"
            )
        if len(misroutes) > top_misroutes:
            lines.append(
                f"  ... {len(misroutes) - top_misroutes} more "
                "(--json for the full table)"
            )
    lines.append("")
    if verdict["num_scored"] == 0:
        lines.append(
            "drift verdict: NO-DATA — no decision could be joined with "
            "a measured outcome (trace the fit with KEYSTONE_TRACE=dir)"
        )
    elif verdict["drifted"]:
        lines.append(
            f"drift verdict: DRIFT — median |log error| "
            f"{verdict['median_abs_log_error']:.3f} > threshold "
            f"{verdict['threshold']:.3f} under the "
            f"{verdict['weights_family']!r} weights (worst engine: "
            f"{verdict['worst_engine']} at "
            f"{verdict['worst_engine_median_abs_log_error']:.3f}). "
            "The active cost model is mis-predicting this workload — "
            "refit with --refit OUT.json and activate "
            "KEYSTONE_COST_WEIGHTS=calibrated:OUT.json"
        )
    else:
        lines.append(
            f"drift verdict: OK — median |log error| "
            f"{verdict['median_abs_log_error']:.3f} <= threshold "
            f"{verdict['threshold']:.3f} under the "
            f"{verdict['weights_family']!r} weights"
        )
    return "\n".join(lines)


def _render_refit(result: Dict[str, Any]) -> str:
    w = result["weights"]
    before = result["before"]["median_abs_log_error"]
    after = result["after"]["median_abs_log_error"]
    refitted = ", ".join(w["fitted"]) or "nothing — no fit-capable rows"
    lines = [
        "",
        f"trace-driven refit (re-estimated: {refitted}; "
        f"rows: {w['num_rows']['sequential']} sequential, "
        f"{w['num_rows']['gather']} gather):",
        f"  cpu = {w['cpu']:.3e}",
        f"  mem = {w['mem']:.3e}",
        f"  network = {w['network']:.3e}  # pinned, not fit",
    ]
    if w["sparse_gather_overhead"] is not None:
        lines.append(
            f"  sparse_gather_overhead = {w['sparse_gather_overhead']:.1f}"
        )
    b = f"{before:.3f}" if before is not None else "?"
    a = f"{after:.3f}" if after is not None else "?"
    lines.append(
        f"  median |log error|: {b} (before) -> {a} (refit)"
    )
    if result["artifact_path"]:
        lines.append(
            f"  artifact: {result['artifact_path']} — activate with "
            f"KEYSTONE_COST_WEIGHTS=calibrated:"
            f"{result['artifact_path']}"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-calibrate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "trace_dirs", nargs="+",
        help="trace directories written by traced runs",
    )
    parser.add_argument(
        "--weights", default="active",
        help="weight family to score predictions under: active "
             "(default), ec2, tpu, or calibrated:<artifact.json>",
    )
    parser.add_argument(
        "--threshold", type=float, default=cal.DEFAULT_DRIFT_THRESHOLD,
        help="drift gate: median |log error| past this exits 2 "
             f"(default {cal.DEFAULT_DRIFT_THRESHOLD})",
    )
    parser.add_argument(
        "--refit", default="", metavar="OUT.json",
        help="re-estimate the weight family from these traces and "
             "write the calibration artifact here",
    )
    parser.add_argument(
        "--top-misroutes", type=int, default=10,
        help="mis-route rows to print (the JSON form is unabridged)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the full report + verdict (+ refit) as JSON",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)

    records: List[Dict[str, Any]] = []
    for d in args.trace_dirs:
        try:
            records.extend(load_events(d))
        except (OSError, ValueError) as e:
            # ValueError covers json.JSONDecodeError — a truncated
            # events.jsonl (run killed mid-write) gets the same named
            # diagnostic as a missing dir, not a raw traceback.
            print(f"calibrate: cannot read {d!r}: {e}", file=sys.stderr)
            return 1
    if not records:
        print("calibrate: the trace dirs hold no events", file=sys.stderr)
        return 1

    try:
        weights = cal.family_weights(args.weights)
    except ValueError as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 1

    report = cal.calibration_report(records, weights=weights)
    verdict = cal.drift_gate(report, threshold=args.threshold)
    refit_result = None
    if args.refit:
        if report["num_measured"] == 0:
            # Fail closed here too: an artifact "fit" from zero
            # measured decisions would just re-package the base family
            # as calibrated-looking provenance.
            print(
                "calibrate: refusing --refit — no decision could be "
                "joined with a measured outcome",
                file=sys.stderr,
            )
        else:
            out_dir = os.path.dirname(os.path.abspath(args.refit))
            os.makedirs(out_dir, exist_ok=True)
            refit_result = cal.refit(records, out_path=args.refit,
                                     base=weights)

    if args.json:
        doc = {"report": report, "verdict": verdict}
        if refit_result is not None:
            doc["refit"] = {
                "weights": refit_result["weights"],
                "artifact_path": refit_result["artifact_path"],
                "median_abs_log_error_before": (
                    refit_result["before"]["median_abs_log_error"]
                ),
                "median_abs_log_error_after": (
                    refit_result["after"]["median_abs_log_error"]
                ),
            }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(render_report(report, verdict,
                            top_misroutes=args.top_misroutes))
        if refit_result is not None:
            print(_render_refit(refit_result))
    if verdict["drifted"]:
        return 2
    if verdict["num_scored"] == 0:
        return 3  # NO-DATA fails closed — zero evidence is not a pass
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
