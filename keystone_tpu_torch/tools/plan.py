"""Capacity-planner CLI: ``python -m keystone_tpu_torch.tools.plan <dir>...``
(port of ``keystone_tpu/tools/plan.py``).

Feeds one or more trace dirs (``KEYSTONE_TRACE=dir`` /
``run.py --trace=dir`` / ``with obs.tracing(dir):``) to
:class:`keystone_tpu_torch.placement.planner.CapacityPlanner` and renders:

  - **Baseline**: the measured record — decision count, the weight
    family they were priced under, batch count, p50/p99, the peak
    replica/queue/outstanding occupancy the autoscale stream saw.
  - **1x fidelity**: the admission ticket — every recorded argmin
    decision replayed over its RECORDED candidates must reproduce its
    winner, and every stamped outcome is scored predicted-vs-measured
    on the calibration plane's ``|ln|`` yardstick. Exit 2 when replay
    mismatches or the worst outcome error exceeds the drift threshold:
    a planner that cannot reproduce the past must not predict the
    future.
  - **What-if rows** (one per ``--whatif``): ``traffic=2x`` |
    ``hbm=0.5x`` | ``tenants=+1`` | ``mesh=8x1``, each self-auditing
    (prediction + measured baseline + provenance + assumptions in the
    same dict).

``--json`` emits the full plan dict instead (the scriptable surface).

``--apply PATH`` closes the loop: when (and ONLY when)
the 1x fidelity gate passes, write an auditable serving-defaults
artifact — replica count / queue depth / admission bound sized off the
measured occupancy peaks, an SLO p99 bound calibrated off the measured
tail — that ``run.py serve --from-plan PATH`` consumes, so planner
verdicts reach the serving plane without an operator retyping them.
A planner that cannot reproduce the past must not configure the
future: a failed fidelity gate refuses to write (exit 2).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.obs.export import load_events
from keystone_tpu_torch.placement.planner import (
    CapacityPlanner,
    DEFAULT_DRIFT_THRESHOLD,
    parse_whatif,
)

__all__ = ["main"]


def _fmt_s(v: Optional[float]) -> str:
    return f"{v:.4g}s" if v is not None else "?"


def _render(plan: Dict[str, Any], drift_threshold: float) -> List[str]:
    lines: List[str] = []
    base = plan["baseline"]
    lines.append(
        f"baseline: {base['num_decisions']} decisions "
        f"(family={base['weights_family']}), "
        f"{base['num_batches']} batches, "
        f"p50={_fmt_s(base['measured_p50_s'])} "
        f"p99={_fmt_s(base['measured_p99_s'])}, "
        f"peaks: replicas={base['replicas_peak']} "
        f"queue={base['queue_peak']:g} "
        f"outstanding={base['outstanding_peak']:g}"
    )
    fid = plan["fidelity"]
    ok = fid["num_reproduced"] == fid["num_replayed"]
    worst = fid["max_abs_log_error"]
    drifted = worst is not None and worst > drift_threshold
    lines.append(
        f"1x fidelity: {fid['num_reproduced']}/{fid['num_replayed']} "
        f"argmin winners reproduced, {fid['num_outcomes']} stamped "
        f"outcomes, worst |log error| "
        f"{worst if worst is None else round(worst, 3)} "
        f"(threshold {drift_threshold}) — "
        f"{'OK' if ok and not drifted else 'FAILED'}"
    )
    for m in fid["mismatches"]:
        lines.append(
            f"  MISMATCH {m['kind']}: recorded={m['recorded']} "
            f"replayed={m['replayed']}"
        )
    for row in plan["whatifs"]:
        lines.append("")
        lines.append(f"what-if {row['whatif']}:")
        for key in (
            "predicted_p99_s", "predicted_p99_1x_s", "measured_p99_s",
            "abs_log_error_1x", "whatif_changed_winners",
            "whatif_added_page_seconds", "predicted_page_in_s",
            "measured_page_in_p50_s", "whatif_slowdown_x",
            "recorded_winner", "num_mesh_decisions",
            "measured_num_replayed", "num_page_ins", "note",
        ):
            if key in row and row[key] is not None:
                v = row[key]
                lines.append(
                    f"  {key} = "
                    f"{round(v, 6) if isinstance(v, float) else v}"
                )
        for ch in row.get("changed", []):
            lines.append(
                f"  FLIP {ch['kind']}: {ch['recorded']} -> "
                f"{ch['predicted']}"
            )
        for a in row.get("assumptions", []):
            lines.append(f"  (assumes: {a})")
    return lines


PLAN_ARTIFACT_KIND = "keystone-plan-defaults"


def serve_defaults_from_plan(plan: Dict[str, Any]) -> Dict[str, Any]:
    """Derive the serving-defaults block from a planner verdict: every
    knob is a function of a MEASURED baseline quantity (the occupancy
    peaks the autoscale stream recorded, the batch-latency tail), never
    a guess — the same measured-over-assumed discipline the what-if
    rows follow."""
    base = plan["baseline"]
    replicas_peak = max(1, int(base.get("replicas_peak") or 1))
    # Admission knobs: headroom of 2x over the RECORDED backlog peaks,
    # floored so a quiet trace still yields a servable door.
    occ_peak = max(
        float(base.get("queue_peak") or 0.0),
        float(base.get("outstanding_peak") or 0.0),
        1.0,
    )
    queue_depth = max(64, 1 << math.ceil(math.log2(2.0 * occ_peak)))
    defaults: Dict[str, Any] = {
        "replicas": replicas_peak,
        "queue_depth": queue_depth,
        "min_replicas": 1,
        # Brownout threshold: the ladder engages past the ceiling, set
        # one doubling above the storm's recorded replica peak.
        "max_replicas": 2 * replicas_peak,
    }
    p99_s = base.get("measured_p99_s")
    if p99_s:
        # The SLO bound the brownout/autoscale loop pages on: 3x the
        # measured tail (the reference's calibrated-bound convention),
        # floored at 1 ms so a microbenchmark trace
        # cannot write an unservable objective.
        defaults["slo_p99_ms"] = round(max(3e3 * float(p99_s), 1.0), 3)
        defaults["slo_target"] = 0.99
    return defaults


def write_apply_artifact(path: str, plan: Dict[str, Any],
                         trace_dirs: Sequence[str],
                         drift_threshold: float) -> Dict[str, Any]:
    """Write the ``--apply`` artifact atomically (tmp + rename) and
    return it. The artifact carries its own provenance: the source
    traces, the fidelity verdict it was gated on, and the measured
    baseline each default was derived from."""
    fid = plan["fidelity"]
    doc = {
        "artifact": PLAN_ARTIFACT_KIND,
        "version": 1,
        "written_at_unix_s": round(time.time(), 3),
        "source_traces": [os.path.abspath(d) for d in trace_dirs],
        "fidelity": {
            "num_reproduced": fid["num_reproduced"],
            "num_replayed": fid["num_replayed"],
            "num_outcomes": fid["num_outcomes"],
            "max_abs_log_error": fid["max_abs_log_error"],
            "drift_threshold": drift_threshold,
        },
        "baseline": {
            k: plan["baseline"].get(k)
            for k in ("num_decisions", "weights_family", "num_batches",
                      "measured_p50_s", "measured_p99_s",
                      "replicas_peak", "queue_peak", "outstanding_peak")
        },
        "serve_defaults": serve_defaults_from_plan(plan),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-plan", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("trace_dirs", nargs="+",
                        help="trace directories recorded runs wrote")
    parser.add_argument("--whatif", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="traffic=2x | hbm=0.5x | tenants=+1 | "
                             "mesh=8x1 (repeatable)")
    parser.add_argument("--drift-threshold", type=float,
                        default=DEFAULT_DRIFT_THRESHOLD,
                        help="1x fidelity bound on |ln(pred/measured)| "
                             "(the calibration plane's default)")
    parser.add_argument("--json", action="store_true",
                        help="emit the plan dict as JSON")
    parser.add_argument("--apply", default="", metavar="PATH",
                        help="write the serving-defaults artifact here "
                             "(replicas / queue depth / SLO bound sized "
                             "off the measured baseline) for run.py "
                             "serve --from-plan; REFUSED (exit 2) when "
                             "the fidelity gate fails")
    args = parser.parse_args(list(argv) if argv is not None else None)

    try:
        whatifs = [parse_whatif(s) for s in args.whatif]
    except ValueError as e:
        print(f"plan: {e}", file=sys.stderr)
        return 1
    records: List[Dict[str, Any]] = []
    for d in args.trace_dirs:
        try:
            records.extend(load_events(d))
        except OSError as e:
            print(f"plan: cannot read {d!r}: {e}", file=sys.stderr)
            return 1
    if not records:
        print("plan: no events in "
              f"{', '.join(repr(d) for d in args.trace_dirs)}",
              file=sys.stderr)
        return 1

    planner = CapacityPlanner(records,
                              drift_threshold=args.drift_threshold)
    plan = planner.plan(whatifs)
    if args.json:
        print(json.dumps(plan, indent=2, sort_keys=True))
    else:
        print("\n".join(_render(plan, args.drift_threshold)))
    fid = plan["fidelity"]
    worst = fid["max_abs_log_error"]
    fidelity_ok = fid["num_reproduced"] == fid["num_replayed"] and not (
        worst is not None and worst > args.drift_threshold
    )
    if args.apply:
        if not fidelity_ok:
            # The apply gate: a planner that cannot reproduce the past
            # must not configure the future.
            print(
                f"plan: --apply REFUSED: the 1x fidelity gate failed "
                f"({fid['num_reproduced']}/{fid['num_replayed']} "
                f"reproduced, worst |log error| {worst}) — no defaults "
                "written",
                file=sys.stderr,
            )
            return 2
        doc = write_apply_artifact(args.apply, plan, args.trace_dirs,
                                   args.drift_threshold)
        d = doc["serve_defaults"]
        print(
            f"apply: wrote {args.apply} ("
            + ", ".join(f"{k}={d[k]}" for k in sorted(d))
            + ")"
        )
    if not fidelity_ok:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
