"""Trace-dir summarizer CLI: ``python -m keystone_tpu_torch.tools.trace <dir>``
(port of ``keystone_tpu/tools/trace.py``).

Reads the compact ``events.jsonl`` a traced run wrote
(``KEYSTONE_TRACE=dir`` / ``run.py --trace=dir`` / ``obs.tracing(dir)``)
and prints the three views a postmortem starts from:

  - **Top spans by self-time**: per span name, total wall minus the wall
    of same-thread children — where time actually went, not where it
    was merely enclosed.
  - **Per-lane occupancy**: busy fraction of each IO lane
    (``runtime.task`` spans grouped by their ``lane`` attr) over the
    trace's wall — the overlap picture at a glance.
  - **Cost-decision table**: every ``cost.decision`` event — decision
    kind, winner, reason, the feasible/infeasible candidate split, and
    (when the executor back-annotated the decision with its measured
    outcome) predicted vs measured seconds with the log error per row,
    plus a drift WARNING when the median |log error| exceeds the
    calibration threshold — the audit trail for "why did the optimizer
    run THIS engine" and "was the model right". ``tools.calibrate``
    renders the full per-engine/mis-route analysis and refits.

``--decisions`` prints the merged chronological decision log instead:
every ``*.decision`` event across all six streams (cost, placement,
autoscale, zoo, lifecycle) in timestamp order with stream, kind,
winner, reason, and the weight family it was priced under — the
one-command answer to "what did every resource decider choose, in what
order, under which weights".

``--perfetto OUT.json`` (re-)emits the Chrome-trace projection from the
JSONL rows (e.g. after post-processing, or when only the event log was
shipped off-box). Exits non-zero on an unreadable/invalid trace dir.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.obs.calibrate import DEFAULT_DRIFT_THRESHOLD as \
    DRIFT_THRESHOLD
from keystone_tpu_torch.obs.export import (
    device_of_span_args,
    load_events,
    to_chrome_trace,
    validate_chrome_trace,
)

__all__ = ["main", "summarize"]


def _self_times(spans: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per span NAME: count, total wall, total SELF wall (dur minus
    same-thread children's dur)."""
    child_dur: Dict[Any, int] = defaultdict(int)
    for s in spans:
        if s.get("parent_id") is not None:
            child_dur[s["parent_id"]] += s.get("dur_us", 0)
    agg: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0}
    )
    for s in spans:
        dur = s.get("dur_us", 0)
        row = agg[s["name"]]
        row["count"] += 1
        row["total_s"] += dur / 1e6
        row["self_s"] += max(dur - child_dur.get(s["span_id"], 0), 0) / 1e6
    return dict(agg)


def _lane_occupancy(
    spans: List[Dict[str, Any]], wall_s: float
) -> Dict[str, Dict[str, float]]:
    lanes: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"busy_s": 0.0, "tasks": 0}
    )
    for s in spans:
        if s["name"] != "runtime.task":
            continue
        lane = (s.get("args") or {}).get("lane", "?")
        lanes[lane]["busy_s"] += s.get("dur_us", 0) / 1e6
        lanes[lane]["tasks"] += 1
    for row in lanes.values():
        row["occupancy"] = (row["busy_s"] / wall_s) if wall_s > 0 else 0.0
    return dict(lanes)


def _device_occupancy(
    spans: List[Dict[str, Any]], wall_s: float
) -> Dict[str, Dict[str, float]]:
    """Busy seconds per DEVICE: spans carrying a ``device=`` attr (the
    mesh fold dispatches) plus the per-device ``read.d<k>`` ingestion
    lanes — the table that shows whether an 8-chip run actually kept 8
    chips busy, or one."""
    devs: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"busy_s": 0.0, "spans": 0}
    )
    for s in spans:
        dev = device_of_span_args(s.get("args") or {})
        if dev is None:
            continue
        row = devs[dev]
        row["busy_s"] += s.get("dur_us", 0) / 1e6
        row["spans"] += 1
    for row in devs.values():
        row["occupancy"] = (row["busy_s"] / wall_s) if wall_s > 0 else 0.0
    return dict(devs)


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The structured summary the CLI renders (and tests assert on)."""
    spans = [r for r in records if r.get("type") == "span"]
    events = [r for r in records if r.get("type") == "event"]
    run_ids = sorted({r["run_id"] for r in records if r.get("run_id")})
    if spans:
        t0 = min(s["ts_us"] for s in spans)
        t1 = max(s["ts_us"] + s.get("dur_us", 0) for s in spans)
        wall_s = (t1 - t0) / 1e6
    else:
        wall_s = 0.0
    return {
        "run_ids": run_ids,
        "wall_s": wall_s,
        "num_spans": len(spans),
        "num_events": len(events),
        "self_times": _self_times(spans),
        "lanes": _lane_occupancy(spans, wall_s),
        "devices": _device_occupancy(spans, wall_s),
        "cost_decisions": [
            e.get("args", {}) for e in events
            if e.get("name") == "cost.decision"
        ],
    }


def _render(summary: Dict[str, Any], top: int) -> str:
    lines: List[str] = []
    lines.append(
        f"run {', '.join(summary['run_ids']) or '?'}: "
        f"{summary['num_spans']} spans, {summary['num_events']} events, "
        f"wall {summary['wall_s']:.3f}s"
    )
    lines.append("")
    lines.append(f"top {top} spans by self-time:")
    lines.append(f"  {'name':<32} {'count':>6} {'total_s':>9} {'self_s':>9}")
    ranked = sorted(
        summary["self_times"].items(),
        key=lambda kv: kv[1]["self_s"], reverse=True,
    )[:top]
    for name, row in ranked:
        lines.append(
            f"  {name:<32} {row['count']:>6} {row['total_s']:>9.3f} "
            f"{row['self_s']:>9.3f}"
        )
    if summary["lanes"]:
        lines.append("")
        lines.append("per-lane occupancy (runtime.task):")
        for lane, row in sorted(summary["lanes"].items()):
            lines.append(
                f"  {lane:<12} tasks={int(row['tasks']):>5} "
                f"busy={row['busy_s']:.3f}s "
                f"occupancy={row['occupancy']:.1%}"
            )
    if summary.get("devices"):
        lines.append("")
        lines.append("per-device occupancy (device= spans + read.d<k> lanes):")
        devs = summary["devices"]

        def _dev_key(item):
            name = item[0]
            return (0, int(name)) if name.isdigit() else (1, name)

        for dev, row in sorted(devs.items(), key=_dev_key):
            lines.append(
                f"  device-{dev:<10} spans={int(row['spans']):>5} "
                f"busy={row['busy_s']:.3f}s "
                f"occupancy={row['occupancy']:.1%}"
            )
    decisions = summary["cost_decisions"]
    if decisions:
        lines.append("")
        lines.append("cost decisions (predicted vs measured via the "
                     "back-annotated outcome — obs/calibrate.py):")
        errors = []
        for d in decisions:
            cands = d.get("candidates", [])
            feas = sum(1 for c in cands if c.get("feasible"))
            winner = d.get("winner", "?")
            row = (
                f"  {d.get('decision', '?'):<24} winner={winner} "
                f"reason={d.get('reason', '?')} "
                f"({feas}/{len(cands)} candidates feasible)"
            )
            predicted = next(
                (c.get("cost_s") for c in cands
                 if c.get("label") == winner), None,
            )
            measured = (d.get("outcome") or {}).get("measured_s")
            if measured is not None:
                # Same scoreability guard as DecisionOutcome.log_error:
                # a zero/negative wall (an external stamp) renders as
                # measured-only, never a math domain error.
                err = (
                    math.log(measured / predicted)
                    if predicted and predicted > 0 and measured > 0
                    else None
                )
                if err is not None:
                    errors.append(abs(err))
                err_s = f" log_err={err:+.3f}" if err is not None else ""
                pred_s = (
                    f"{predicted:.4g}s" if predicted is not None
                    else "inf"
                )
                row += (
                    f" predicted={pred_s} measured={measured:.4g}s"
                    f"{err_s}"
                )
            lines.append(row)
        if errors:
            # statistics.median — the same median CONVENTION as
            # drift_gate. (tools.calibrate scores a broader row set —
            # span-window joins, re-prediction — so its verdict is the
            # authoritative one; this warning is the inline tripwire.)
            med = statistics.median(errors)
            if med > DRIFT_THRESHOLD:
                lines.append(
                    f"  WARNING: cost-model drift — median |log error| "
                    f"{med:.3f} > {DRIFT_THRESHOLD} across "
                    f"{len(errors)} measured decisions; audit with "
                    "tools.calibrate (and --refit to re-estimate the "
                    "weights from this trace)"
                )
    return "\n".join(lines)


def _render_decisions(records: List[Dict[str, Any]]) -> str:
    """The merged chronological decision log across every stream."""
    from keystone_tpu_torch.placement.planner import decision_rows

    rows = decision_rows(records)
    lines: List[str] = []
    streams = sorted({r["stream"] for r in rows})
    lines.append(
        f"{len(rows)} decisions across {len(streams)} streams "
        f"({', '.join(streams) or 'none'}):"
    )
    if not rows:
        return "\n".join(lines)
    t0 = rows[0]["ts_us"]
    lines.append(
        f"  {'t_s':>9} {'stream':<20} {'kind':<26} {'winner':<28} "
        f"{'reason':<24} family"
    )
    for r in rows:
        lines.append(
            f"  {(r['ts_us'] - t0) / 1e6:>9.3f} {r['stream']:<20} "
            f"{str(r['kind']):<26} {str(r['winner']):<28} "
            f"{str(r['reason'] or '?'):<24} "
            f"{r['weights_family'] or '?'}"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("trace_dir", help="directory a traced run wrote")
    parser.add_argument("--top", type=int, default=12,
                        help="span names in the self-time table")
    parser.add_argument("--perfetto", default="",
                        help="also (re-)emit the Chrome-trace JSON here")
    parser.add_argument("--decisions", action="store_true",
                        help="print the merged chronological decision "
                             "log (all *.decision streams) instead of "
                             "the span summary")
    args = parser.parse_args(list(argv) if argv is not None else None)
    try:
        records = load_events(args.trace_dir)
    except OSError as e:
        print(f"trace: cannot read {args.trace_dir!r}: {e}",
              file=sys.stderr)
        return 1
    if not records:
        print(f"trace: {args.trace_dir!r} holds no events",
              file=sys.stderr)
        return 1
    if args.decisions:
        print(_render_decisions(records))
        return 0
    print(_render(summarize(records), args.top))
    if args.perfetto:
        doc = to_chrome_trace(records)
        problems = validate_chrome_trace(doc)
        if problems:
            print("trace: refusing to emit an invalid Chrome trace:",
                  file=sys.stderr)
            for p in problems[:10]:
                print(f"  {p}", file=sys.stderr)
            return 1
        out_dir = os.path.dirname(os.path.abspath(args.perfetto))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.perfetto, "w") as f:
            json.dump(doc, f)
        print(f"\nperfetto trace written: {args.perfetto} "
              f"(load at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # Piping the summary through `head` is the normal postmortem
        # workflow; a closed pipe is not an error worth a traceback.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
