"""SLO snapshot renderer CLI: ``python -m keystone_tpu_torch.tools.slo <dir>``
(port of ``keystone_tpu/tools/slo.py``).

Reads the atomic ``live_metrics.json`` snapshot the live exporter
writes (``obs/live.py`` — ``run.py serve --metrics-dir=DIR``, or any
:class:`~keystone_tpu_torch.obs.live.LiveExporter` with a ``snapshot_dir``)
and renders the operator view of the live plane:

  - per-objective SLO table: state, fast/slow burn rates, budget
    spent/remaining, good/bad totals;
  - the transition log (when a breach happened and at what burn);
  - the error-budget ledger (which state interval spent what);
  - the autoscale decision log beside the verdict table, when the
    snapshot carries an ``autoscale`` section (``run.py serve
    --autoscale``): replica count/bounds, scale counters, brownout
    state, and the audited decisions — action, reason, inputs;
  - the lifecycle publication summary + decision log when the snapshot
    carries a ``lifecycle`` section (``run.py learn``): candidates
    published/rejected/rolled back, canary promotions, the current
    model staleness beside the incumbent fingerprint, and the audited
    publication decisions — plus the trainer's fold/resume counters
    from the ``trainer`` section;
  - the per-tenant verdict table when the snapshot carries a ``zoo``
    section (``run.py serve --tenants N``): per tenant — SLO state,
    burn rates, budget spent, admission shares, residency and the
    front-door accounting — beside the zoo paging summary and its
    decision log;
  - a one-line serving summary when the snapshot carries a
    ``serving`` section (completed/rejected/failed + p99).

Scrape-less by design: no HTTP, no server — a file read, so it works
over ssh/cron exactly like ``tools.trace`` works on a trace dir. Exits
non-zero on an unreadable/empty snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch.obs.live import SNAPSHOT_FILE

__all__ = ["main", "render"]


def load_snapshot(path: str) -> Dict[str, Any]:
    """Accept the snapshot file itself or the directory holding it."""
    if os.path.isdir(path):
        path = os.path.join(path, SNAPSHOT_FILE)
    with open(path) as f:
        return json.load(f)


def _fmt_burn(v: Any) -> str:
    return f"{v:.2f}x" if isinstance(v, (int, float)) else "?"


def render(doc: Dict[str, Any]) -> str:
    lines: List[str] = []
    ts = doc.get("ts")
    age = f", {time.time() - ts:.1f}s old" if isinstance(ts, (int, float)) \
        else ""
    lines.append(f"live snapshot seq={doc.get('seq', '?')}{age}")
    slo = doc.get("slo") or {}
    objectives: Dict[str, Dict[str, Any]] = slo.get("objectives") or {}
    if objectives:
        lines.append("")
        lines.append(f"SLO verdict: {slo.get('state', '?')}")
        lines.append(
            f"  {'objective':<16} {'state':<7} {'burn_fast':>9} "
            f"{'burn_slow':>9} {'budget_spent':>12} {'remaining':>10} "
            f"{'good':>8} {'bad':>6}"
        )
        for name, o in sorted(objectives.items()):
            spent = o.get("budget_spent_fraction")
            remaining = o.get("budget_remaining_fraction")
            spent_s = f"{spent:.1%}" if isinstance(spent, (int, float)) \
                else "?"
            rem_s = f"{remaining:.1%}" \
                if isinstance(remaining, (int, float)) else "?"
            lines.append(
                f"  {name:<16} {o.get('state', '?'):<7} "
                f"{_fmt_burn(o.get('burn_fast')):>9} "
                f"{_fmt_burn(o.get('burn_slow')):>9} "
                f"{spent_s:>12} {rem_s:>10} "
                f"{o.get('good_total', 0):>8} {o.get('bad_total', 0):>6}"
            )
        for name, o in sorted(objectives.items()):
            transitions = o.get("transitions") or []
            if transitions:
                lines.append("")
                lines.append(f"  {name} transitions:")
                for t in transitions:
                    lines.append(
                        f"    t+{t.get('t_s', 0):.3f}s "
                        f"{t.get('from', '?')} -> {t.get('to', '?')} "
                        f"(burn_fast {_fmt_burn(t.get('burn_fast'))}, "
                        f"budget {t.get('budget_spent_fraction', 0):.1%} "
                        f"spent)"
                    )
            ledger = o.get("ledger") or []
            if len(ledger) > 1:
                lines.append(f"  {name} budget ledger:")
                for e in ledger:
                    t_end = e.get("t_end")
                    end_s = f"{t_end:.3f}s" if isinstance(
                        t_end, (int, float)) else "now"
                    lines.append(
                        f"    [{e.get('state', '?'):<7}] "
                        f"t+{e.get('t_start', 0):.3f}s..{end_s}  "
                        f"good={e.get('good', 0)} bad={e.get('bad', 0)}"
                    )
    else:
        lines.append("(no SLO objectives in this snapshot)")
    autoscale = doc.get("autoscale") or {}
    if autoscale:
        lines.append("")
        lines.append(
            f"autoscale: replicas={autoscale.get('replicas', '?')} "
            f"(bounds {autoscale.get('min_replicas', '?')}.."
            f"{autoscale.get('max_replicas', '?')}, observed "
            f"{autoscale.get('replicas_low', '?')}.."
            f"{autoscale.get('replicas_high', '?')}) "
            f"scale_ups={autoscale.get('scale_ups', 0)} "
            f"scale_downs={autoscale.get('scale_downs', 0)} "
            f"brownout_level={autoscale.get('brownout_level', 0)}"
            + (f" steps={autoscale['brownout_steps']}"
               if autoscale.get("brownout_steps") else "")
        )
        decisions = autoscale.get("decisions") or []
        if decisions:
            lines.append("  decision log:")
            for d in decisions:
                inputs = d.get("inputs") or {}
                step = f":{d['step']}" if d.get("step") else ""
                ok = "" if d.get("ok", True) else " FAILED"
                lines.append(
                    f"    t+{d.get('t_s', 0):.3f}s "
                    f"{d.get('action', '?')}{step}{ok} "
                    f"(state={inputs.get('state', '?')} "
                    f"burn_fast={_fmt_burn(inputs.get('burn_fast'))} "
                    f"replicas={inputs.get('replicas', '?')} "
                    f"queue={inputs.get('queue_depth', '?')}) — "
                    f"{d.get('reason', '')}"
                )
    lifecycle = doc.get("lifecycle") or {}
    if lifecycle:
        stale = lifecycle.get("staleness_s")
        stale_s = f"{stale:.3f}s" if isinstance(stale, (int, float)) \
            else "-"
        med = lifecycle.get("staleness_median_s")
        med_s = f"{med:.3f}s" if isinstance(med, (int, float)) else "-"
        lines.append("")
        lines.append(
            f"lifecycle: published={lifecycle.get('published', 0)} "
            f"rejected={lifecycle.get('rejected', 0)} "
            f"rollbacks={lifecycle.get('rollbacks', 0)} "
            f"canary_promotions={lifecycle.get('canary_promotions', 0)} "
            f"staleness={stale_s} (median {med_s}, "
            f"n={lifecycle.get('staleness_num_samples', 0)}) "
            f"incumbent={lifecycle.get('incumbent_fingerprint', '?')}"
            + (" [attribution window OPEN]"
               if lifecycle.get("attribution_open") else "")
        )
        decisions = lifecycle.get("decisions") or []
        if decisions:
            lines.append("  publication decision log:")
            for d in decisions:
                ok = "" if d.get("ok", True) else " FAILED"
                lines.append(
                    f"    t+{d.get('t_s', 0):.3f}s "
                    f"{d.get('action', '?')}:"
                    f"{d.get('fingerprint') or '<unexported>'}{ok} "
                    f"— {d.get('reason', '')}"
                )
    trainer = doc.get("trainer") or {}
    if trainer:
        lines.append(
            f"trainer: segments_fit={trainer.get('segments_fit', 0)}/"
            f"{trainer.get('num_segments', '?')} "
            f"resumes={trainer.get('resumes', 0)} "
            f"publishes={trainer.get('publishes', 0)}"
            + (f" ERROR={trainer['error']}"
               if trainer.get("error") else "")
        )
    zoo = doc.get("zoo") or {}
    if zoo.get("tenants"):
        lines.append("")
        lines.append(
            f"zoo: tenants={zoo.get('num_tenants', '?')} "
            f"residents={zoo.get('residents', '?')} "
            f"resident_bytes={zoo.get('resident_bytes', '?')}/"
            f"{zoo.get('budget_bytes', '?')} "
            f"page_ins={zoo.get('page_ins', 0)} "
            f"page_outs={zoo.get('page_outs', 0)} "
            f"quarantined={zoo.get('quarantined', 0)} "
            f"coldstart_failfast={zoo.get('coldstart_failfast', 0)} "
            f"accounting_ok={zoo.get('accounting_ok', '?')}"
        )
        lines.append(
            f"  {'tenant':<12} {'state':<7} {'burn_fast':>9} "
            f"{'burn_slow':>9} {'budget_spent':>12} {'share':>6} "
            f"{'offered':>8} {'done':>8} {'rej':>6} {'fail':>5} "
            f"{'residency':<10}"
        )
        for name, t in sorted(zoo["tenants"].items()):
            slo_t = t.get("slo") or {}
            objectives = slo_t.get("objectives") or {}
            burn_fast = burn_slow = spent = None
            for o in objectives.values():
                if burn_fast is None or (o.get("burn_fast") or 0) > burn_fast:
                    burn_fast = o.get("burn_fast")
                    burn_slow = o.get("burn_slow")
                    spent = o.get("budget_spent_fraction")
            spent_s = f"{spent:.1%}" if isinstance(spent, (int, float)) \
                else "?"
            residency = (
                "QUARANTINE" if t.get("quarantined")
                else "resident" if t.get("resident") else "paged"
            )
            lines.append(
                f"  {name:<12} {slo_t.get('state', '-'):<7} "
                f"{_fmt_burn(burn_fast):>9} {_fmt_burn(burn_slow):>9} "
                f"{spent_s:>12} "
                f"{t.get('admission_share', 0):>6.2f} "
                f"{t.get('offered', 0):>8} {t.get('completed', 0):>8} "
                f"{t.get('rejected', 0):>6} {t.get('failed', 0):>5} "
                f"{residency:<10}"
            )
        decisions = zoo.get("decisions") or []
        if decisions:
            lines.append("  paging decision log:")
            for d in decisions:
                ok = "" if d.get("ok", True) else " FAILED"
                lines.append(
                    f"    t+{d.get('t_s', 0):.3f}s "
                    f"{d.get('action', '?')}:{d.get('tenant', '?')}{ok} "
                    f"— {d.get('reason', '')}"
                )
    serving = doc.get("serving") or {}
    if serving:
        p99 = serving.get("p99_latency_s")
        p99_s = f"{p99 * 1e3:.2f}ms" if isinstance(p99, (int, float)) \
            else "?"
        lines.append("")
        lines.append(
            f"serving: completed={serving.get('completed', '?')} "
            f"rejected={serving.get('rejected', '?')} "
            f"failed={serving.get('failed', '?')} p99={p99_s}"
            + (f" healthy_replicas={serving['healthy_replicas']}"
               if "healthy_replicas" in serving else "")
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "keystone-slo", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "snapshot",
        help=f"snapshot dir (holding {SNAPSHOT_FILE}) or the file itself",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)
    try:
        doc = load_snapshot(args.snapshot)
    except (OSError, json.JSONDecodeError) as e:
        print(f"slo: cannot read {args.snapshot!r}: {e}", file=sys.stderr)
        return 1
    if not doc:
        print(f"slo: {args.snapshot!r} holds an empty snapshot",
              file=sys.stderr)
        return 1
    print(render(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
