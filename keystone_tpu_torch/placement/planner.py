"""Trace-driven capacity planner: replay a recorded trace through the
placement engine's audit stream and answer what-if questions before any
hardware moves (port of ``keystone_tpu/placement/planner.py``).

The raw material is what ``obs.tracing`` already writes — the six
decision streams (``cost.decision``, ``placement.decision``,
``autoscale.decision``, ``zoo.decision``, ``lifecycle.decision``, plus
the mesh rows riding on ``cost.decision``) and the ``serving.batch``
spans.  Because every decision event records its full candidate table
(label / predicted ``cost_s`` / feasibility / ``resident_bytes``), the
planner can re-run the engine's first-minimum argmin over the RECORDED
candidates under perturbed constraints without re-pricing anything:

* ``traffic=2x`` scales the queueing model's offered load and reports
  the predicted p99 shift against the measured baseline;
* ``hbm=0.5x`` re-applies the feasibility cut (``resident_bytes``
  against the scaled ``hbm_budget_bytes`` each decision recorded) and
  re-argmins, reporting which winners flip;
* ``tenants=+1`` prices the added paging churn from the calibrated
  ``zoo_page_overhead`` family against the trace's measured page-ins;
* ``mesh=8x1`` compares the requested layout's recorded candidate cost
  against the recorded winner's.

Fidelity first: :meth:`CapacityPlanner.fidelity` replays every argmin
decision at 1x and checks the recorded winner reproduces bit for bit,
and compares predicted-vs-measured seconds on every stamped outcome —
the same ``|ln(pred/measured)|`` yardstick, and the same
``DEFAULT_DRIFT_THRESHOLD`` bound, as the calibration plane's drift
gate.  A planner whose 1x replay cannot reproduce the past has no
business predicting the future.

Every what-if row is self-auditing: it carries ``num_decisions``, the
``weights_family`` provenance string, a measured baseline in the same
dict, and an ``assumptions`` list naming the model's simplifications.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from keystone_tpu_torch.obs.calibrate import DEFAULT_DRIFT_THRESHOLD

#: The event names the planner (and ``tools.trace --decisions``) merges
#: into one chronological stream.
DECISION_EVENT_NAMES = (
    "cost.decision",
    "placement.decision",
    "autoscale.decision",
    "zoo.decision",
    "lifecycle.decision",
)

_SERVING_SPAN = "serving.batch"
_INF = float("inf")
_EPS = 1e-9

# Queue-residence predictions saturate here: an occupancy model fed by
# discrete scale-action snapshots cannot resolve loads beyond ~100x.
_MAX_AMPLIFICATION = 100.0


def decision_rows(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Normalize every decision event in ``records`` into one
    chronological table: ``ts_us`` / ``stream`` / ``kind`` / ``winner``
    / ``reason`` / ``weights_family`` / ``candidates`` (+ the raw
    ``args`` for stream-specific fields).  This is the merged view
    ``tools.trace --decisions`` renders and the planner replays."""
    rows: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("type") != "event":
            continue
        name = rec.get("name")
        if name not in DECISION_EVENT_NAMES:
            continue
        args = rec.get("args") or {}
        if name in ("cost.decision", "placement.decision"):
            kind = args.get("decision")
            winner = args.get("winner")
            reason = args.get("reason")
        else:
            action = args.get("action")
            kind = f"{name.split('.')[0]}.{action}"
            winner = args.get("winner") or args.get("tenant") or action
            reason = args.get("reason")
        family = args.get("weights_family")
        if family is None:
            family = (args.get("weights") or {}).get("family")
        rows.append({
            "ts_us": int(rec.get("ts_us") or 0),
            "stream": name,
            "kind": kind,
            "winner": winner,
            "reason": reason,
            "weights_family": family,
            "candidates": list(args.get("candidates") or []),
            "args": args,
        })
    rows.sort(key=lambda r: r["ts_us"])
    return rows


def _percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = (len(sorted_vals) - 1) * q
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


def _abs_log_error(predicted: Optional[float],
                   measured: Optional[float]) -> Optional[float]:
    if predicted is None or measured is None:
        return None
    return abs(math.log(max(float(predicted), _EPS) /
                        max(float(measured), _EPS)))


def parse_whatif(spec: str) -> Tuple[str, Any]:
    """Parse one ``--whatif`` spec: ``traffic=2x`` | ``hbm=0.5x`` |
    ``tenants=+1`` | ``mesh=8x1``."""
    key, sep, val = spec.partition("=")
    key = key.strip().lower()
    val = val.strip()
    if not sep or not val:
        raise ValueError(f"what-if spec needs key=value, got {spec!r}")
    if key in ("traffic", "hbm"):
        return key, float(val[:-1] if val.lower().endswith("x") else val)
    if key == "tenants":
        return key, int(val.lstrip("+"))
    if key == "mesh":
        p, sep2, q = val.lower().partition("x")
        if not sep2:
            raise ValueError(f"mesh what-if wants PxQ (e.g. 8x1), got {val!r}")
        return key, f"mesh[data={int(p)},model={int(q)}]"
    raise ValueError(
        f"unknown what-if {key!r} (have: traffic, hbm, tenants, mesh)")


class CapacityPlanner:
    """Replays one recorded trace's decision streams; see the module
    docstring for the model and its honesty constraints."""

    def __init__(self, records: Sequence[Dict[str, Any]],
                 drift_threshold: float = DEFAULT_DRIFT_THRESHOLD):
        self.records = list(records)
        self.rows = decision_rows(self.records)
        self.drift_threshold = float(drift_threshold)
        self.batch_latencies_s = sorted(
            r["dur_us"] / 1e6 for r in self.records
            if r.get("type") == "span" and r.get("name") == _SERVING_SPAN
            and r.get("dur_us") is not None
        )
        # Occupancy snapshots ride on the autoscale stream's inputs
        # (replicas / queue_depth / outstanding at each action).
        self.occupancy = [
            {
                "ts_us": row["ts_us"],
                "replicas": int(inputs.get("replicas") or 0),
                "queue_depth": float(inputs.get("queue_depth") or 0.0),
                "outstanding": float(inputs.get("outstanding") or 0.0),
            }
            for row in self.rows if row["stream"] == "autoscale.decision"
            for inputs in [row["args"].get("inputs") or {}]
        ]

    # ------------------------------------------------------------------
    # provenance / baseline

    def weights_family(self) -> str:
        families = Counter(
            row["weights_family"] for row in self.rows
            if row["weights_family"])
        if not families:
            return "unknown"
        return families.most_common(1)[0][0]

    def baseline(self) -> Dict[str, Any]:
        lat = self.batch_latencies_s
        return {
            "num_decisions": len(self.rows),
            "weights_family": self.weights_family(),
            "num_batches": len(lat),
            "measured_p50_s": _percentile(lat, 0.50),
            "measured_p99_s": _percentile(lat, 0.99),
            "replicas_peak": max(
                (p["replicas"] for p in self.occupancy), default=0),
            "queue_peak": max(
                (p["queue_depth"] for p in self.occupancy), default=0.0),
            "outstanding_peak": max(
                (p["outstanding"] for p in self.occupancy), default=0.0),
        }

    # ------------------------------------------------------------------
    # 1x fidelity — the planner's admission ticket

    def fidelity(self) -> Dict[str, Any]:
        """Replay every recorded argmin decision over its RECORDED
        candidates and check the winner reproduces; compare predicted vs
        measured seconds wherever an outcome was stamped."""
        replayed = reproduced = 0
        mismatches: List[Dict[str, Any]] = []
        errors: List[float] = []
        for row in self.rows:
            if row["stream"] not in ("cost.decision", "placement.decision"):
                continue
            cands = row["candidates"]
            if cands and row["reason"] in ("argmin", "least_resident_fallback"):
                winner = self._re_argmin(cands)
                replayed += 1
                if winner == row["winner"]:
                    reproduced += 1
                else:
                    mismatches.append({
                        "kind": row["kind"], "recorded": row["winner"],
                        "replayed": winner,
                    })
            outcome = row["args"].get("outcome") or {}
            measured = outcome.get("measured_s")
            predicted = self._winner_cost(row)
            err = _abs_log_error(predicted, measured)
            if err is not None:
                errors.append(err)
        return {
            "num_decisions": len(self.rows),
            "num_replayed": replayed,
            "num_reproduced": reproduced,
            "mismatches": mismatches,
            "num_outcomes": len(errors),
            "max_abs_log_error": max(errors) if errors else None,
            "drift_threshold": self.drift_threshold,
            "weights_family": self.weights_family(),
        }

    # ------------------------------------------------------------------
    # the queueing model (traffic what-ifs)

    def predict_p99_s(self, traffic: float = 1.0) -> Optional[float]:
        """Predicted tail latency at ``traffic`` x the recorded offered
        load: per-batch service floor (measured p50) amplified by queue
        residence — backlog spread across the replicas the trace
        actually reached.  Deliberately coarse (see ``assumptions`` on
        every what-if row); its job is ranking what-ifs against a
        measured baseline inside the calibration plane's error bars,
        not nanosecond forecasting."""
        service = _percentile(self.batch_latencies_s, 0.50)
        if service is None:
            return None
        base = self.baseline()
        backlog = base["queue_peak"] + base["outstanding_peak"]
        replicas = max(base["replicas_peak"], 1)
        amplification = 1.0 + float(traffic) * backlog / replicas
        return service * min(amplification, _MAX_AMPLIFICATION)

    # ------------------------------------------------------------------
    # what-ifs

    def whatif(self, key: str, value: Any) -> Dict[str, Any]:
        if key == "traffic":
            return self.whatif_traffic(float(value))
        if key == "hbm":
            return self.whatif_hbm(float(value))
        if key == "tenants":
            return self.whatif_tenants(int(value))
        if key == "mesh":
            return self.whatif_mesh(str(value))
        raise ValueError(f"unknown what-if {key!r}")

    def whatif_traffic(self, multiplier: float) -> Dict[str, Any]:
        base = self.baseline()
        p99_1x = self.predict_p99_s(1.0)
        p99_m = self.predict_p99_s(multiplier)
        return {
            "whatif": f"traffic={multiplier:g}x",
            "num_decisions": base["num_decisions"],
            "weights_family": base["weights_family"],
            "measured_p99_s": base["measured_p99_s"],
            "predicted_p99_s": p99_m,
            "predicted_p99_1x_s": p99_1x,
            "abs_log_error_1x": _abs_log_error(p99_1x, base["measured_p99_s"]),
            "replicas_peak": base["replicas_peak"],
            "assumptions": [
                "offered load scales backlog linearly; replica count "
                "capped at the trace's recorded peak",
                "per-batch service floor = measured p50",
            ],
        }

    def whatif_hbm(self, scale: float) -> Dict[str, Any]:
        base = self.baseline()
        replayed = 0
        changed: List[Dict[str, Any]] = []
        for row in self.rows:
            if row["stream"] not in ("cost.decision", "placement.decision"):
                continue
            budget = row["args"].get("hbm_budget_bytes")
            cands = row["candidates"]
            if not cands or not budget:
                continue
            replayed += 1
            winner = self._re_argmin(cands, budget_bytes=float(budget) * scale)
            if winner != row["winner"]:
                changed.append({
                    "kind": row["kind"], "recorded": row["winner"],
                    "predicted": winner,
                })
        return {
            "whatif": f"hbm={scale:g}x",
            "num_decisions": base["num_decisions"],
            "weights_family": base["weights_family"],
            "measured_p99_s": base["measured_p99_s"],
            "measured_num_replayed": replayed,
            "whatif_changed_winners": len(changed),
            "changed": changed,
            "assumptions": [
                "recorded candidate costs held fixed; only the "
                "resident_bytes-vs-budget feasibility cut moves",
            ],
        }

    def whatif_tenants(self, extra: int) -> Dict[str, Any]:
        base = self.baseline()
        page_bytes: List[float] = []
        page_measured: List[float] = []
        for row in self.rows:
            if row["kind"] == "placement.zoo_page_in":
                for c in row["candidates"]:
                    if c.get("resident_bytes"):
                        page_bytes.append(float(c["resident_bytes"]))
                measured = (row["args"].get("outcome") or {}).get("measured_s")
                if measured:
                    page_measured.append(float(measured))
            elif row["kind"] == "zoo.page_in":
                inputs = row["args"].get("inputs") or {}
                if inputs.get("resident_bytes"):
                    page_bytes.append(float(inputs["resident_bytes"]))
                if inputs.get("page_in_s"):
                    page_measured.append(float(inputs["page_in_s"]))
        out: Dict[str, Any] = {
            "whatif": f"tenants=+{extra}",
            "num_decisions": base["num_decisions"],
            "weights_family": base["weights_family"],
            "measured_p99_s": base["measured_p99_s"],
            "num_page_ins": len(page_measured),
            "measured_page_in_p50_s": _percentile(sorted(page_measured), 0.50),
            "assumptions": [
                "each added tenant pages the trace's median tenant "
                "footprint per churn event",
            ],
        }
        if page_bytes:
            from keystone_tpu_torch.placement.engine import PlacementEngine

            sorted_bytes = sorted(page_bytes)
            median_bytes = _percentile(sorted_bytes, 0.50)
            predicted = PlacementEngine().price_page_in(int(median_bytes))
            out["median_tenant_bytes"] = median_bytes
            out["predicted_page_in_s"] = predicted
            out["whatif_added_page_seconds"] = extra * predicted
        else:
            out["note"] = "no zoo paging in trace; nothing to price"
        return out

    def whatif_mesh(self, layout_label: str) -> Dict[str, Any]:
        base = self.baseline()
        ratios: List[float] = []
        recorded_winners: List[str] = []
        for row in self.rows:
            if row["kind"] not in ("mesh_layout", "placement.mesh_layout"):
                continue
            by_label = {c.get("label"): c for c in row["candidates"]}
            want = by_label.get(layout_label)
            won = by_label.get(row["winner"])
            if not want or not won:
                continue
            if want.get("cost_s") and won.get("cost_s"):
                ratios.append(float(want["cost_s"]) / float(won["cost_s"]))
                recorded_winners.append(row["winner"])
        out: Dict[str, Any] = {
            "whatif": f"mesh={layout_label}",
            "num_decisions": base["num_decisions"],
            "weights_family": base["weights_family"],
            "measured_p99_s": base["measured_p99_s"],
            "num_mesh_decisions": len(ratios),
            "assumptions": [
                "requested layout priced from the candidate table each "
                "mesh decision recorded",
            ],
        }
        if ratios:
            out["recorded_winner"] = Counter(
                recorded_winners).most_common(1)[0][0]
            out["whatif_slowdown_x"] = _percentile(sorted(ratios), 0.50)
        else:
            out["note"] = (
                f"no mesh decision in trace priced candidate {layout_label}")
        return out

    def plan(self, whatifs: Sequence[Tuple[str, Any]] = ()) -> Dict[str, Any]:
        return {
            "baseline": self.baseline(),
            "fidelity": self.fidelity(),
            "whatifs": [self.whatif(k, v) for k, v in whatifs],
        }

    # ------------------------------------------------------------------
    # internals

    @staticmethod
    def _re_argmin(candidates: Sequence[Dict[str, Any]],
                   budget_bytes: Optional[float] = None) -> Optional[str]:
        """The engine's first-minimum argmin over RECORDED candidates,
        optionally re-cutting feasibility at a perturbed device budget;
        all-infeasible falls back to least resident_bytes — the same
        deterministic resolution the live sites use."""
        costs = []
        for c in candidates:
            cost = c.get("cost_s")
            feasible = bool(c.get("feasible", cost is not None))
            if budget_bytes is not None and c.get("resident_bytes") is not None:
                feasible = feasible and float(c["resident_bytes"]) <= budget_bytes
            costs.append(float(cost) if (feasible and cost is not None)
                         else _INF)
        if not costs:
            return None
        if all(math.isinf(x) for x in costs):
            index = min(
                range(len(candidates)),
                key=lambda i: float(candidates[i].get("resident_bytes", _INF)),
            )
        else:
            index = min(range(len(costs)), key=costs.__getitem__)
        return candidates[index].get("label")

    @staticmethod
    def _winner_cost(row: Dict[str, Any]) -> Optional[float]:
        for c in row["candidates"]:
            if c.get("label") == row["winner"]:
                return c.get("cost_s")
        return None
