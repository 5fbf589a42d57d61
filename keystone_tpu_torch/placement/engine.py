"""The global placement engine: one audited scheduler over the cost model
(port of ``keystone_tpu/placement/engine.py``).

Every resource decision — which solver/storage plan an estimator runs
(ops/learning/cost.py), how many serving replicas stay up, which zoo
tenant pages in or is evicted, which lifecycle gate fires — is a
*placement* of work onto priced resources, folded onto one template:

* a candidate is a dict with a ``label`` and a predicted ``cost_s``
  (``float("inf")`` marks infeasible) plus whatever site-specific
  fields make the audit legible (``resident_bytes``, ``host_ok``, …);
* the winner of a priced decision is the FIRST minimum —
  ``int(np.argmin)`` semantics — so adapting a legacy site preserves
  its recorded tie-breaks bit for bit;
* every decision, argmin-chosen (:meth:`PlacementEngine.decide`) or
  policy-chosen (:meth:`PlacementEngine.audit`, for sites whose winner
  is a threshold policy that the engine prices for the record), emits
  one ``placement.decision`` instant event on the port's tracer carrying
  ``candidates`` / ``winner`` / ``reason`` / ``weights_family``.

Decision kinds are namespaced ``placement.*`` strings (``KIND_*``
below), disjoint from the ``cost.decision`` kinds.

Differences from the reference: the default weight family is ``ec2``
(``ops/learning/cost.py``; the reference's default is its TPU family), so
:func:`active_family` names ``ec2`` when ``KEYSTONE_COST_WEIGHTS`` is
unset. It imports nothing of the cost model, so control-plane threads
stamp provenance cheaply, and :meth:`PlacementEngine.price_page_in` imports
it lazily. The capacity planner that replays this stream is
``placement/planner.py``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from keystone_tpu_torch import obs

# The unified audit stream every placement decision lands on.
PLACEMENT_EVENT = "placement.decision"

# Decision kinds — namespaced so they can never collide with the
# cost.decision kinds calibrate.py already joins ("least_squares_solver",
# "calibration_sweep", "mesh_layout").
KIND_SOLVER = "placement.solver"
KIND_MESH = "placement.mesh_layout"
KIND_IMAGE_TIER = "placement.image_tier"
KIND_REPLICAS = "placement.replica_count"
KIND_BROWNOUT = "placement.brownout"
KIND_ZOO_EVICT = "placement.zoo_evict"
KIND_ZOO_PAGE_IN = "placement.zoo_page_in"
KIND_LIFECYCLE = "placement.lifecycle"

ALL_KINDS = (
    KIND_SOLVER,
    KIND_MESH,
    KIND_IMAGE_TIER,
    KIND_REPLICAS,
    KIND_BROWNOUT,
    KIND_ZOO_EVICT,
    KIND_ZOO_PAGE_IN,
    KIND_LIFECYCLE,
)

_INF = float("inf")


def active_family() -> str:
    """Name of the weight family ``KEYSTONE_COST_WEIGHTS`` selects.

    Mirrors ``cost.weights_family_name()`` — "ec2" (the port's default),
    "tpu" or "calibrated" — without importing the cost module, so
    control-plane threads can stamp provenance cheaply. An unparseable spec
    maps to "custom" rather than raising: provenance stamping must never
    take down a decision site.
    """
    raw = (os.environ.get("KEYSTONE_COST_WEIGHTS") or "").strip()
    if not raw:
        return "ec2"
    lowered = raw.lower()
    if lowered in ("tpu", "ec2"):
        return lowered
    if lowered.startswith("calibrated:"):
        return "calibrated"
    return "custom"


@dataclass(frozen=True)
class PlacementChoice:
    """What :meth:`PlacementEngine.decide` resolved: the winning
    candidate's index/label, the reason string recorded on the audit
    event, and the outcome ref a caller stamps measured seconds onto."""

    kind: str
    winner: str
    index: int
    reason: str
    ref: Optional[obs.CostOutcomeRef] = field(default=None, compare=False)


class PlacementEngine:
    """Prices candidates, picks (or records) a winner, and emits the
    unified ``placement.decision`` audit event.

    ``weights_family`` defaults to the env-resolved family; adapter
    sites that computed costs under explicitly-passed weights override
    it with "custom" to keep provenance honest.  ``metrics`` is an
    optional :class:`obs.MetricsRegistry` for the ``placement.*``
    counters in the metric catalogue.
    """

    def __init__(self, weights_family: Optional[str] = None,
                 metrics: Optional[Any] = None):
        self.weights_family = (
            weights_family if weights_family is not None else active_family()
        )
        self._metrics = metrics

    # ------------------------------------------------------------------
    # decisions

    def decide(self, kind: str, candidates: Sequence[Dict[str, Any]], *,
               context: Optional[Dict[str, Any]] = None,
               fallback: Optional[str] = None,
               reason: str = "argmin") -> PlacementChoice:
        """Pick the first-minimum ``cost_s`` candidate and audit it.

        ``cost_s`` of ``float("inf")`` (or ``None``) marks a candidate
        infeasible.  When every candidate is infeasible the engine
        applies ``fallback``: ``"least_resident"`` picks the smallest
        ``resident_bytes`` (first on ties — the legacy
        ``least_resident_fallback`` semantics of cost.py's optimizer);
        ``None`` raises ``ValueError`` (the legacy mesh/image-tier
        behaviour, where the caller owns the error message and raises
        before consulting the engine).
        """
        if not candidates:
            raise ValueError(f"{kind}: no candidates to place")
        costs = [self._cost_of(c) for c in candidates]
        if all(math.isinf(c) for c in costs):
            if fallback == "least_resident":
                index = min(
                    range(len(candidates)),
                    key=lambda i: float(candidates[i].get("resident_bytes", _INF)),
                )
                reason = "least_resident_fallback"
            else:
                labels = ", ".join(str(c.get("label")) for c in candidates)
                raise ValueError(f"{kind}: every candidate infeasible: {labels}")
        else:
            # First minimum — identical to int(np.argmin(costs)).
            index = min(range(len(costs)), key=costs.__getitem__)
        winner = str(candidates[index].get("label"))
        ref = self._emit(kind, winner, candidates, reason, context)
        return PlacementChoice(kind=kind, winner=winner, index=index,
                               reason=reason, ref=ref)

    def audit(self, kind: str, winner: str,
              candidates: Sequence[Dict[str, Any]], *, reason: str,
              context: Optional[Dict[str, Any]] = None
              ) -> Optional[obs.CostOutcomeRef]:
        """Record a policy-chosen winner on the unified stream.

        For sites whose choice is NOT a cost argmin (autoscaler
        thresholds, zoo eviction scoring, lifecycle gates): the policy
        keeps the wheel, the engine prices the candidates it considered
        and writes the same audit shape, so ``bin/trace --decisions``
        and the capacity planner see one stream.
        """
        return self._emit(kind, winner, candidates, reason, context)

    # ------------------------------------------------------------------
    # pricing helpers

    def price_page_in(self, resident_bytes: int) -> float:
        """Predicted seconds to page a zoo tenant's ``resident_bytes``
        back into residency under the active weight family:
        ``mem_weight * zoo_page_overhead() * bytes`` (decode + CRC +
        rebuild run at overhead x the sequential-touch rate).  Imports
        the cost model lazily — see the module docstring.
        """
        from keystone_tpu_torch.ops.learning.cost import active_weights, zoo_page_overhead

        _, mem_w, _ = active_weights()
        return float(mem_w) * float(zoo_page_overhead()) * float(resident_bytes)

    @staticmethod
    def price_queue_residence(queue_depth: float, outstanding: float,
                              replicas: int, service_estimate_s: float) -> float:
        """Predicted seconds of queue residence at a candidate replica
        count: the work in flight divided across replicas, scaled by the
        per-request service estimate.  A deliberately simple M/M/c-shaped
        proxy — the autoscaler's audit pricing, not its trigger."""
        backlog = max(float(queue_depth), 0.0) + max(float(outstanding), 0.0)
        return float(service_estimate_s) * backlog / max(int(replicas), 1)

    # ------------------------------------------------------------------
    # internals

    @staticmethod
    def _cost_of(candidate: Dict[str, Any]) -> float:
        cost = candidate.get("cost_s")
        if cost is None:
            return _INF
        return float(cost)

    def _emit(self, kind: str, winner: str,
              candidates: Sequence[Dict[str, Any]], reason: str,
              context: Optional[Dict[str, Any]]) -> Optional[obs.CostOutcomeRef]:
        normalized = [self._normalize(c) for c in candidates]
        infeasible = sum(1 for c in normalized if not c.get("feasible", False))
        if self._metrics is not None:
            self._metrics.counter(obs.METRIC_PLACEMENT_DECISIONS).add()
            if infeasible:
                self._metrics.counter(
                    obs.METRIC_PLACEMENT_INFEASIBLE).add(infeasible)
        obs.flight_note(
            "placement", kind, winner=winner, reason=reason,
            candidates=len(normalized), family=self.weights_family,
        )
        tracer = obs.active_tracer()
        if tracer is None:
            return None
        record = tracer.event(
            PLACEMENT_EVENT,
            decision=kind,
            winner=winner,
            reason=reason,
            candidates=normalized,
            weights_family=self.weights_family,
            **dict(context or {}),
        )
        return obs.CostOutcomeRef(tracer, record)

    @staticmethod
    def _normalize(candidate: Dict[str, Any]) -> Dict[str, Any]:
        """Audit-shape a candidate: infeasible cost becomes ``None``
        (JSON-clean, matching ``cost.decision``), and ``feasible`` is
        derived from the cost when the site didn't set it explicitly."""
        out = dict(candidate)
        cost = out.get("cost_s")
        if cost is None:
            out.setdefault("feasible", False)
            return out
        cost = float(cost)
        if math.isinf(cost):
            out["cost_s"] = None
            out.setdefault("feasible", False)
        else:
            out["cost_s"] = cost
            out.setdefault("feasible", True)
        return out
