"""Model-publication lifecycle: validation-gated publication, canary
rollout with auto-rollback, and the model-staleness clock (port of
``keystone_tpu/serving/lifecycle.py``).

A trainer must not push a NaN-weighted, quality-regressed, or
latency-regressed plan straight into rotation. The
:class:`LifecycleController` owns the path from candidate
:class:`~keystone_tpu_torch.workflow.pipeline.FittedPipeline` to serving
rotation:

  1. **Validation gate** (:meth:`LifecycleController.offer`). Every
     candidate is exported at the plane's request signature and padding
     buckets, fingerprinted, checked for NON-FINITE weights (a NaN
     Gramian solve must die here, not in a served response), dry-run
     for BIT-IDENTITY across the padding buckets (the same rows served
     through every bucket must produce byte-identical responses — the
     per-fingerprint contract the plane states), and scored on a
     held-out shard. A candidate that regresses quality past the
     declared ``quality_bound`` is REJECTED LOUDLY — a structured
     ``lifecycle.decision`` audit event (the ``cost.decision`` /
     ``autoscale.decision`` / ``zoo.decision`` mirror), a flight note,
     the ``lifecycle.rejected`` counter — and never touches the plane:
     zero requests are ever served under a rejected fingerprint.
  2. **Canary rollout.** A passing candidate is swapped into ONE
     replica first (:meth:`ReplicatedServer.swap_replica_plan` — the
     zero-drop drain protocol, scoped to the lowest live index), and
     the controller compares the canary's exec-latency percentile and
     the plane's SLO state against the incumbent replicas over a
     ``canary_sustain_s`` window. A canary whose exec tail (at the
     percentile its batch count supports, p99 at most) exceeds
     ``canary_latency_factor``× the incumbents' (at
     ``canary_min_samples`` or more completions), or under which the
     SLO state DEGRADES, is swapped straight back — the regression
     never reaches the full plane. Otherwise the candidate promotes
     via the full zero-drop rollout.
  3. **Automatic rollback.** The controller keeps a bounded ring of
     previously-served plans keyed by fingerprint. After a promotion an
     ATTRIBUTION WINDOW opens (``attribution_window_s``): an SLO
     WARN/BREACH inside the window, while the new fingerprint is the
     incumbent and the state at promotion was better, is attributed to
     the new plan and triggers a zero-drop ``swap_plan`` back to the
     prior plan. The attribution rule is deliberately conservative in
     ONE direction: a plan that was promoted into an already-degraded
     plane is never blamed for the pre-existing degradation.
  4. **Model staleness.** ``offer(candidate, data_time=...)`` carries
     the arrival stamp of the newest shard the candidate covers; the
     serving plane stamps the FIRST response completed under each
     fingerprint (:meth:`ReplicatedServer.first_completion_times`), and
     the controller publishes the difference — shard arrival → first
     response served under the covering fingerprint — as
     ``lifecycle.staleness_s`` (registry gauge + stats block). Both ends are exact stamps, not poll estimates.

Fault sites ``lifecycle.validate`` (gate-infrastructure failure →
loud ``ok=False`` rejection, plane untouched) and ``lifecycle.publish``
(swap-path failure → loud publication failure, incumbent keeps
serving) feed the chaos drills, beside the trainer's ``trainer.fit``
kill-mid-fit site.

Thread contract: ``offer()`` runs on the trainer's thread (one
publication at a time — the controller lock); the optional monitor
thread (:meth:`start`) drives :meth:`poll` for staleness detection and
post-promotion rollback. Device work happens inside the exported plans
and the plane's swap machinery; the gate's bit-identity dry run holds
because the plans' products are row-stable
(``ops/learning/linear.py``'s ``mapper_product``, ROADMAP C.8): without
that, a cuBLAS or MKL product sums by the bucket's row count and every
good candidate would fail it.

Difference from the reference: the non-finite check reads a tensor
weight where it lies (``torch.isfinite`` on its device) instead of
through ``np.asarray``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs.metrics import (
    METRIC_LIFECYCLE_CANARY_PROMOTIONS,
    METRIC_LIFECYCLE_PUBLISHED,
    METRIC_LIFECYCLE_REJECTED,
    METRIC_LIFECYCLE_ROLLBACKS,
    METRIC_LIFECYCLE_STALENESS_S,
)
from keystone_tpu_torch.obs.slo import STATE_BREACH, STATE_OK, STATE_WARN
from keystone_tpu_torch.utils import faults

from .export import ExportedPlan, export_plan

__all__ = ["LifecycleController", "LifecycleDecision"]

logger = logging.getLogger("keystone_tpu_torch.serving")

_STATE_RANK = {STATE_OK: 0, STATE_WARN: 1, STATE_BREACH: 2}

# The canary's latency verdict reads the quantile below which all but
# this many of its batches fall (p99 once it has served 500 batches).
# A quantile its sample cannot support would be its slowest batch: one
# batch that met a loaded host (a thread waiting whole GIL switch
# intervals) then reads as a regression. Port only (ROADMAP C.15).
CANARY_TAIL_BATCHES = 5


def _judged_quantile(num_batches: int) -> float:
    """The percentile a canary of ``num_batches`` batches is judged at."""
    return 100.0 * min(0.99, max(0.0, 1.0 - CANARY_TAIL_BATCHES / max(num_batches, 1)))


@dataclass(frozen=True)
class LifecycleDecision:
    """One publication-path action, as evidence — the model-lifecycle
    analogue of ``cost.decision``/``autoscale.decision``: which
    fingerprint, what the gate/canary saw (inputs), the declared bounds
    it was judged against (thresholds), what happened (action), and why
    (reason). ``ok=False`` records an action that FAILED (a gate
    infrastructure error, a publish swap failure) — part of the audit
    trail, never a silent no-op."""

    action: str        # publish | reject | canary_rollback | rollback
    reason: str
    fingerprint: Optional[str]
    t_s: float
    ok: bool = True
    inputs: Dict[str, Any] = field(default_factory=dict)
    thresholds: Dict[str, Any] = field(default_factory=dict)
    # Decision-stream schema fields: lifecycle gates are quality
    # decisions, not resource pricing, so candidates is usually the
    # single judged fingerprint — but the stream carries the same
    # winner/candidates/weights_family shape as placement.decision.
    weights_family: Optional[str] = None

    def to_args(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "reason": self.reason,
            "fingerprint": self.fingerprint,
            "ok": self.ok,
            "t_s": self.t_s,
            "inputs": dict(self.inputs),
            "thresholds": dict(self.thresholds),
            "winner": self.fingerprint or self.action,
            "candidates": (
                [{"label": self.fingerprint, "cost_s": None,
                  "feasible": self.ok}]
                if self.fingerprint else []
            ),
            "weights_family": self.weights_family,
        }


class _Watch:
    """The post-promotion attribution window: which fingerprint is on
    probation, what it replaced, and the SLO state it inherited."""

    __slots__ = ("fingerprint", "prior_fingerprint", "prior_plan",
                 "t_promoted", "baseline_rank")

    def __init__(self, fingerprint, prior_fingerprint, prior_plan,
                 t_promoted, baseline_rank):
        self.fingerprint = fingerprint
        self.prior_fingerprint = prior_fingerprint
        self.prior_plan = prior_plan
        self.t_promoted = t_promoted
        self.baseline_rank = baseline_rank


class LifecycleController:
    """Own the candidate → rotation path for one serving plane
    (module docstring for the full design).

    Knobs:

      - ``holdout``: ``(X, y)`` numpy pair the gate scores candidates
        on (None disables quality gating — the finite-weights and
        bit-identity checks still run).
      - ``quality_bound``: maximum allowed held-out score REGRESSION
        vs the incumbent (score units — the default scorer is negative
        MSE, so 0.05 means "at most 0.05 more MSE than the incumbent").
      - ``score_fn(plan, X, y) -> float``: higher-is-better scorer
        (default: negative mean squared error over batched applies).
      - ``canary_sustain_s`` / ``canary_latency_factor`` /
        ``canary_min_samples``: the canary window, the exec-tail
        regression multiple that fails it, and the minimum canary
        completions a latency verdict needs (0 sustain disables the
        canary — candidates promote directly; a single-replica plane
        also promotes directly, there is no second replica to canary
        on).
      - ``attribution_window_s``: how long after a promotion an SLO
        degradation is attributed to the new fingerprint.
      - ``canary_pollution_grace_s``: how long after a canary ROLLBACK
        the attribution check stands down — the rolled-back canary's
        slow responses are still in the SLO burn windows, and blaming
        the incumbent on probation for the canary's pollution would
        cascade one caught regression into a second, spurious
        full-plane rollback.
      - ``rollback_ring``: how many previously-served plans are kept
        promotable-back-to.
      - ``slo``: the plane's :class:`~keystone_tpu_torch.obs.slo.SLOTracker`
        (optional — without it canary/rollback judge on latency only).
      - ``metrics``: registry for the ``lifecycle.*`` counters/gauge
        (defaults to the plane's own, beside the serving counters).
    """

    def __init__(
        self,
        plane,
        incumbent: ExportedPlan,
        holdout: Optional[Tuple[Any, Any]] = None,
        quality_bound: float = 0.05,
        score_fn: Optional[Callable[..., float]] = None,
        canary_sustain_s: float = 1.0,
        canary_latency_factor: float = 3.0,
        canary_min_samples: int = 20,
        attribution_window_s: float = 30.0,
        canary_pollution_grace_s: float = 10.0,
        rollback_ring: int = 4,
        slo=None,
        metrics=None,
        poll_interval_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
        decision_log_len: int = 256,
    ):
        if quality_bound < 0:
            raise ValueError("quality_bound must be >= 0")
        if canary_latency_factor < 1.0:
            raise ValueError("canary_latency_factor must be >= 1")
        if rollback_ring < 1:
            raise ValueError("rollback_ring must be >= 1")
        self.plane = plane
        self.quality_bound = float(quality_bound)
        self.canary_sustain_s = float(canary_sustain_s)
        self.canary_latency_factor = float(canary_latency_factor)
        self.canary_min_samples = int(canary_min_samples)
        self.attribution_window_s = float(attribution_window_s)
        self.canary_pollution_grace_s = float(canary_pollution_grace_s)
        self.poll_interval_s = float(poll_interval_s)
        self._score_fn = score_fn or _default_score
        self._holdout = None
        if holdout is not None:
            X, y = holdout
            self._holdout = (np.asarray(X), np.asarray(y))
        self._slo = slo
        self._clock = clock
        self._t0 = clock()

        # Publication state — one lock owns incumbent/ring/watch/pending
        # (offer() holds it for a whole publication, so poll()'s
        # rollback can never interleave with a half-done promotion).
        self._pub_lock = threading.RLock()
        self._incumbent = incumbent
        self._incumbent_score: Optional[float] = None
        self._ring: "deque[Tuple[str, ExportedPlan]]" = deque(
            maxlen=int(rollback_ring)
        )
        self._watch: Optional[_Watch] = None
        # Attribution stands down until this stamp after a canary
        # rollback (the canary's pollution is still in the SLO burn
        # windows — class docstring).
        self._attribution_hold_until = -float("inf")
        # fingerprint -> (data_time, t_published): awaiting their first
        # served response for the staleness clock.
        self._pending_staleness: Dict[str, Tuple[float, float]] = {}

        self._stats_lock = threading.Lock()
        self.published = 0
        self.rejected = 0
        self.rollbacks = 0
        self.canary_promotions = 0
        self.num_decisions = 0
        self._decisions: "deque[Dict[str, Any]]" = deque(
            maxlen=decision_log_len
        )
        # Bounded like the decision log: a learn deployment publishes
        # indefinitely, and stats() reads this every exporter tick —
        # the window median over the retained samples is the claim.
        self._staleness: "deque[float]" = deque(maxlen=1024)
        self._staleness_total = 0

        reg = metrics if metrics is not None else getattr(
            plane, "metrics", None
        )
        self._metrics = reg
        if reg is not None:
            self._c_published = reg.counter(METRIC_LIFECYCLE_PUBLISHED)
            self._c_rejected = reg.counter(METRIC_LIFECYCLE_REJECTED)
            self._c_rollbacks = reg.counter(METRIC_LIFECYCLE_ROLLBACKS)
            self._c_canary = reg.counter(
                METRIC_LIFECYCLE_CANARY_PROMOTIONS
            )
            self._g_staleness = reg.gauge(METRIC_LIFECYCLE_STALENESS_S)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the monitor loop --------------------------------------------------

    def start(self) -> "LifecycleController":
        """Start the monitor thread: drives :meth:`poll` (staleness
        detection + post-promotion rollback) every ``poll_interval_s``.
        Idempotent."""
        with self._stats_lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._loop,
                name="keystone-serving-lifecycle", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — monitor must survive
                logger.warning("lifecycle poll failed: %r", e)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the monitor thread (joins it). The serving plane is NOT
        closed — the controller owns the publication path, not the
        plane. Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "LifecycleController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the publication path ----------------------------------------------

    def offer(self, candidate, data_time: Optional[float] = None,
              context: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run one candidate through gate → canary → promote.

        ``candidate`` is a ``FittedPipeline`` (exported here at the
        plane's signature and padding buckets) or an
        :class:`ExportedPlan`. ``data_time`` is the ``time.monotonic()``
        arrival stamp of the newest shard the candidate covers — the
        staleness clock's start. Returns a result dict:
        ``{"published": bool, "fingerprint": ..., "reason": ...}``.
        Rejections are LOUD (audit event, flight note, counter, warning
        log) but never raise — a bad candidate must not kill the
        trainer that produced it."""
        t_offer = self._clock()
        with self._pub_lock:
            # ---- the validation gate ----
            try:
                faults.maybe_fail(faults.SITE_LIFECYCLE_VALIDATE)
                plan = self._export(candidate)
                reason, gate = self._validate(plan)
            except Exception as e:  # noqa: BLE001 — gate must fail closed
                self._reject(
                    None, f"validate_error:{type(e).__name__}",
                    ok=False, inputs={"error": str(e)[:300],
                                      **(context or {})},
                )
                return {"published": False, "fingerprint": None,
                        "reason": f"validate_error:{type(e).__name__}"}
            gate.update(context or {})
            if reason is not None:
                self._reject(plan.fingerprint, reason, inputs=gate)
                return {"published": False,
                        "fingerprint": plan.fingerprint, "reason": reason}
            # ---- canary + promote ----
            try:
                faults.maybe_fail(faults.SITE_LIFECYCLE_PUBLISH)
                return self._publish(plan, gate, data_time, t_offer)
            except Exception as e:  # noqa: BLE001 — loud, plane intact
                self._record(
                    "publish", f"publish_error:{type(e).__name__}",
                    plan.fingerprint, ok=False,
                    inputs={"error": str(e)[:300], **gate},
                )
                logger.warning(
                    "lifecycle: publishing candidate %s FAILED (%r) — "
                    "the candidate was NOT promoted",
                    plan.fingerprint, e,
                )
                return {"published": False,
                        "fingerprint": plan.fingerprint,
                        "reason": f"publish_error:{type(e).__name__}"}

    def _export(self, candidate) -> ExportedPlan:
        """Candidate → ExportedPlan at the plane's signature, max_batch
        and padding buckets (so the swap drain protocol holds by
        construction, exactly like ``swap_plan``'s FittedPipeline
        form)."""
        cur = self._incumbent
        if isinstance(candidate, ExportedPlan):
            if (candidate.item_shape != cur.item_shape
                    or candidate.dtype != cur.dtype):
                raise ValueError(
                    f"candidate signature {candidate.item_shape}/"
                    f"{candidate.dtype} != plane signature "
                    f"{cur.item_shape}/{cur.dtype}"
                )
            return candidate
        example = np.zeros(cur.item_shape, np.dtype(cur.dtype))
        return export_plan(
            candidate, example, max_batch=cur.max_batch,
            buckets=cur.buckets, device=cur.device,
        )

    def _validate(self, plan: ExportedPlan):
        """The gate body: (reject_reason | None, gate-evidence dict)."""
        gate: Dict[str, Any] = {"candidate_fingerprint": plan.fingerprint}
        # 1. Non-finite weights: a NaN/Inf anywhere in the exported
        # operators poisons every response silently — die here.
        site = _non_finite_site(plan.graph)
        if site is not None:
            gate["non_finite_at"] = site
            return "non_finite_weights", gate
        # 2. Bit-identity dry-run across the padding buckets: the same
        # rows served through EVERY bucket (and served twice through
        # the same bucket) must produce byte-identical outputs — the
        # per-fingerprint contract the plane stamps on every response.
        mismatch = _bucket_identity_mismatch(plan)
        if mismatch is not None:
            gate["bit_identity_mismatch"] = mismatch
            return "bucket_bit_identity", gate
        gate["buckets_dry_run"] = list(plan.buckets)
        # 3. Held-out quality: candidate score (higher is better) must
        # not regress past the declared bound vs the incumbent.
        if self._holdout is not None:
            X, y = self._holdout
            cand = float(self._score_fn(plan, X, y))
            if self._incumbent_score is None:
                self._incumbent_score = float(
                    self._score_fn(self._incumbent, X, y)
                )
            gate["candidate_score"] = round(cand, 6)
            gate["incumbent_score"] = round(self._incumbent_score, 6)
            if cand < self._incumbent_score - self.quality_bound:
                return "quality_regression", gate
            gate["_score"] = cand
        return None, gate

    def _publish(self, plan: ExportedPlan, gate: Dict[str, Any],
                 data_time: Optional[float], t_offer: float):
        incumbent = self._incumbent
        fp = plan.fingerprint
        if fp == incumbent.fingerprint:
            # Publishing the incumbent again is a no-op, not a rollout:
            # re-draining the plane to install identical bits would be
            # pure churn (and would reopen its attribution window).
            self._record("publish", "already_incumbent", fp,
                         inputs={k: v for k, v in gate.items()
                                 if not k.startswith("_")})
            return {"published": True, "fingerprint": fp,
                    "reason": "already_incumbent", "canary": False}
        state_before = (
            self._slo.worst_state() if self._slo is not None else None
        )
        live = self.plane.live_replica_indices()
        canary_block: Optional[Dict[str, Any]] = None
        if self.canary_sustain_s > 0 and len(live) >= 2:
            canary_block = self._run_canary(plan, incumbent, live[0],
                                            state_before)
            if canary_block.get("regressed"):
                # The canary's slow responses are in the SLO windows:
                # attribution to the incumbent stands down while they
                # age out, or one caught regression cascades into a
                # spurious full-plane rollback.
                self._attribution_hold_until = (
                    self._clock() + self.canary_pollution_grace_s
                )
                with self._stats_lock:
                    self.rollbacks += 1
                if self._metrics is not None:
                    self._c_rollbacks.add(1)
                self._record(
                    "canary_rollback", canary_block["reason"], fp,
                    inputs={**{k: v for k, v in gate.items()
                               if not k.startswith("_")},
                            "canary": canary_block},
                )
                logger.warning(
                    "lifecycle: canary REGRESSED for candidate %s (%s) "
                    "— rolled the canary replica back to incumbent %s",
                    fp, canary_block["reason"], incumbent.fingerprint,
                )
                return {"published": False, "fingerprint": fp,
                        "reason": canary_block["reason"],
                        "canary": canary_block}
        # Full-plane promotion (the canary replica re-swaps with the
        # rest — each worker generation still serves one version).
        self.plane.swap_plan(plan)
        self._ring.append((incumbent.fingerprint, incumbent))
        self._incumbent = plan
        if gate.get("_score") is not None:
            self._incumbent_score = gate["_score"]
        self._watch = _Watch(
            fp, incumbent.fingerprint, incumbent, self._clock(),
            _STATE_RANK.get(state_before, 0),
        )
        # Settle + prune the staleness book: a superseded fingerprint
        # that never served cannot serve now (its generations drained
        # to zero before closing), so keeping it pending would leak one
        # entry per unserved publication forever.
        self._settle_staleness()
        self._pending_staleness = {
            f: v for f, v in self._pending_staleness.items() if f == fp
        }
        if data_time is not None:
            self._pending_staleness[fp] = (
                float(data_time), self._clock()
            )
        with self._stats_lock:
            self.published += 1
            if canary_block is not None:
                self.canary_promotions += 1
        if self._metrics is not None:
            self._c_published.add(1)
            if canary_block is not None:
                self._c_canary.add(1)
        self._record(
            "publish", "promoted", fp,
            inputs={
                **{k: v for k, v in gate.items()
                   if not k.startswith("_")},
                "prior_fingerprint": incumbent.fingerprint,
                "canary": canary_block,
                "publish_wall_s": round(self._clock() - t_offer, 6),
            },
        )
        return {"published": True, "fingerprint": fp,
                "reason": "promoted", "canary": canary_block}

    def _swap_back(self, canary_index: int,
                   incumbent: ExportedPlan) -> None:
        """Return the canary replica to the incumbent plan — with one
        paced retry, because FAILING here leaves a known-bad candidate
        serving a share of live traffic. If both attempts fail, the
        raise NAMES that state explicitly (it lands in the ok=False
        decision's inputs and the warning log) instead of letting the
        generic publish-error path claim the incumbent kept serving."""
        last: Optional[BaseException] = None
        for attempt in (1, 2):
            try:
                self.plane.swap_replica_plan(canary_index, incumbent)
                return
            except Exception as e:  # noqa: BLE001 — retried, then loud
                last = e
                if attempt == 1:
                    time.sleep(0.1)
        logger.error(
            "lifecycle: canary swap-back FAILED twice (%r) — the "
            "REJECTED candidate is STILL SERVING on replica %d until "
            "the next successful swap", last, canary_index,
        )
        obs.flight_note(
            "lifecycle", f"canary_swap_back_failed:replica={canary_index}",
            ok=False, error=repr(last),
        )
        raise RuntimeError(
            f"canary swap-back failed on replica {canary_index}: the "
            f"rejected candidate is STILL IN ROTATION there ({last!r})"
        ) from last

    def _run_canary(self, plan: ExportedPlan, incumbent: ExportedPlan,
                    canary_index: int, state_before) -> Dict[str, Any]:
        """Swap the candidate into one replica, hold it under live
        traffic for the sustain window, and judge its exec-latency tail
        and the SLO state against the incumbents. On regression the
        canary replica swaps straight back — zero-drop both ways.

        The canary's exec p99 covers its fresh generation, the sustain
        window; the incumbents' covers the requests they served in the
        same window (their whole span ring only where they served none
        in it). The reference compares against the ring: there a canary
        window that met a loaded host (its p99 over a few dozen batches
        is about the slowest one) read as a regression against a ring
        that diluted the same stalls, and a ring holding an old slow
        period hid a real one. The verdict compares the canary's batch
        walls and the incumbents' at one percentile, the highest that
        leaves ``CANARY_TAIL_BATCHES`` of the canary's batches above it
        (p99 from 500 batches on): a regression must show in several
        batches, not in the one that met a stall. The p99s are still
        reported. The ``canary_latency_factor`` margin and the
        post-promotion attribution window stay the backstops."""
        marks = self.plane.exec_marks()
        self.plane.swap_replica_plan(canary_index, plan)
        deadline = self._clock() + self.canary_sustain_s
        canary_p99 = incumbent_p99 = canary_tail = incumbent_tail = None
        canary_walls: List[float] = []
        quantile = None
        canary_completed = 0
        try:
            while self._clock() < deadline:
                time.sleep(min(0.02, self.canary_sustain_s / 10.0))
            stats = self.plane.stats()
            per_rep = stats.get("per_replica") or {}
            c = per_rep.get(canary_index) or {}
            canary_p99 = c.get("p99_exec_s")
            canary_completed = int(c.get("completed") or 0)
            incumbents = [idx for idx, r in per_rep.items()
                          if idx != canary_index and r.get("in_rotation")]
            windowed = self.plane.exec_p99_since(marks)
            others = [windowed[idx] for idx in incumbents if idx in windowed] or [
                per_rep[idx]["p99_exec_s"] for idx in incumbents
                if per_rep[idx].get("p99_exec_s") is not None
            ]
            incumbent_p99 = (
                float(np.median(others)) if others else None
            )
            batches = self.plane.exec_batches_since(marks)
            canary_walls = batches.get(canary_index, [])
            quantile = _judged_quantile(len(canary_walls))
            if canary_walls:
                canary_tail = float(np.percentile(canary_walls, quantile))
                tails = [float(np.percentile(batches[idx], quantile))
                         for idx in incumbents if idx in batches]
                incumbent_tail = float(np.median(tails)) if tails else incumbent_p99
        except Exception:
            # Judging failed — the canary must not stay in rotation on
            # an unjudged candidate.
            self._swap_back(canary_index, incumbent)
            raise
        state_now = (
            self._slo.worst_state() if self._slo is not None else None
        )
        block: Dict[str, Any] = {
            "replica": canary_index,
            "sustain_s": self.canary_sustain_s,
            "canary_p99_exec_s": canary_p99,
            "incumbent_p99_exec_s": incumbent_p99,
            "canary_completed": canary_completed,
            "canary_batches": len(canary_walls),
            "judged_percentile": quantile,
            "canary_tail_exec_s": canary_tail,
            "incumbent_tail_exec_s": incumbent_tail,
            "slo_state_before": state_before,
            "slo_state_after": state_now,
            "regressed": False,
            "reason": "canary_held",
        }
        latency_regressed = (
            canary_tail is not None and incumbent_tail is not None
            and canary_completed >= self.canary_min_samples
            and canary_tail > self.canary_latency_factor * incumbent_tail
        )
        slo_regressed = (
            state_now is not None and state_before is not None
            and _STATE_RANK.get(state_now, 0)
            > _STATE_RANK.get(state_before, 0)
        )
        if latency_regressed or slo_regressed:
            block["regressed"] = True
            block["reason"] = (
                "canary_latency_regression" if latency_regressed
                else f"canary_slo_{state_now}"
            )
            self._swap_back(canary_index, incumbent)
        elif canary_completed < self.canary_min_samples:
            # Too little traffic for a latency verdict: promote, but
            # say so — the attribution window is the backstop.
            block["reason"] = "insufficient_canary_samples"
        return block

    # -- the monitor body --------------------------------------------------

    def poll(self) -> Optional[Dict[str, Any]]:
        """One monitor pass: close any completed staleness clocks, then
        check the post-promotion attribution window — an SLO WARN/BREACH
        inside it, attributable to the promoted fingerprint, triggers
        the automatic zero-drop rollback. Returns the rollback decision
        record when one fired, else None."""
        with self._pub_lock:
            self._settle_staleness()
            watch = self._watch
            if watch is None:
                return None
            now = self._clock()
            if now - watch.t_promoted > self.attribution_window_s:
                self._watch = None  # survived probation
                return None
            if self._slo is None:
                return None
            if self._incumbent.fingerprint != watch.fingerprint:
                self._watch = None  # superseded (or manually swapped)
                return None
            if now < self._attribution_hold_until:
                # A rolled-back canary's pollution is still aging out
                # of the burn windows — degradation here is ITS fault,
                # not the probationary incumbent's.
                return None
            state = self._slo.worst_state()
            rank = _STATE_RANK.get(state, 0)
            if rank <= max(watch.baseline_rank,
                           _STATE_RANK[STATE_OK]):
                return None
            # Attributed: the plane degraded past its promotion-time
            # state while the new fingerprint was serving, inside the
            # window. Roll back to the prior plan — zero-drop.
            self.plane.swap_plan(watch.prior_plan)
            self._incumbent = watch.prior_plan
            self._incumbent_score = None  # re-score lazily
            self._pending_staleness.pop(watch.fingerprint, None)
            self._watch = None
            with self._stats_lock:
                self.rollbacks += 1
            if self._metrics is not None:
                self._c_rollbacks.add(1)
            rec = self._record(
                "rollback", f"slo_{state.lower()}_attributed",
                watch.fingerprint,
                inputs={
                    "slo_state": state,
                    "baseline_state_rank": watch.baseline_rank,
                    "window_s": round(now - watch.t_promoted, 6),
                    "restored_fingerprint": watch.prior_fingerprint,
                },
            )
            logger.warning(
                "lifecycle: SLO %s attributed to fingerprint %s "
                "(%.3fs after promotion) — ROLLED BACK to %s",
                state, watch.fingerprint, now - watch.t_promoted,
                watch.prior_fingerprint,
            )
            return rec

    def _settle_staleness(self) -> None:
        if not self._pending_staleness:
            return
        first = self.plane.first_completion_times()
        for fp in list(self._pending_staleness):
            t_first = first.get(fp)
            if t_first is None:
                continue
            data_time, _t_pub = self._pending_staleness.pop(fp)
            staleness = max(t_first - data_time, 0.0)
            with self._stats_lock:
                self._staleness.append(staleness)
                self._staleness_total += 1
            if self._metrics is not None:
                self._g_staleness.set(staleness)
            obs.event(
                "lifecycle.staleness", fingerprint=fp,
                staleness_s=round(staleness, 6),
            )

    # -- audit -------------------------------------------------------------

    def _thresholds(self) -> Dict[str, Any]:
        return {
            "quality_bound": self.quality_bound,
            "canary_sustain_s": self.canary_sustain_s,
            "canary_latency_factor": self.canary_latency_factor,
            "canary_min_samples": self.canary_min_samples,
            "attribution_window_s": self.attribution_window_s,
            "canary_pollution_grace_s": self.canary_pollution_grace_s,
        }

    def _reject(self, fingerprint, reason, ok=True, inputs=None):
        with self._stats_lock:
            self.rejected += 1
        if self._metrics is not None:
            self._c_rejected.add(1)
        logger.warning(
            "lifecycle: candidate %s REJECTED at the validation gate "
            "(%s) — it never touches the serving plane",
            fingerprint or "<unexported>", reason,
        )
        self._record("reject", reason, fingerprint, ok=ok,
                     inputs=inputs)

    def _record(self, action, reason, fingerprint, ok=True,
                inputs=None) -> Dict[str, Any]:
        from keystone_tpu_torch.placement.engine import active_family

        decision = LifecycleDecision(
            action=action, reason=reason, fingerprint=fingerprint,
            ok=ok, t_s=round(self._clock() - self._t0, 6),
            inputs=dict(inputs or {}), thresholds=self._thresholds(),
            weights_family=active_family(),
        )
        rec = decision.to_args()
        with self._stats_lock:
            self._decisions.append(rec)
            self.num_decisions += 1
        obs.event("lifecycle.decision", **rec)
        obs.flight_note(
            "lifecycle", f"{action}:{fingerprint}", ok=ok,
            reason=reason,
        )
        return rec

    # -- reading -----------------------------------------------------------

    @property
    def incumbent_fingerprint(self) -> str:
        with self._pub_lock:
            return self._incumbent.fingerprint

    def ring_fingerprints(self) -> List[str]:
        with self._pub_lock:
            return [fp for fp, _ in self._ring]

    def decision_log(self) -> List[Dict[str, Any]]:
        """The bounded in-memory audit trail (newest last)."""
        with self._stats_lock:
            return list(self._decisions)

    def staleness_samples(self) -> List[float]:
        with self._stats_lock:
            return list(self._staleness)

    def stats(self) -> Dict[str, Any]:
        """The lifecycle summary block the ``learn`` summary line embeds.
        Any dict claiming ``staleness*`` or ``rollbacks`` should also
        carry the offered rate of the load the claims were measured
        under: this block carries ``num_published`` itself; embedders
        merge it into a dict that carries the offered rate."""
        with self._stats_lock:
            staleness = list(self._staleness)
            decisions = list(self._decisions)
            out: Dict[str, Any] = {
                "published": self.published,
                "num_published": self.published,
                "rejected": self.rejected,
                "rollbacks": self.rollbacks,
                "canary_promotions": self.canary_promotions,
                "num_decisions": self.num_decisions,
            }
        out["staleness_s"] = (
            round(staleness[-1], 6) if staleness else None
        )
        out["staleness_median_s"] = (
            round(float(np.median(staleness)), 6) if staleness else None
        )
        with self._stats_lock:
            out["staleness_num_samples"] = self._staleness_total
        with self._pub_lock:
            out["incumbent_fingerprint"] = self._incumbent.fingerprint
            out["ring_fingerprints"] = [fp for fp, _ in self._ring]
            out["pending_staleness"] = len(self._pending_staleness)
            out["attribution_open"] = self._watch is not None
        out["thresholds"] = self._thresholds()
        out["decisions"] = decisions[-64:]
        return out


# -- gate helpers ------------------------------------------------------------


def _iter_arrays(v):
    """Yield array-likes inside an operator attribute value: tensors and
    numpy arrays directly, lists/tuples elementwise."""
    if isinstance(v, (list, tuple)):
        for e in v:
            yield from _iter_arrays(e)
        return
    if isinstance(v, (np.ndarray, torch.Tensor)):
        yield v


def _non_finite(a) -> bool:
    """Whether a floating array or tensor holds a NaN or an infinity (a
    tensor checked where it lies)."""
    if isinstance(a, torch.Tensor):
        return bool(a.is_floating_point() and a.numel()
                    and not bool(torch.isfinite(a).all()))
    return bool(a.dtype.kind == "f" and a.size and not np.isfinite(a).all())


def _non_finite_site(graph) -> Optional[str]:
    """``"Operator.attr"`` of the first non-finite float array in any
    exported operator's state (fused members included), or None when
    every weight is finite."""
    from keystone_tpu_torch.workflow.fusion import fused_members

    seen = set()
    for node in graph.nodes:
        op = graph.get_operator(node)
        for member in fused_members(op) + [op]:
            if id(member) in seen or not hasattr(member, "__dict__"):
                continue
            seen.add(id(member))
            for k, v in member.__dict__.items():
                if k.startswith("_"):
                    continue
                for arr in _iter_arrays(v):
                    if _non_finite(arr):
                        return f"{type(member).__name__}.{k}"
    return None


def _bucket_identity_mismatch(plan: ExportedPlan) -> Optional[str]:
    """Serve one deterministic probe batch through EVERY padding bucket
    (and twice through the first) and require byte-identical outputs —
    the dry-run form of the plane's per-fingerprint bit-identity
    contract. Returns a description of the first mismatch, or None."""
    m = min(plan.buckets)
    rng = np.random.default_rng(0xC0FFEE)
    X = rng.normal(size=(m,) + plan.item_shape).astype(
        np.dtype(plan.dtype), copy=False
    )
    rows = list(X)
    ref = np.asarray(plan.apply_batch(rows))
    again = np.asarray(plan.apply_batch(rows))
    if not np.array_equal(ref, again):
        return f"bucket={m}: two applies of the same batch differ"
    for b in plan.buckets[1:]:
        pad = np.zeros((b - m,) + plan.item_shape, X.dtype)
        out = np.asarray(
            plan.apply_padded(np.concatenate([X, pad], axis=0))
        )[:m]
        if not np.array_equal(ref, out):
            return (
                f"bucket={b}: padded output differs from bucket={m} "
                "reference"
            )
    return None


def _default_score(plan: ExportedPlan, X, y) -> float:
    """Negative mean squared error of batched applies (higher is
    better) — the gate's default held-out scorer."""
    X = np.asarray(X)
    y = np.asarray(y)
    outs = []
    for i in range(0, len(X), plan.max_batch):
        outs.append(np.asarray(
            plan.apply_batch(list(X[i:i + plan.max_batch]))
        ))
    out = np.concatenate(outs, axis=0)
    return -float(np.mean((out.astype(np.float64)
                           - y.astype(np.float64)) ** 2))
