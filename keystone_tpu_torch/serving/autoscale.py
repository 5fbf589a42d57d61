"""SLO-closed-loop autoscaler: measured capacity for the serving plane
(port of ``keystone_tpu/serving/autoscale.py``).

The serving plane can already replicate, fail over, hot-swap and state a
live SLO verdict; this module closes the loop, making the replica count a
measured, self-correcting decision driven by the same burn-rate state
machine the verdict comes from:

  - **The control thread** (:class:`Autoscaler`) is watchdog-style:
    numpy-free, touching no tensor, one bounded tick per interval. Each
    tick consumes the :class:`~keystone_tpu_torch.obs.slo.SLOTracker`
    state machine (``evaluate()`` and the light ``burn_rates()`` read)
    plus the plane's queue-depth / occupancy signals
    (:meth:`~keystone_tpu_torch.serving.replicas.ReplicatedServer.autoscale_signals`)
    and drives the zero-drop elasticity primitives:

      * sustained WARN/BREACH with a rising fast burn →
        :meth:`~ReplicatedServer.add_replica` (bounded by
        ``max_replicas``);
      * sustained OK with idle budget (near-zero queue depth, low
        per-replica occupancy) → :meth:`~ReplicatedServer.remove_replica`
        (bounded by ``min_replicas``).

  - **Hysteresis and cooldowns**: a pressure / idle signal must SUSTAIN
    for its window before any action, no two actions land inside
    ``cooldown_s``, and each action resets its sustain timer, so the
    controller cannot flap.

  - **The brownout ladder** is the wall past ``max_replicas``: when
    scale-up is exhausted and burn keeps rising, the controller climbs
    :data:`~keystone_tpu_torch.serving.replicas.BROWNOUT_STEPS` one
    named, reversible rung per cooldown (widen micro-batch deadlines →
    shed earliest-deadline more aggressively → reject new admissions).
    Exit is strictly LIFO and gated on RELIEF (occupancy idle), not on
    the SLO returning to OK: at the ladder top every request is rejected
    and rejections keep the SLO in breach, so an OK-gated exit would
    deadlock the plane in full reject. Scale-down stays OK-gated.

  - **Every decision is auditable**: each action is an
    ``autoscale.decision`` instant event (inputs, thresholds, action,
    reason), a ``placement.*`` record, a flight-recorder note, an entry
    of the bounded :meth:`Autoscaler.decision_log`, and ``autoscale.*``
    registry metrics.

On one card, replicas that share one plan take turns at each bucket's
CUDA graph (``serving/export.py``), so adding replicas adds host threads
rather than device throughput; the controller acts on what the SLO
measures either way.

Determinism: the clock is injectable and ``tick()`` is a plain method, so
a test drives the whole state machine under a fake clock with no thread
and no sleeps. ``start()`` / ``close()`` run the same tick on a daemon
thread (``run.py serve --autoscale``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from keystone_tpu_torch import obs
from keystone_tpu_torch.placement.engine import (
    KIND_BROWNOUT,
    KIND_REPLICAS,
    PlacementEngine,
)
from keystone_tpu_torch.obs.metrics import (
    METRIC_AUTOSCALE_BROWNOUT_LEVEL,
    METRIC_AUTOSCALE_DECISIONS,
    METRIC_AUTOSCALE_REPLICAS,
    METRIC_AUTOSCALE_SCALE_DOWNS,
    METRIC_AUTOSCALE_SCALE_UPS,
)
from keystone_tpu_torch.obs.slo import STATE_BREACH, STATE_OK, STATE_WARN
from .replicas import BROWNOUT_STEPS

__all__ = ["AutoscaleDecision", "Autoscaler"]

logger = logging.getLogger("keystone_tpu_torch.serving")

_STATE_RANK = {STATE_OK: 0, STATE_WARN: 1, STATE_BREACH: 2}


@dataclass(frozen=True)
class AutoscaleDecision:
    """One control-loop action, as evidence — the elasticity analogue of
    :class:`~keystone_tpu_torch.obs.tracer.CostDecision`: what the controller
    saw (inputs), what it was configured to do about it (thresholds),
    what it did (action/step), and why (reason). ``ok=False`` records an
    ATTEMPTED action that failed (e.g. a spawn past the restart budget)
    — a failed scale-up is part of the audit trail, not a silent no-op."""

    action: str                 # scale_up | scale_down | brownout_enter |
                                # brownout_exit
    reason: str
    t_s: float                  # controller-clock seconds since start
    ok: bool = True
    step: Optional[str] = None  # the brownout rung, for brownout actions
    inputs: Dict[str, Any] = field(default_factory=dict)
    thresholds: Dict[str, Any] = field(default_factory=dict)
    # The placement-engine audit fields: the candidate
    # replica counts / brownout rungs the controller had on the table,
    # the one it took, and the weight family that priced them — the
    # decision-event schema every stream shares.
    winner: Optional[str] = None
    candidates: Sequence[Dict[str, Any]] = field(default_factory=tuple)
    weights_family: Optional[str] = None

    def to_args(self) -> Dict[str, Any]:
        out = {
            "action": self.action,
            "reason": self.reason,
            "ok": self.ok,
            "t_s": self.t_s,
            "inputs": dict(self.inputs),
            "thresholds": dict(self.thresholds),
            "winner": self.winner if self.winner is not None else self.action,
            "candidates": [dict(c) for c in self.candidates],
            "weights_family": self.weights_family,
        }
        if self.step is not None:
            out["step"] = self.step
        return out


class Autoscaler:
    """Drive a :class:`~keystone_tpu_torch.serving.replicas.ReplicatedServer`'s
    elasticity from its SLO tracker (module docstring).

    Knobs:

      - ``min_replicas`` / ``max_replicas``: the capacity bounds the
        controller never crosses.
      - ``tick_interval_s``: control-loop cadence (the thread's pace;
        ``tick()`` itself is cadence-free under test).
      - ``scale_up_sustain_s``: how long pressure (WARN/BREACH + rising
        fast burn) must hold continuously before a scale-up/brownout
        action.
      - ``scale_down_sustain_s``: how long idle (OK + low occupancy)
        must hold before a scale-down; relief (occupancy only) gates
        brownout exits on the same window.
      - ``cooldown_s``: minimum spacing between ANY two actions — the
        no-flapping guarantee the fake-clock suite pins.
      - ``idle_outstanding_per_replica`` / ``idle_queue_depth``: the
        idle-budget definition (occupancy at/below both = idle).
      - ``clock``: injectable monotonic clock (determinism under test).
      - ``metrics``: a registry for the ``autoscale.*`` gauges/counters
        (defaults to the server's own, so the live exporter renders
        them with the serving counters).
    """

    def __init__(
        self,
        server,
        slo,
        min_replicas: int = 1,
        max_replicas: int = 8,
        tick_interval_s: float = 0.25,
        scale_up_sustain_s: float = 1.0,
        scale_down_sustain_s: float = 5.0,
        cooldown_s: float = 2.0,
        idle_outstanding_per_replica: float = 0.5,
        idle_queue_depth: int = 1,
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
        decision_log_len: int = 256,
        service_estimate_s: float = 0.05,
    ):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})"
            )
        if slo is None:
            raise ValueError(
                "Autoscaler needs an SLOTracker — the control loop IS "
                "the burn-rate state machine's consumer"
            )
        self.server = server
        self.slo = slo
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.tick_interval_s = float(tick_interval_s)
        self.scale_up_sustain_s = float(scale_up_sustain_s)
        self.scale_down_sustain_s = float(scale_down_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.idle_outstanding_per_replica = float(
            idle_outstanding_per_replica
        )
        self.idle_queue_depth = int(idle_queue_depth)
        # The queueing proxy's per-request service scale — used only to
        # PRICE replica-count candidates for the placement audit stream
        # (the triggers stay the burn-rate state machine's).
        self.service_estimate_s = float(service_estimate_s)
        self._clock = clock
        self._t0 = clock()

        self._lock = threading.Lock()
        self._decisions: "deque[Dict[str, Any]]" = deque(
            maxlen=decision_log_len
        )
        self.num_decisions = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.failed_scale_ups = 0
        self.failed_scale_downs = 0
        self.brownout_steps_entered = 0
        self.brownout_steps_exited = 0
        self.ticks = 0
        self.tick_errors = 0
        n0 = server.autoscale_signals()["replicas"]  # live, not evicted
        self.replicas_low = n0
        self.replicas_high = n0

        # Controller state (all touched only from tick() — one ticker at
        # a time, whether the thread or a test).
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._relief_since: Optional[float] = None
        self._last_burn_fast = 0.0
        self._last_action_t = -float("inf")

        reg = metrics if metrics is not None else getattr(
            server, "metrics", None
        )
        self._metrics = reg
        if reg is not None:
            self._g_replicas = reg.gauge(METRIC_AUTOSCALE_REPLICAS)
            self._g_brownout = reg.gauge(METRIC_AUTOSCALE_BROWNOUT_LEVEL)
            self._c_ups = reg.counter(METRIC_AUTOSCALE_SCALE_UPS)
            self._c_downs = reg.counter(METRIC_AUTOSCALE_SCALE_DOWNS)
            self._c_decisions = reg.counter(METRIC_AUTOSCALE_DECISIONS)
            self._g_replicas.set(n0)

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the control loop --------------------------------------------------

    def start(self) -> "Autoscaler":
        """Start the control thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._loop,
                name="keystone-serving-autoscaler", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — controller must survive
                # A control-loop crash must degrade to "no autoscaling",
                # never to a dead plane; count + log, keep ticking.
                self.tick_errors += 1
                logger.warning("autoscaler tick failed: %r", e)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the control thread (joins it). Idempotent. The serving
        plane itself is NOT closed — the controller is an observer with
        actuators, not the plane's owner."""
        self._stop.set()
        if self._thread is not None:  # set once under _lock in start()
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- one tick ----------------------------------------------------------

    def tick(self) -> Optional[Dict[str, Any]]:
        """Run one control-loop evaluation; returns the decision record
        when an action was taken (or attempted), else None. Deterministic
        under an injected clock — the whole state machine is pure in
        (clock, SLO window contents, plane signals)."""
        now = self._clock()
        self.ticks += 1

        states = self.slo.evaluate()
        worst = STATE_OK
        for s in states.values():
            if _STATE_RANK.get(s, 0) > _STATE_RANK[worst]:
                worst = s
        burns = self.slo.burn_rates()
        burn_fast = max(
            (b[0] for b in burns.values()), default=0.0
        )
        signals = self.server.autoscale_signals()
        replicas = signals["replicas"]
        self._observe_bounds(replicas)

        # Pressure: the SLO is WARN/BREACH and the fast burn is not
        # falling (a falling burn means the plane is recovering on its
        # own — adding capacity then would overshoot). BREACH counts as
        # pressure regardless of slope: the budget is burning too fast
        # to wait out a dip.
        rising = burn_fast >= self._last_burn_fast - 1e-9
        pressure = worst in (STATE_WARN, STATE_BREACH) and (
            rising or worst == STATE_BREACH
        )
        # Relief: the occupancy side is idle — queues empty, few
        # outstanding reservations per replica. Deliberately SLO-blind:
        # at the brownout ladder top every request is rejected and
        # rejections keep the SLO in breach, so an OK-gated exit would
        # wedge the plane in full-reject forever.
        relief = (
            signals["queue_depth"] <= self.idle_queue_depth
            and signals["outstanding"]
            <= self.idle_outstanding_per_replica * max(replicas, 1)
        )
        # Idle (the scale-DOWN gate): relief AND a healthy verdict —
        # capacity only leaves when the SLO is genuinely OK.
        idle = relief and worst == STATE_OK

        self._pressure_since = (
            (self._pressure_since if self._pressure_since is not None
             else now) if pressure else None
        )
        self._relief_since = (
            (self._relief_since if self._relief_since is not None
             else now) if relief else None
        )
        self._idle_since = (
            (self._idle_since if self._idle_since is not None
             else now) if idle else None
        )
        self._last_burn_fast = burn_fast

        in_cooldown = now - self._last_action_t < self.cooldown_s
        inputs = {
            "state": worst,
            "burn_fast": round(burn_fast, 4),
            "replicas": replicas,
            "queue_depth": signals["queue_depth"],
            "outstanding": signals["outstanding"],
            "brownout_level": signals["brownout_level"],
        }
        if in_cooldown:
            return None

        pressure_sustained = (
            self._pressure_since is not None
            and now - self._pressure_since >= self.scale_up_sustain_s
        )
        if pressure_sustained:
            if replicas < self.max_replicas:
                return self._act_scale_up(now, inputs)
            # Brownout degrades ADMISSION to shed load — entering a rung
            # while the occupancy side is already relieved would be
            # degrading against stale burn evidence (the fast window
            # outlives the storm), and at ladder-top-minus-one it would
            # oscillate against the relief exit below.
            if signals["brownout_level"] < len(BROWNOUT_STEPS) \
                    and not relief:
                return self._act_brownout_enter(now, inputs)
            # Ladder top AND max replicas: nothing left to degrade —
            # fall through, so sustained relief can still unwind the
            # ladder (at reject_admissions the SLO stays in breach from
            # the rejections themselves; pressure must not shadow the
            # only exit).
        if (
            signals["brownout_level"] > 0
            and self._relief_since is not None
            and now - self._relief_since >= self.scale_down_sustain_s
        ):
            return self._act_brownout_exit(now, inputs)
        if (
            self._idle_since is not None
            and now - self._idle_since >= self.scale_down_sustain_s
            and replicas > self.min_replicas
        ):
            return self._act_scale_down(now, inputs)
        return None

    # -- actions -----------------------------------------------------------

    def _act_scale_up(self, now, inputs):
        try:
            index = self.server.add_replica()
        except Exception as e:  # noqa: BLE001 — audited failure
            self.failed_scale_ups += 1
            return self._record(
                now, "scale_up", ok=False,
                reason=f"add_replica failed: {e!r}", inputs=inputs,
            )
        self.scale_ups += 1
        if self._metrics is not None:
            self._c_ups.add(1)
        return self._record(
            now, "scale_up",
            reason=(
                f"sustained {inputs['state']} with rising fast burn "
                f"{inputs['burn_fast']}x for >= "
                f"{self.scale_up_sustain_s:.3g}s"
            ),
            inputs={**inputs, "new_replica_index": index},
        )

    def _act_brownout_enter(self, now, inputs):
        step = self.server.enter_brownout_step()
        if step is None:
            return None
        self.brownout_steps_entered += 1
        return self._record(
            now, "brownout_enter", step=step,
            reason=(
                f"scale-up exhausted at max_replicas="
                f"{self.max_replicas} and burn still "
                f"{inputs['burn_fast']}x — degrading admission"
            ),
            inputs=inputs,
        )

    def _act_brownout_exit(self, now, inputs):
        step = self.server.exit_brownout_step()
        if step is None:
            return None
        self.brownout_steps_exited += 1
        return self._record(
            now, "brownout_exit", step=step,
            reason=(
                f"occupancy relief sustained >= "
                f"{self.scale_down_sustain_s:.3g}s (queue "
                f"{inputs['queue_depth']}, outstanding "
                f"{inputs['outstanding']}) — reverting LIFO"
            ),
            inputs=inputs,
        )

    def _act_scale_down(self, now, inputs):
        try:
            index = self.server.remove_replica()
        except Exception as e:  # noqa: BLE001 — audited failure
            self.failed_scale_downs += 1
            return self._record(
                now, "scale_down", ok=False,
                reason=f"remove_replica failed: {e!r}", inputs=inputs,
            )
        self.scale_downs += 1
        if self._metrics is not None:
            self._c_downs.add(1)
        return self._record(
            now, "scale_down",
            reason=(
                f"sustained OK with idle budget for >= "
                f"{self.scale_down_sustain_s:.3g}s (queue "
                f"{inputs['queue_depth']}, outstanding "
                f"{inputs['outstanding']})"
            ),
            inputs={**inputs, "removed_replica_index": index},
        )

    # -- recording ---------------------------------------------------------

    def _thresholds(self) -> Dict[str, Any]:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "scale_up_sustain_s": self.scale_up_sustain_s,
            "scale_down_sustain_s": self.scale_down_sustain_s,
            "cooldown_s": self.cooldown_s,
            "idle_outstanding_per_replica":
                self.idle_outstanding_per_replica,
            "idle_queue_depth": self.idle_queue_depth,
        }

    def _placement_decision(self, action, step, inputs):
        """The placement-engine view of one control action: the
        neighbouring replica counts (or brownout rungs) as priced
        candidates, and the policy's target as winner. Replica
        candidates carry the queue-residence proxy in seconds
        (``service_estimate_s``-scaled); feasibility is the capacity
        bounds the controller never crosses."""
        replicas = int(inputs.get("replicas") or 0)
        queue = float(inputs.get("queue_depth") or 0.0)
        outstanding = float(inputs.get("outstanding") or 0.0)
        if action in ("scale_up", "scale_down"):
            target = replicas + (1 if action == "scale_up" else -1)
            candidates = [
                {
                    "label": f"replicas={r}",
                    "cost_s": round(PlacementEngine.price_queue_residence(
                        queue, outstanding, r, self.service_estimate_s), 6),
                    "feasible": self.min_replicas <= r <= self.max_replicas,
                    "replicas": r,
                }
                for r in sorted({replicas - 1, replicas, replicas + 1})
                if r >= 1
            ]
            return KIND_REPLICAS, f"replicas={target}", candidates
        level = int(inputs.get("brownout_level") or 0)
        target = level + (1 if action == "brownout_enter" else -1)
        candidates = [
            {
                "label": f"brownout={lv}",
                "cost_s": None,
                "feasible": 0 <= lv <= len(BROWNOUT_STEPS),
                "brownout_level": lv,
                "step": step if lv == target else None,
            }
            for lv in sorted({level, target}) if lv >= 0
        ]
        return KIND_BROWNOUT, f"brownout={target}", candidates

    def _record(self, now, action, reason, ok=True, step=None,
                inputs=None) -> Dict[str, Any]:
        """Make the action auditable everywhere at once: the structured
        ``autoscale.decision`` trace event (the ``cost.decision``
        mirror) plus its ``placement.decision`` counterpart on the
        unified stream, a flight-recorder note, the bounded decision
        log, and the registry counters/gauges — then start the cooldown
        and reset the sustain timers (an action consumes its
        evidence)."""
        inputs = dict(inputs or {})
        engine = PlacementEngine(metrics=self._metrics)
        kind, winner, candidates = self._placement_decision(
            action, step, inputs
        )
        decision = AutoscaleDecision(
            action=action, reason=reason, ok=ok, step=step,
            t_s=round(now - self._t0, 6),
            inputs=inputs, thresholds=self._thresholds(),
            winner=winner, candidates=candidates,
            weights_family=engine.weights_family,
        )
        rec = decision.to_args()
        with self._lock:
            self._decisions.append(rec)
            self.num_decisions += 1
        obs.event("autoscale.decision", **rec)
        engine.audit(
            kind, winner, candidates, reason=reason,
            context={
                "action": action, "ok": ok, "t_s": rec["t_s"],
                "replicas": inputs.get("replicas"),
                "queue_depth": inputs.get("queue_depth"),
                "outstanding": inputs.get("outstanding"),
                "brownout_level": inputs.get("brownout_level"),
            },
        )
        obs.flight_note(
            "autoscale", f"{action}{f':{step}' if step else ''}",
            ok=ok, state=rec["inputs"].get("state"),
            burn_fast=rec["inputs"].get("burn_fast"),
            replicas=rec["inputs"].get("replicas"),
        )
        # One post-action read of the LIVE (non-evicted) count — the
        # same basis tick() scales on — feeds both the gauge and the
        # observed bounds; server.num_replicas would count evicted
        # members into the audit fields.
        live = self.server.autoscale_signals()["replicas"]
        if self._metrics is not None:
            self._c_decisions.add(1)
            self._g_replicas.set(live)
            self._g_brownout.set(self.server.brownout_level)
        self._last_action_t = now
        self._pressure_since = None
        self._idle_since = None
        self._relief_since = None
        self._observe_bounds(live)
        return rec

    def _observe_bounds(self, replicas: int) -> None:
        if replicas:
            self.replicas_low = min(self.replicas_low, replicas)
            self.replicas_high = max(self.replicas_high, replicas)

    # -- reading -----------------------------------------------------------

    def decision_log(self) -> List[Dict[str, Any]]:
        """The bounded in-memory audit trail (newest last)."""
        with self._lock:
            return list(self._decisions)

    def stats(self) -> Dict[str, Any]:
        """The autoscale summary block. Carries ``num_decisions`` and
        the ``min/max_replicas`` bounds in the SAME dict as the
        ``scale_ups``/``scale_downs`` claims, so a row that states the
        claims carries their audit fields."""
        with self._lock:
            decisions = list(self._decisions)
            out = {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "replicas_low": self.replicas_low,
                "replicas_high": self.replicas_high,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "failed_scale_ups": self.failed_scale_ups,
                "failed_scale_downs": self.failed_scale_downs,
                "brownout_steps_entered": self.brownout_steps_entered,
                "brownout_steps_exited": self.brownout_steps_exited,
                "num_decisions": self.num_decisions,
                "ticks": self.ticks,
                "tick_errors": self.tick_errors,
                "cooldown_s": self.cooldown_s,
            }
        out["brownout_level"] = self.server.brownout_level
        out["brownout_steps"] = list(self.server.brownout_steps)
        out["replicas"] = self.server.autoscale_signals()["replicas"]
        out["decisions"] = decisions[-64:]
        return out
