"""Online SLO objectives: multi-window burn rates, an error-budget
ledger, and an OK/WARN/BREACH state machine for long-lived serving (port
of ``keystone_tpu/obs/slo.py``).

The serving target is judged by LIVE signals ("a p99 SLO
gate, plus a chaos leg proving the SLO degrades gracefully") — but until
this module nothing in the codebase could state an SLO verdict while a
server was running: the degradation machinery (shed, breaker trip,
replica evict, swap) fired with no quantitative objective behind it and
no budget accounting after. This is the measured-policy layer over
those mechanisms, the same discipline KeystoneML applies to optimizer
choices (decisions justified by observed profiles):

  - An :class:`SLOObjective` declares what "good" means — a latency
    bound (``kind="latency"``: a completion is good iff it finished
    within ``threshold_s``) or availability (``kind="availability"``: a
    request is good iff it resolved with a result, not a shed/breaker
    reject/failure) — plus the ``target`` good fraction.
  - :class:`SLOTracker` consumes the per-request outcome stream
    (:meth:`SLOTracker.observe`, fed by the serving planes) into
    fixed-slot time windows (O(1) memory, the same bounded-state rule
    as the bucketed histograms) and computes FAST and SLOW window
    **burn rates**: ``bad_fraction / (1 - target)`` — 1.0 means budget
    is being spent exactly at the sustainable rate, N means N× too
    fast. Two windows so a one-tick blip neither pages (the slow window
    smooths it) nor hides (the fast window catches a real storm within
    seconds).
  - The per-objective state machine: **BREACH** when the fast burn
    reaches ``breach_burn``; it sticks (hysteresis) until the fast burn
    falls back under ``warn_burn``; **WARN** when either window burns
    above ``warn_burn``; **OK** otherwise. Every transition is traced
    as an instant event (``slo.transition``) under the active tracer,
    noted on the flight ring, and a transition INTO breach dumps the
    flight record (:func:`keystone_tpu_torch.obs.flight.dump_flight_record`)
    — the postmortem starts AT the breach, not after the pager.
  - The **error-budget ledger**: one entry per state interval with the
    good/bad counts attributed to it, so a chaos kill's degraded window
    is accounted for — "the BREACH interval burned 312 of the run's 450
    allowed errors" is a ledger read, not archaeology.

States publish into a :class:`~keystone_tpu_torch.obs.metrics.MetricsRegistry`
when one is provided (``slo.state`` / ``slo.burn_rate_fast`` / ... per
objective label) so the live exporter renders them beside the serving
counters — gauges refresh on :meth:`SLOTracker.evaluate` (the
exporter's tick), never on the per-request hot path. No torch, no numpy:
fed from serving worker callbacks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from keystone_tpu_torch.obs import flight as flight_mod
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.obs.metrics import (
    METRIC_SLO_BUDGET_SPENT,
    METRIC_SLO_BURN_FAST,
    METRIC_SLO_BURN_SLOW,
    METRIC_SLO_STATE,
    METRIC_SLO_TRANSITIONS,
)

__all__ = [
    "SLOObjective",
    "SLOTracker",
    "STATE_BREACH",
    "STATE_OK",
    "STATE_WARN",
]

STATE_OK = "OK"
STATE_WARN = "WARN"
STATE_BREACH = "BREACH"
# Numeric projection for the registry gauge / Prometheus rendering.
_STATE_LEVEL = {STATE_OK: 0, STATE_WARN: 1, STATE_BREACH: 2}

# Slots per window: burn rates are computed over fixed time slots, so
# memory is O(slots) regardless of traffic, and an idle second ages out
# of the window without a timer thread.
_SLOTS_PER_WINDOW = 20


@dataclass(frozen=True)
class SLOObjective:
    """One declared objective. ``target`` is the GOOD fraction the SLO
    promises (0.99 = 1% error budget); ``threshold_s`` is the latency
    bound for ``kind="latency"`` (ignored for availability). The burn
    thresholds are in budget-rate units: 1.0 = spending exactly the
    sustainable rate."""

    name: str
    kind: str = "latency"  # "latency" | "availability"
    threshold_s: Optional[float] = None
    target: float = 0.99
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    warn_burn: float = 1.0
    breach_burn: float = 6.0
    # A window with fewer events than this cannot ESCALATE the state:
    # one slow request in an otherwise-empty window is a 100% bad
    # fraction (burn = 1/budget — an instant page at serve start, seen
    # on the first cold batch of the chaos bench). De-escalation is
    # ungated — hysteresis still holds a breach while the raw fast burn
    # stays over warn_burn, and an idle window decays to OK.
    min_events: int = 10

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(
                f"SLOObjective kind must be 'latency' or 'availability', "
                f"got {self.kind!r}"
            )
        if self.kind == "latency" and (
            self.threshold_s is None or self.threshold_s <= 0
        ):
            raise ValueError(
                f"latency objective {self.name!r} needs threshold_s > 0"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1) — "
                f"a target of 1.0 has zero error budget and every bad "
                f"event is an immediate breach; got {self.target}"
            )
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"objective {self.name!r}: need 0 < fast_window_s "
                f"<= slow_window_s"
            )
        if self.breach_burn < self.warn_burn:
            raise ValueError(
                f"objective {self.name!r}: breach_burn < warn_burn would "
                "make WARN unreachable on the way down"
            )
        if self.min_events < 1:
            raise ValueError(
                f"objective {self.name!r}: min_events must be >= 1"
            )


class _Window:
    """Time-slotted (good, bad) counts covering ``window_s``, bounded to
    a fixed slot count — O(1) memory under unbounded traffic."""

    __slots__ = ("slot_s", "slots", "_ring")

    def __init__(self, window_s: float, slots: int = _SLOTS_PER_WINDOW):
        self.slot_s = window_s / slots
        self.slots = slots
        # (slot_index, good, bad) — mutated in place for the live slot.
        self._ring: "deque[List[float]]" = deque(maxlen=slots + 1)

    def add(self, now: float, good: int, bad: int) -> None:
        idx = int(now / self.slot_s)
        if self._ring and self._ring[-1][0] == idx:
            self._ring[-1][1] += good
            self._ring[-1][2] += bad
        else:
            self._ring.append([idx, good, bad])

    def totals(self, now: float) -> "tuple[int, int]":
        lo = int(now / self.slot_s) - self.slots
        good = bad = 0
        for idx, g, b in self._ring:
            if idx > lo:
                good += g
                bad += b
        return int(good), int(bad)


class _ObjectiveState:
    """Per-objective live state: windows, lifetime totals, the state
    machine, the transition log, and the budget ledger."""

    def __init__(self, objective: SLOObjective):
        self.obj = objective
        self.fast = _Window(objective.fast_window_s)
        self.slow = _Window(objective.slow_window_s)
        self.good_total = 0
        self.bad_total = 0
        self.state = STATE_OK
        self.transitions: List[Dict[str, Any]] = []
        # Budget ledger: one OPEN entry per state interval; counts are
        # attributed to the interval they arrived in.
        self.ledger: List[Dict[str, Any]] = [{
            "state": STATE_OK, "t_start": 0.0, "t_end": None,
            "good": 0, "bad": 0,
        }]

    def record(self, now: float, good: bool) -> None:
        g, b = (1, 0) if good else (0, 1)
        self.fast.add(now, g, b)
        self.slow.add(now, g, b)
        self.good_total += g
        self.bad_total += b
        cur = self.ledger[-1]
        cur["good"] += g
        cur["bad"] += b

    @staticmethod
    def _burn(totals: "tuple[int, int]", budget_frac: float) -> float:
        good, bad = totals
        n = good + bad
        if n == 0:
            return 0.0
        return (bad / n) / budget_frac

    def burns(self, now: float) -> "tuple[float, float]":
        budget = 1.0 - self.obj.target
        return (
            self._burn(self.fast.totals(now), budget),
            self._burn(self.slow.totals(now), budget),
        )

    def next_state(self, now: float, burn_fast: float,
                   burn_slow: float) -> str:
        obj = self.obj
        # min_events gates ESCALATION only: a 1-sample window has a
        # 0-or-100% bad fraction — noise, not a storm. De-escalation
        # stays on the raw burns (hysteresis below; an idle window
        # decays to 0 and clears).
        fast_n = sum(self.fast.totals(now))
        slow_n = sum(self.slow.totals(now))
        if fast_n >= obj.min_events and burn_fast >= obj.breach_burn:
            return STATE_BREACH
        if self.state == STATE_BREACH and burn_fast >= obj.warn_burn:
            # Hysteresis: a breach ends only when the fast window is
            # back UNDER the sustainable rate — not when it merely dips
            # below the page threshold (which would flap).
            return STATE_BREACH
        if (fast_n >= obj.min_events and burn_fast >= obj.warn_burn) or (
            slow_n >= obj.min_events and burn_slow >= obj.warn_burn
        ):
            return STATE_WARN
        return STATE_OK

    def budget_spent_fraction(self) -> float:
        """Share of the run's error budget consumed so far: observed bad
        fraction over the allowed bad fraction (can exceed 1.0 — budget
        overdrawn)."""
        n = self.good_total + self.bad_total
        if n == 0:
            return 0.0
        return (self.bad_total / n) / (1.0 - self.obj.target)


class SLOTracker:
    """Consume request outcomes, hold the per-objective burn-rate state
    machines, and publish verdicts (module docstring).

    ``metrics``: a :class:`MetricsRegistry` to publish per-objective
    gauges into (optional). ``clock``: injectable monotonic clock —
    the state machine is deterministic under a fake clock, which is how
    the unit tests drive OK→WARN→BREACH→OK without wall-time sleeps.
    Thread-safe: ``observe`` is called from serving worker threads and
    done-callbacks while ``verdict``/``evaluate`` run on exporter or
    bench threads.
    """

    def __init__(
        self,
        objectives: Sequence[SLOObjective],
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("SLOTracker needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._objectives: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState(o) for o in objectives
        }
        self._metrics = metrics
        if metrics is not None:
            for name in names:
                metrics.gauge(METRIC_SLO_STATE, objective=name)
                metrics.gauge(METRIC_SLO_BURN_FAST, objective=name)
                metrics.gauge(METRIC_SLO_BURN_SLOW, objective=name)
                metrics.gauge(METRIC_SLO_BUDGET_SPENT, objective=name)
                metrics.counter(METRIC_SLO_TRANSITIONS, objective=name)

    @property
    def objectives(self) -> List[SLOObjective]:
        return [st.obj for st in self._objectives.values()]

    # -- feeding -----------------------------------------------------------

    def observe(self, latency_s: Optional[float] = None,
                ok: bool = True) -> None:
        """Record one request outcome. ``ok=False`` (shed / breaker
        reject / failure / timeout) is a bad event for EVERY objective.
        ``ok=True`` with a latency feeds latency objectives
        (good iff within threshold) and availability objectives (good).
        Evaluates the state machines inline — transition latency is one
        request, not one exporter tick."""
        now = self._clock() - self._t0
        transitions = []
        with self._lock:
            for st in self._objectives.values():
                if ok and st.obj.kind == "latency":
                    if latency_s is None:
                        continue  # no latency measured: not a latency SLI
                    st.record(now, latency_s <= st.obj.threshold_s)
                else:
                    st.record(now, ok)
            # publish=False: the hot path detects transitions only;
            # registry gauge publishing rides the exporter's evaluate()
            # cadence, not every request (the tracker lock is contended
            # by every serving worker and done-callback).
            transitions = self._evaluate_locked(now, publish=False)
        self._emit(transitions)

    def evaluate(self) -> Dict[str, str]:
        """Re-run the state machines on the current clock (an idle
        window decays burn rates with no traffic) and return the
        per-objective states. The exporter calls this every tick."""
        now = self._clock() - self._t0
        with self._lock:
            transitions = self._evaluate_locked(now)
            states = {n: st.state for n, st in self._objectives.items()}
        self._emit(transitions)
        return states

    def _evaluate_locked(self, now: float,
                         publish: bool = True) -> List[Dict[str, Any]]:
        out = []
        for name, st in self._objectives.items():
            burn_fast, burn_slow = st.burns(now)
            nxt = st.next_state(now, burn_fast, burn_slow)
            if publish and self._metrics is not None:
                self._metrics.gauge(METRIC_SLO_STATE, objective=name).set(
                    _STATE_LEVEL[nxt]
                )
                self._metrics.gauge(
                    METRIC_SLO_BURN_FAST, objective=name
                ).set(burn_fast)
                self._metrics.gauge(
                    METRIC_SLO_BURN_SLOW, objective=name
                ).set(burn_slow)
                self._metrics.gauge(
                    METRIC_SLO_BUDGET_SPENT, objective=name
                ).set(st.budget_spent_fraction())
            if nxt == st.state:
                continue
            rec = {
                "objective": name, "from": st.state, "to": nxt,
                "t_s": round(now, 6),
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_spent_fraction": round(
                    st.budget_spent_fraction(), 4
                ),
            }
            st.transitions.append(rec)
            st.ledger[-1]["t_end"] = now
            st.ledger.append({
                "state": nxt, "t_start": now, "t_end": None,
                "good": 0, "bad": 0,
            })
            st.state = nxt
            if self._metrics is not None:
                self._metrics.counter(
                    METRIC_SLO_TRANSITIONS, objective=name
                ).add(1)
            out.append(rec)
        return out

    def _emit(self, transitions: List[Dict[str, Any]]) -> None:
        """Trace + flight-record each transition OUTSIDE the tracker
        lock (the flight dump renders and logs — never under a lock the
        serving hot path contends)."""
        for rec in transitions:
            tracer_mod.event("slo.transition", **rec)
            flight_mod.flight_note(
                "slo", f"{rec['objective']}:{rec['from']}->{rec['to']}",
                burn_fast=rec["burn_fast"],
                budget_spent=rec["budget_spent_fraction"],
            )
            if rec["to"] == STATE_BREACH:
                # A breach IS a postmortem moment: dump the ring (recent
                # spans, faults, decisions, in-flight work) beside it.
                flight_mod.dump_flight_record(
                    f"SLO BREACH: objective {rec['objective']!r} "
                    f"burn_fast={rec['burn_fast']} "
                    f"(budget {rec['budget_spent_fraction']:.1%} spent)"
                )

    # -- reading -----------------------------------------------------------

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {n: st.state for n, st in self._objectives.items()}

    def burn_rates(self) -> Dict[str, "tuple[float, float]"]:
        """``{objective: (burn_fast, burn_slow)}`` on the current clock —
        the light read the autoscaler's tick consumes (``verdict()``
        builds the full transition/ledger copies; a control loop ticking
        several times a second only needs the burns)."""
        now = self._clock() - self._t0
        with self._lock:
            return {n: st.burns(now) for n, st in self._objectives.items()}

    def worst_state(self) -> str:
        states = self.states().values()
        for s in (STATE_BREACH, STATE_WARN):
            if s in states:
                return s
        return STATE_OK

    def verdict(self) -> Dict[str, Any]:
        """The SLO verdict block (what ``LoadReport`` and ``run.py
        serve`` publish): per objective — state, both burn rates,
        budget spent/remaining, lifetime good/bad, the transition log,
        and the budget ledger with per-interval counts (a degraded
        window's cost is a ledger read)."""
        now = self._clock() - self._t0
        with self._lock:
            objectives = {}
            for name, st in self._objectives.items():
                burn_fast, burn_slow = st.burns(now)
                spent = st.budget_spent_fraction()
                ledger = []
                for entry in st.ledger:
                    e = dict(entry)
                    e["t_start"] = round(e["t_start"], 6)
                    if e["t_end"] is not None:
                        e["t_end"] = round(e["t_end"], 6)
                    ledger.append(e)
                objectives[name] = {
                    "kind": st.obj.kind,
                    "threshold_s": st.obj.threshold_s,
                    "target": st.obj.target,
                    "state": st.state,
                    # Numeric projection: the Prometheus renderer skips
                    # strings, so this is the field an alert scrapes.
                    "state_level": _STATE_LEVEL[st.state],
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "budget_spent_fraction": round(spent, 4),
                    "budget_remaining_fraction": round(1.0 - spent, 4),
                    "good_total": st.good_total,
                    "bad_total": st.bad_total,
                    "transitions": list(st.transitions),
                    "ledger": ledger,
                }
            worst = STATE_OK
            for o in objectives.values():
                if _STATE_LEVEL[o["state"]] > _STATE_LEVEL[worst]:
                    worst = o["state"]
        return {
            "state": worst,
            "state_level": _STATE_LEVEL[worst],
            "objectives": objectives,
        }
