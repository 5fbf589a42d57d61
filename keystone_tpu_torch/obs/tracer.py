"""Process-wide tracer: nested, thread-safe spans under one ``run_id``
(port of ``keystone_tpu/obs/tracer.py``).

Design constraints, in priority order:

1. **Zero-cost when disabled.** Every hook in the hot paths (fold steps,
   runtime lane tasks, prefetch waits) funnels through module-level
   :func:`span` / :func:`event` / :func:`counter`, each guarded by ONE
   branch on the module-global ``_ACTIVE``. Disabled, :func:`span`
   returns a shared no-op context manager — no allocation beyond the
   caller's kwargs, no lock, no timestamps. The regression test in
   ``tests/test_obs.py`` pins the disabled per-hook cost.
2. **Thread-safe nesting.** Spans nest per thread (a thread-local
   stack); a span opened on a runtime IO worker records that worker's
   thread name and parents onto whatever span is open *on that thread*
   (cross-thread causality rides the shared ``run_id`` + lane names).
   Finished records append to one lock-guarded list.
3. **No torch.** Serving submitters and worker threads import this
   module; only the thread that owns the device touches torch, so
   nothing here may.

Records are plain dicts (the JSONL event-log rows — see
``obs/export.py`` for the Chrome-trace projection):

  span   {"type": "span", "name", "ts_us", "dur_us", "tid", "thread",
          "span_id", "parent_id", "run_id", "args"}
  event  {"type": "event", "name", "ts_us", "tid", "thread", "run_id",
          "args"}  — instants (cost decisions, faults)
  count  {"type": "counter", "name", "ts_us", "value", "run_id"}
         — counter-track samples (queue depths, outstanding requests)
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger("keystone_tpu_torch.obs.tracer")

__all__ = [
    "CostDecision",
    "CostOutcomeRef",
    "Span",
    "TailSampler",
    "Tracer",
    "active_tracer",
    "counter_track",
    "enabled",
    "event",
    "record_cost_decision",
    "span",
    "tracing",
    "tracing_from_env",
]

TRACE_ENV = "KEYSTONE_TRACE"
# Tail-sampling knobs for serving spans under a long-lived traced serve:
# head-sample rate (keep 1-in-round(1/rate)) and the slow threshold in
# milliseconds past which a request span is ALWAYS kept.
TRACE_SAMPLE_ENV = "KEYSTONE_TRACE_SAMPLE"
TRACE_SLOW_MS_ENV = "KEYSTONE_TRACE_SLOW_MS"


class _NoopSpan:
    """The shared disabled-path span: one instance for the whole
    process, so a disabled hook allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Attribute setter no-op (the enabled Span's ``set``)."""


_NOOP = _NoopSpan()

# THE one branch: every hook reads this module global. None = disabled.
_ACTIVE: Optional["Tracer"] = None
_ACTIVE_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether a tracer is active (the guard hot paths may hoist when a
    hook's argument construction itself is worth skipping)."""
    return _ACTIVE is not None


def active_tracer() -> Optional["Tracer"]:
    return _ACTIVE


def span(name: str, **attrs) -> Any:
    """Open a span under the active tracer, or the shared no-op when
    tracing is disabled — the ONE hook hot paths call."""
    t = _ACTIVE
    if t is None:
        return _NOOP
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Record an instant event (no duration) under the active tracer."""
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)


def counter_track(name: str, value: float) -> None:
    """Record one sample on a counter track (queue depth, outstanding
    requests) under the active tracer. Track names are free-form trace
    labels — a separate namespace from the registry's METRIC_* catalogue
    (which the metric-name lint rule polices)."""
    t = _ACTIVE
    if t is not None:
        t.counter_track(name, value)


class Span:
    """One open span: context manager handed out by :meth:`Tracer.span`.

    ``set(**attrs)`` adds attributes after open (e.g. a fold step's
    realized chunk count). Entering pushes onto the calling thread's
    stack (nesting/parent links); exiting pops and publishes the
    finished record. A span must exit on the thread that entered it —
    the stack is thread-local.
    """

    __slots__ = ("tracer", "name", "args", "span_id", "parent_id",
                 "_t0", "error")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None
        self._t0 = 0.0
        self.error: Optional[str] = None

    def set(self, **attrs) -> None:
        self.args.update(attrs)

    def __enter__(self) -> "Span":
        self.tracer._open(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc is not None:
            # The span carries its failure — a postmortem's flight
            # record names not just WHAT was in flight but what died.
            self.error = f"{type(exc).__name__}: {exc}"
        self.tracer._close(self, self._t0, t1)
        return False


class TailSampler:
    """Keep-if policy for high-volume serving spans, evaluated at span
    CLOSE (when the duration and outcome are known — the whole point of
    tail over head sampling):

      - ``flagged`` spans (errors, sheds, breaker-adjacent requests)
        are ALWAYS kept;
      - spans at least ``slow_s`` long are always kept (the tail the
        p99 is made of);
      - everything else is head-sampled at ``head_rate``, implemented
        as a deterministic keep-every-Nth (N = round(1/rate)) so a
        traced bench leg is reproducible — there is no RNG to seed.

    ``head_rate=1.0`` keeps everything (the default when no sampler is
    installed); ``head_rate=0.0`` keeps only flagged/slow spans.
    ``stats()`` reports kept/sampled-out counts per reason — the bound
    on tracing overhead under sustained load is auditable, not assumed.
    """

    __slots__ = ("head_rate", "slow_s", "_modulus", "_lock", "_seq",
                 "_kept", "_dropped")

    def __init__(self, head_rate: float = 0.01,
                 slow_s: Optional[float] = None):
        if not 0.0 <= head_rate <= 1.0:
            raise ValueError(f"head_rate must be in [0, 1], got {head_rate}")
        if slow_s is not None and slow_s <= 0:
            raise ValueError(f"slow_s must be > 0, got {slow_s}")
        self.head_rate = float(head_rate)
        self.slow_s = slow_s
        self._modulus = (
            max(int(round(1.0 / head_rate)), 1) if head_rate > 0 else 0
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._kept: Dict[str, int] = {}
        self._dropped = 0

    def keep(self, dur_s: float, flagged: bool = False
             ) -> "tuple[bool, Optional[str]]":
        """(keep?, reason) — reason is ``flagged``/``slow``/``head``
        (None when sampled out)."""
        with self._lock:
            if flagged:
                reason = "flagged"
            elif self.slow_s is not None and dur_s >= self.slow_s:
                reason = "slow"
            else:
                self._seq += 1
                if self._modulus and (self._seq % self._modulus) == 0:
                    reason = "head"
                else:
                    self._dropped += 1
                    return False, None
            self._kept[reason] = self._kept.get(reason, 0) + 1
            return True, reason

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kept": dict(self._kept),
                "kept_total": sum(self._kept.values()),
                "sampled_out": self._dropped,
                "head_rate": self.head_rate,
                "slow_s": self.slow_s,
            }


class Tracer:
    """Collects span/event/counter records for one traced run.

    ``run_id`` stamps every record, so one trace file is one causal
    record even when spans come from many threads (fold consumer,
    runtime IO workers, serving worker). Use through
    :func:`tracing` / the module-level hooks, not directly.

    ``serving_sampler``: an optional :class:`TailSampler` applied to the
    retroactive serving request spans (:meth:`add_serving_span`) — a
    long-lived traced serve keeps every slow/error/shed span but only a
    head sample of the healthy fast ones. Fit-path spans are never
    sampled (their volume is bounded by the fold, not the traffic).
    """

    def __init__(self, run_id: Optional[str] = None,
                 max_records: int = 1_000_000,
                 serving_sampler: Optional[TailSampler] = None):
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.serving_sampler = serving_sampler
        # Map perf_counter to wall-clock microseconds once, so every
        # record's ts_us is an epoch time Perfetto renders as absolute.
        self._epoch_us_at_zero = (
            time.time_ns() // 1_000 - int(time.perf_counter() * 1e6)
        )
        self._lock = threading.Lock()
        # Bounded: a traced LONG-LIVED process (serve under sustained
        # load appends spans per request) must not grow memory without
        # bound until tracing() exit. At capacity the OLDEST records
        # roll off (the recent window is the postmortem-relevant one)
        # and the drop is counted + logged — never silent. A bounded
        # fit never comes near the default.
        self._max_records = int(max_records)
        self._records: "deque[Dict[str, Any]]" = deque(
            maxlen=self._max_records
        )
        self.dropped = 0
        self._ids = itertools.count(1)
        self._open_spans: Dict[int, Dict[str, Any]] = {}
        self._tls = threading.local()

    # -- record plumbing ---------------------------------------------------

    def _us(self, perf_t: float) -> int:
        return self._epoch_us_at_zero + int(perf_t * 1e6)

    def _append_locked(self, rec: Dict[str, Any]) -> None:
        """Append one record; caller holds ``_lock``. Counts (and logs
        once) when the bounded buffer starts rolling off old records."""
        if len(self._records) == self._max_records:
            if self.dropped == 0:
                logger.warning(
                    "trace buffer full (%d records): oldest records now "
                    "roll off — raise Tracer(max_records=...) to keep "
                    "the full run", self._max_records,
                )
            self.dropped += 1
        self._records.append(rec)

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _open(self, sp: Span) -> None:
        st = self._stack()
        with self._lock:
            sp.span_id = next(self._ids)
        sp.parent_id = st[-1] if st else None
        st.append(sp.span_id)
        th = threading.current_thread()
        with self._lock:
            self._open_spans[sp.span_id] = {
                "name": sp.name, "span_id": sp.span_id,
                "parent_id": sp.parent_id, "thread": th.name,
            }

    def _close(self, sp: Span, t0: float, t1: float) -> None:
        st = self._stack()
        # Pop our own id (tolerate a corrupted stack rather than
        # poisoning the traced code path with an assertion).
        if st and st[-1] == sp.span_id:
            st.pop()
        elif sp.span_id in st:
            st.remove(sp.span_id)
        th = threading.current_thread()
        rec = {
            "type": "span",
            "name": sp.name,
            "ts_us": self._us(t0),
            "dur_us": max(int((t1 - t0) * 1e6), 0),
            "tid": th.ident,
            "thread": th.name,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "run_id": self.run_id,
            "args": sp.args,
        }
        if sp.error is not None:
            rec["error"] = sp.error
        with self._lock:
            self._open_spans.pop(sp.span_id, None)
            self._append_locked(rec)
        from keystone_tpu_torch.obs import flight

        flight.flight_note("span", sp.name, dur_us=rec["dur_us"],
                           thread=th.name, error=sp.error)

    # -- public recording API ----------------------------------------------

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, dict(attrs))

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> int:
        """Record a span retroactively from perf_counter endpoints — the
        serving bridge: the micro-batcher knows a request's
        enqueue/complete times only after the fact, and its rolling
        ``RequestSpan``/``SpanLog`` stats must keep working unchanged.
        Returns the span id (the exemplar reference a histogram bucket
        can carry)."""
        th = threading.current_thread()
        with self._lock:
            sid = next(self._ids)
            self._append_locked({
                "type": "span", "name": name,
                "ts_us": self._us(t0),
                "dur_us": max(int((t1 - t0) * 1e6), 0),
                "tid": th.ident, "thread": th.name,
                "span_id": sid, "parent_id": None,
                "run_id": self.run_id, "args": dict(attrs),
            })
        return sid

    def add_serving_span(self, name: str, t0: float, t1: float,
                         flagged: bool = False, **attrs) -> Optional[int]:
        """The tail-sampled form of :meth:`add_span` for per-request
        serving spans: the keep-if policy runs HERE, at close, when
        duration and outcome are known. ``flagged`` marks spans the
        policy must never drop (errors, sheds, breaker-adjacent
        requests). Returns the span id when kept (→ the
        ``run_id/span_id`` exemplar ref), None when sampled out.
        No sampler installed = keep everything."""
        s = self.serving_sampler
        if s is not None:
            kept, reason = s.keep(t1 - t0, flagged=flagged)
            if not kept:
                return None
            if reason != "head":
                attrs["keep"] = reason
        return self.add_span(name, t0, t1, **attrs)

    def event(self, name: str, **attrs) -> Dict[str, Any]:
        """Record an instant event; returns the record dict (the handle
        :class:`CostOutcomeRef` mutates to back-annotate a decision with
        its measured outcome before the trace file is written)."""
        th = threading.current_thread()
        rec = {
            "type": "event", "name": name,
            "ts_us": self._us(time.perf_counter()),
            "tid": th.ident, "thread": th.name,
            "run_id": self.run_id, "args": dict(attrs),
        }
        with self._lock:
            self._append_locked(rec)
        return rec

    def counter_track(self, name: str, value: float) -> None:
        with self._lock:
            self._append_locked({
                "type": "counter", "name": name,
                "ts_us": self._us(time.perf_counter()),
                "value": float(value),
                "run_id": self.run_id,
            })

    # -- introspection -----------------------------------------------------

    @property
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of every record so far (finished spans + events +
        counter samples), in completion order."""
        with self._lock:
            return list(self._records)

    def inflight(self) -> List[Dict[str, Any]]:
        """Spans currently OPEN — what the flight recorder names at
        death."""
        with self._lock:
            return list(self._open_spans.values())

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            r for r in self.events
            if r["type"] == "span" and (name is None or r["name"] == name)
        ]


# ---------------------------------------------------------------------------
# Cost-decision events
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostDecision:
    """One cost-model selection, as evidence: what was on the table,
    what the model predicted, what feasibility cut, and who won — the
    predicted-vs-measured discipline the replay tests
    (``tests/test_cost_replay.py``) audit against the trace."""

    decision: str                     # e.g. "least_squares_solver"
    winner: str                       # candidate label of the selection
    candidates: Sequence[Dict[str, Any]]  # [{label, cost, feasible, ...}]
    reason: str = "argmin"            # "argmin" | "least_resident_fallback"
    context: Dict[str, Any] = field(default_factory=dict)  # n/d/k/budget...

    def to_args(self) -> Dict[str, Any]:
        return {
            "decision": self.decision,
            "winner": self.winner,
            "reason": self.reason,
            "candidates": [dict(c) for c in self.candidates],
            # Top-level provenance shared by all six decision streams
            # (placement/engine.py): which weight family priced this.
            "weights_family": (self.context.get("weights") or {}).get(
                "family"),
            **{k: v for k, v in self.context.items()},
        }


class CostOutcomeRef:
    """Handle onto one recorded ``cost.decision`` event: whoever runs
    the priced work back-annotates the decision record with the
    MEASURED outcome (the executor stamps the winning fit's wall +
    span id — ``workflow/pipeline.py``), so predicted-vs-measured is
    one record with no join (``obs/calibrate.py``; ``bin/trace``'s
    decision table prints it per row). The mutation happens under the
    tracer lock, before the trace file is written at ``tracing()``
    exit; a stamp after exit mutates a dict nothing reads — harmless."""

    __slots__ = ("_tracer", "_record")

    def __init__(self, tracer: "Tracer", record: Dict[str, Any]):
        self._tracer = tracer
        self._record = record

    def stamp(self, measured_s: float, span_id: Optional[int] = None,
              **extra) -> None:
        if self._tracer is None or self._record is None:
            return  # ref crossed a pickle boundary: nothing to annotate
        outcome = {"measured_s": float(measured_s)}
        if span_id is not None:
            outcome["span_id"] = span_id
        outcome.update(extra)
        with self._tracer._lock:
            self._record.setdefault("args", {})["outcome"] = outcome

    def __getstate__(self):
        # A pending ref rides on the selected estimator, and estimators
        # get cloudpickled (FittedPipeline saves); the live tracer
        # (locks) must not be dragged along — a pickled ref drops its
        # annotation instead.
        return {}

    def __setstate__(self, state) -> None:
        self._tracer = None
        self._record = None


def record_cost_decision(decision: CostDecision) -> Optional[CostOutcomeRef]:
    """Emit a ``cost.decision`` instant event (and a flight-recorder
    note) for one selection. One branch when tracing is disabled.
    Returns a :class:`CostOutcomeRef` for the measured-outcome
    back-annotation, or None when no tracer is active."""
    t = _ACTIVE
    ref: Optional[CostOutcomeRef] = None
    if t is not None:
        ref = CostOutcomeRef(t, t.event("cost.decision", **decision.to_args()))
    from keystone_tpu_torch.obs import flight

    flight.flight_note(
        "decision", decision.decision, winner=decision.winner,
        reason=decision.reason,
    )
    return ref


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def tracing(directory: Optional[str] = None, run_id: Optional[str] = None,
            xla_profile: bool = False,
            serving_sampler: Optional[TailSampler] = None):
    """Activate tracing for the dynamic extent of the block.

    ``directory`` (optional): on exit the trace is written there —
    ``trace.json`` (Chrome-trace/Perfetto, load it at ui.perfetto.dev),
    ``events.jsonl`` (the compact event log ``bin/trace`` reads), and
    ``meta.json``. With no directory the records stay in-memory on the
    yielded :class:`Tracer` (the audit-test form).

    ``xla_profile=True`` (the reference's name, kept) additionally
    wraps the block in a ``torch.profiler`` trace
    (``utils.profiling.trace`` — the device-timeline deep-dive leg of
    this plane) writing a Chrome trace under ``directory/xla``;
    requires a directory. Imported lazily so this module stays
    torch-free.

    ``serving_sampler``: a :class:`TailSampler` for the per-request
    serving spans — a traced long-lived serve keeps every slow/error/
    shed span, head-samples the rest (docs/observability.md).

    Nested activation raises: one trace is one run's record.
    """
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(
                "tracing is already active; one trace per run "
                "(nest work under the active tracer instead)"
            )
        t = Tracer(run_id=run_id, serving_sampler=serving_sampler)
        _ACTIVE = t
    xla_cm = contextlib.nullcontext()
    if xla_profile:
        if directory is None:
            raise ValueError("xla_profile=True needs a trace directory")
        from keystone_tpu_torch.utils import profiling

        xla_cm = profiling.trace(os.path.join(directory, "xla"))
    try:
        with xla_cm:
            yield t
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
        if directory is not None:
            from keystone_tpu_torch.obs.export import write_trace_dir

            write_trace_dir(directory, t)


def tracing_from_env():
    """The env-knob activation: ``KEYSTONE_TRACE=dir`` (what
    ``run.py --trace=dir`` sets) turns the wrapped block into a traced
    run writing to ``dir``; unset — or a tracer already active — yields
    a no-op context. This is what ``run.py`` wraps every pipeline and
    serve invocation in, so tracing any production entry point is one
    flag, zero code.

    ``KEYSTONE_TRACE_SAMPLE=<rate>`` (and optionally
    ``KEYSTONE_TRACE_SLOW_MS=<ms>``) installs a :class:`TailSampler`
    over the serving request spans — the knob a traced long-lived serve
    needs so its trace buffer holds hours of tail, not seconds of
    everything."""
    directory = os.environ.get(TRACE_ENV, "").strip()
    if not directory or _ACTIVE is not None:
        return contextlib.nullcontext()
    sampler = None
    rate = os.environ.get(TRACE_SAMPLE_ENV, "").strip()
    if rate:
        # Validate-at-parse with the error naming the VARIABLE (the
        # utils.faults env-knob discipline): a typo'd rate must not
        # surface as a bare float() error or an internal parameter
        # name the operator never set.
        from keystone_tpu_torch.utils.faults import _env_number

        head_rate = _env_number(TRACE_SAMPLE_ENV, rate, float, 0.0)
        if head_rate > 1.0:
            raise ValueError(
                f"{TRACE_SAMPLE_ENV}={rate!r} must be a keep rate "
                "in [0, 1]"
            )
        slow_ms = os.environ.get(TRACE_SLOW_MS_ENV, "").strip()
        slow_s = None
        if slow_ms:
            slow_s = _env_number(TRACE_SLOW_MS_ENV, slow_ms, float, 0.0)
            slow_s = slow_s / 1e3 if slow_s > 0 else None
        sampler = TailSampler(head_rate=head_rate, slow_s=slow_s)
    return tracing(directory, serving_sampler=sampler)
