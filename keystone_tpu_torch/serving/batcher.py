"""Deadline-aware micro-batching server over an ExportedPlan (port of
``keystone_tpu/serving/batcher.py``).

The throughput argument is the same amortize-fixed-costs one the offline
tiers make for compile/pad machinery: a device dispatch (a CUDA-graph
replay) costs about the same
whether it carries 1 row or 256, so a stream of single-datum requests is
served at hardware rate only if something coalesces them. This module is
that something:

  - Submitters call :meth:`MicroBatchServer.submit` and get a
    ``concurrent.futures.Future``; they never touch torch.
  - ONE background worker thread owns the queue and ALL device
    interaction — the same thread discipline as data/prefetch.py's
    Prefetcher (there the reader owns disk+numpy and the consumer owns
    the device; here the submitters own numpy and the worker owns
    the device). Errors
    raised by the plan re-raise in the submitter through the future.
  - Batches form on whichever comes first: ``max_batch`` requests
    queued, the oldest request has waited ``max_wait_ms``, or a request
    deadline is imminent. The batch runs at the smallest pre-compiled
    padding bucket that fits; padding rows are masked off the response.
  - The queue is bounded. When full, admission sheds by
    earliest-deadline-first: the request with the least remaining
    deadline budget (ties: oldest enqueue) is rejected with
    :class:`ServerOverloaded` — explicitly, through its future (or
    synchronously to the submitter when the new request is the victim).
    Nothing is ever silently dropped.
  - Shutdown (:meth:`close`) is part of the contract, mirroring
    ``tests/test_prefetch.py``'s coverage: the executing batch completes,
    queued-but-unstarted requests fail with :class:`ServerClosed`, the
    worker thread joins — no deadlock, no leak.
  - Degradation is explicit (docs/reliability.md): a CIRCUIT BREAKER
    counts consecutive plan failures and OPENs past ``breaker_threshold``
    — submissions then fail fast with :class:`ServerDegraded` instead of
    queueing against a plan that is failing every batch; after
    ``breaker_reset_s`` one half-open probe batch is admitted and a
    success re-closes the breaker. A worker WATCHDOG catches the worker
    thread dying on an unexpected error: every queued and in-flight
    future fails loudly with :class:`ServerDegraded` (cause chained) and
    later submissions raise immediately — submitters never hang on a
    dead server. The ``serving.execute`` fault site
    (:mod:`keystone_tpu_torch.utils.faults`) drives both paths in chaos tests.

Observability: per-request spans (queue wait / pad fraction / batch exec
time) are recorded through :class:`keystone_tpu_torch.utils.profiling.SpanLog`,
and :meth:`stats` exposes p50/p99 latency plus throughput counters
computed over completions. End-to-end latency lives in a MERGEABLE
log-bucketed histogram (``obs.BucketedHistogram``): O(1)
memory over an unbounded serve and percentiles over the WHOLE run, not
the last few seconds of ring window; the queue-wait/exec split keeps
the exact sample ring (its window is the span log, a deliberate
recent-window view). When an :class:`~keystone_tpu_torch.obs.slo.SLOTracker`
is attached (``slo=``), every completion/shed/failure feeds it — the
server itself is the SLI source, so the OK/WARN/BREACH verdict is live,
not a post-hoc loadgen artifact. Under tracing, per-request spans are
TAIL-SAMPLED when the tracer carries a sampler (errors/sheds/slow
requests always kept), and kept spans attach ``run_id/span_id``
exemplars to their latency bucket — a p99 breach links directly to
offending traces.
"""

from __future__ import annotations

import contextlib
import gc
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs.metrics import (
    METRIC_SERVING_BREAKER_OPENS,
    METRIC_SERVING_COMPLETED,
    METRIC_SERVING_DEGRADED_REJECTED,
    METRIC_SERVING_FAILED,
    METRIC_SERVING_LATENCY_S,
    METRIC_SERVING_QUEUE_DEPTH,
    METRIC_SERVING_REJECTED,
)
from keystone_tpu_torch.utils import faults, profiling

__all__ = [
    "MicroBatchServer",
    "ServerClosed",
    "ServerDegraded",
    "ServerOverloaded",
]


_HEAP_LOCK = threading.Lock()
_HEAP_DEPTH = 0


@contextlib.contextmanager
def frozen_heap():
    """Serve with the heap built so far out of the garbage collector's
    reach (port only; ROADMAP C.14).

    A full (generation 2) collection walks every tracked object of the
    process, torch's module state and the fitted pipelines most of it,
    and stops every serving thread and submitter while it runs. On an
    H100's host such a pass paused the eight-tenant isolation drill for
    0.18-0.31 s; the open-loop arrivals of the paused window then landed
    as one burst past a base-rate tenant's queue cap of 8. The outermost
    such block collects once and freezes what survives (``gc.freeze()``),
    so collections inside it walk only what was made since; its exit
    hands the heap back (``gc.unfreeze()``), even if the block raised.
    Nested blocks do nothing.

    CPython unfreezes its whole permanent generation at once, whoever
    froze it, so this belongs to the code that owns the process's heap
    (``run.py serve``, a fleet plane's ``plane_main``), not to a server
    class.
    """
    global _HEAP_DEPTH
    with _HEAP_LOCK:
        _HEAP_DEPTH += 1
        if _HEAP_DEPTH == 1:
            gc.collect()
            gc.freeze()
    try:
        yield
    finally:
        with _HEAP_LOCK:
            _HEAP_DEPTH -= 1
            if _HEAP_DEPTH == 0:
                gc.unfreeze()


class ServerOverloaded(RuntimeError):
    """The bounded request queue shed this request (load exceeded the
    server's configured depth). Submitters should back off or retry
    against another replica — the request was NOT executed."""


class ServerClosed(RuntimeError):
    """The server was shut down before this request executed."""


class ServerDegraded(RuntimeError):
    """The server is failing fast: the circuit breaker is OPEN (the
    plan failed ``breaker_threshold`` consecutive batches) or the worker
    thread died. The request was NOT executed; submitters should back
    off or fail over — queueing more work against a failing plan only
    converts each request into a slow error."""


class _Request:
    __slots__ = ("x", "future", "enqueue_t", "deadline_t", "is_probe")

    def __init__(self, x, future: Future, enqueue_t: float, deadline_t: float):
        self.x = x
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.is_probe = False  # the half-open breaker's single probe

    def shed_key(self):
        # Earliest deadline first; among equal deadlines (including the
        # no-deadline +inf class) the oldest request sheds first.
        return (self.deadline_t, self.enqueue_t)

    def resolve(self, value=None, exc: Optional[BaseException] = None) -> bool:
        """Resolve the future, tolerating client-side ``Future.cancel()``:
        set_result/set_exception raise InvalidStateError on a cancelled
        future, and an unguarded raise here would kill the worker thread
        — every later request would then hang forever. Returns whether
        the value/exception was actually delivered."""
        try:
            if not self.future.set_running_or_notify_cancel():
                return False  # client cancelled before dispatch
        except RuntimeError:
            # Already resolved — the watchdog may sweep a batch whose
            # early members the worker finished before dying.
            return False
        try:
            if exc is not None:
                self.future.set_exception(exc)
            else:
                self.future.set_result(value)
            return True
        except Exception:  # racy double-resolution: never worker-fatal
            return False


class MicroBatchServer:
    """Serve an :class:`~keystone_tpu_torch.serving.export.ExportedPlan` online.

    Knobs (the latency-vs-throughput surface, docs/serving.md):

      - ``max_batch``: coalescing ceiling (clamped to the plan's).
      - ``max_wait_ms``: longest the oldest request waits for co-riders.
        0 disables coalescing-by-wait (dispatch as fast as the worker
        loops — batches still form under backlog).
      - ``max_queue_depth``: bound on queued-not-yet-dispatched requests;
        beyond it admission sheds earliest-deadline-first.
      - ``breaker_threshold`` / ``breaker_reset_s``: consecutive plan
        failures before the circuit breaker OPENs (submit then fails
        fast with :class:`ServerDegraded`), and the cooldown before a
        half-open probe is admitted. ``breaker_threshold=0`` disables
        the breaker (pre-reliability behavior).
      - ``slo``: an :class:`~keystone_tpu_torch.obs.slo.SLOTracker` fed one
        outcome per request — completions with their end-to-end
        latency, sheds/breaker rejects/failures as bad events.
    """

    def __init__(
        self,
        plan,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_queue_depth: int = 1024,
        span_log_len: int = 4096,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 1.0,
        replica_index: Optional[int] = None,
        slo=None,
    ):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if breaker_threshold < 0:
            raise ValueError("breaker_threshold must be >= 0")
        self.plan = plan
        self.max_batch = min(
            int(plan.max_batch if max_batch is None else max_batch),
            plan.max_batch,
        )
        if self.max_batch < 1:
            # A non-positive cap would make the worker pop empty batches
            # in a hot loop while every request hangs — fail at build.
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue_depth = int(max_queue_depth)
        # Span attribution tag for the replicated plane (None standalone).
        self.replica_index = replica_index

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: Deque[_Request] = deque()
        # Count of queued requests carrying a FINITE deadline: when zero
        # (the common case), admission shedding and the worker's
        # coalescing wait skip their O(queue) deadline scans — at depth
        # 4096 those scans run under the same lock the dispatch path
        # needs and would inflate exactly the p99 tail being measured.
        self._finite_deadlines = 0
        self._closed = False

        # Circuit breaker + worker watchdog state (all under _lock).
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self._consecutive_failures = 0
        self._breaker_open = False
        self._breaker_opened_t = 0.0
        self._breaker_probing = False  # ONE half-open probe in flight
        self._worker_dead = False

        # Rolling observability state. The counters and the latency
        # histogram are REGISTERED metrics (obs.MetricsRegistry
        # is the single store stats() reads; the legacy attribute names
        # stay as properties below). The span ring keeps its own
        # SpanLog shape — it carries structured RequestSpans, not
        # scalars — and bridges into the tracer when one is active.
        # End-to-end latency is a BUCKETED histogram: a
        # 4096-sample ring silently biased a multi-hour serve's p99
        # toward the last few seconds; log buckets keep the whole run at
        # O(1) memory and merge exactly across replicas.
        self.span_log = profiling.SpanLog(maxlen=span_log_len)
        self.metrics = obs.MetricsRegistry()
        self._completed = self.metrics.counter(METRIC_SERVING_COMPLETED)
        self._rejected = self.metrics.counter(METRIC_SERVING_REJECTED)
        self._failed = self.metrics.counter(METRIC_SERVING_FAILED)
        self._breaker_opens = self.metrics.counter(
            METRIC_SERVING_BREAKER_OPENS
        )
        self._degraded_rejected = self.metrics.counter(
            METRIC_SERVING_DEGRADED_REJECTED
        )
        self._latencies = self.metrics.bucketed_histogram(
            METRIC_SERVING_LATENCY_S
        )
        self._queue_depth = self.metrics.gauge(METRIC_SERVING_QUEUE_DEPTH)
        self._slo = slo
        self._first_done_t: Optional[float] = None
        self._last_done_t: Optional[float] = None

        self._thread = threading.Thread(
            target=self._worker, name="keystone-serving-batcher", daemon=True
        )
        self._thread.start()

    # -- legacy counter attributes (now registry-backed) -------------------

    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    @property
    def failed(self) -> int:
        return int(self._failed.value)

    @property
    def breaker_opens(self) -> int:
        return int(self._breaker_opens.value)

    @property
    def degraded_rejected(self) -> int:
        return int(self._degraded_rejected.value)

    # -- submit side -------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the plan's
        output row for it. Raises :class:`ServerClosed` after close();
        raises :class:`ServerOverloaded` when the queue is full and this
        request is the shedding victim (otherwise the victim's future
        receives it). Every shed/degraded rejection feeds the attached
        SLO tracker as a bad event — admission control spends error
        budget, visibly."""
        try:
            return self._submit(x, deadline_ms)
        except (ServerOverloaded, ServerDegraded):
            if self._slo is not None:
                self._slo.observe(ok=False)
            raise

    def _submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        now = time.perf_counter()
        deadline_t = (
            now + float(deadline_ms) / 1e3 if deadline_ms is not None
            else math.inf
        )
        req = _Request(np.asarray(x), Future(), now, deadline_t)
        shed: Optional[_Request] = None
        with self._cond:
            if self._closed:
                raise ServerClosed("submit() after close()")
            if self._worker_dead:
                raise ServerDegraded(
                    "serving worker thread died; the server cannot "
                    "execute requests (restart it)"
                )
            if self._breaker_open:
                elapsed = now - self._breaker_opened_t
                if elapsed >= self.breaker_reset_s and not self._breaker_probing:
                    # Half-open: admit EXACTLY ONE probe. The breaker
                    # stays open for everyone else until the probe
                    # batch's outcome lands — otherwise full offered
                    # load would pour in against the still-unverified
                    # plan during the probe's execution. The flag is
                    # only set AFTER the request actually enqueues (a
                    # shed on the full queue below must not leak the
                    # probe slot with no probe in flight).
                    req.is_probe = True
                else:
                    self._degraded_rejected.add(1)
                    raise ServerDegraded(
                        f"circuit breaker open: the plan failed "
                        f"{self._consecutive_failures} consecutive "
                        f"batches; retrying in "
                        f"{self.breaker_reset_s:.3g}s windows"
                    )
            if len(self._pending) >= self.max_queue_depth:
                if self._finite_deadlines:
                    victim = min(self._pending, key=_Request.shed_key)
                else:
                    victim = self._pending[0]  # all +inf: oldest sheds
                if victim.shed_key() <= req.shed_key():
                    self._pending.remove(victim)
                    if victim.deadline_t != math.inf:
                        self._finite_deadlines -= 1
                    if victim.is_probe:
                        # A shed probe never executes: free the slot or
                        # the breaker would reject forever.
                        self._breaker_probing = False
                    shed = victim
                else:
                    self._rejected.add(1)
                    raise ServerOverloaded(
                        f"queue full ({self.max_queue_depth}) and this "
                        f"request holds the earliest deadline"
                    )
            self._pending.append(req)
            if req.is_probe:
                self._breaker_probing = True
            if req.deadline_t != math.inf:
                self._finite_deadlines += 1
            if shed is not None:
                self._rejected.add(1)
            self._queue_depth.set(len(self._pending))
            if obs.enabled():
                # Counter track: queued depth at every admission — the
                # load picture in the Perfetto view (same name as the
                # registered gauge, sampled over time instead of
                # point-in-time).
                obs.counter_track(METRIC_SERVING_QUEUE_DEPTH,
                                  len(self._pending))
            self._cond.notify()
        if shed is not None:
            shed.resolve(exc=ServerOverloaded(
                f"shed (earliest deadline first) at queue depth "
                f"{self.max_queue_depth}"
            ))
            # A shed victim is a bad SLI event and an always-keep trace
            # span (tail sampling never drops sheds): the overload story
            # must survive into both the budget ledger and the trace.
            if self._slo is not None:
                self._slo.observe(ok=False)
            tracer = obs.active_tracer()
            if tracer is not None:
                tracer.add_serving_span(
                    "serving.request", shed.enqueue_t, time.perf_counter(),
                    flagged=True, outcome="shed",
                    replica=self.replica_index,
                )
        return req.future

    def set_admission_params(
        self,
        max_wait_ms: Optional[float] = None,
        max_queue_depth: Optional[int] = None,
    ) -> None:
        """Adjust the admission knobs of a LIVE server — the replicated
        plane's brownout ladder widens the coalescing deadline and
        tightens the shed depth without a worker-generation swap. Takes
        effect immediately: the worker re-reads ``max_wait_s`` on every
        coalescing pass (it is woken here), and the next admission sheds
        against the new depth. Shrinking the depth does NOT retroactively
        shed already-queued requests — each new arrival over the bound
        evicts one earliest-deadline victim, so the queue converges
        without a shed burst."""
        with self._cond:
            if max_wait_ms is not None:
                if max_wait_ms < 0:
                    raise ValueError("max_wait_ms must be >= 0")
                self.max_wait_s = float(max_wait_ms) / 1e3
            if max_queue_depth is not None:
                if max_queue_depth < 1:
                    raise ValueError("max_queue_depth must be >= 1")
                self.max_queue_depth = int(max_queue_depth)
            self._cond.notify_all()

    # -- worker side -------------------------------------------------------

    def _worker(self) -> None:
        batch: Optional[List[_Request]] = None
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                if batch:  # empty = a close() drained the queue mid-wait
                    self._execute(batch)
                batch = None
        except BaseException as e:  # noqa: BLE001 — watchdog of last resort
            self._worker_died(e, batch or [])

    def _worker_died(self, exc: BaseException,
                     inflight: List[_Request]) -> None:
        """Watchdog: the worker loop itself failed (not a plan error —
        those are caught in :meth:`_execute`). Fail every in-flight and
        queued future loudly and poison submit, so no submitter ever
        blocks on a Future nothing will resolve."""
        with self._cond:
            self._worker_dead = True
            drained = list(self._pending)
            self._pending.clear()
            self._finite_deadlines = 0
            self._cond.notify_all()
        # The postmortem block: recent spans + cost decisions + whatever
        # was in flight when the worker died, dumped beside the
        # exception (obs flight recorder).
        obs.flight.dump_flight_record(
            f"serving worker thread died (replica={self.replica_index}, "
            f"inflight={len(inflight)}, queued={len(drained)})", exc,
        )
        err = ServerDegraded(f"serving worker thread died: {exc!r}")
        err.__cause__ = exc
        for r in inflight + drained:
            r.resolve(exc=err)

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is due (fill, wait-out, or deadline), pop
        it FIFO. None = closed and drained (worker exits)."""
        with self._cond:
            while not self._pending:
                if self._closed:
                    return None
                self._cond.wait()
            while (
                self._pending
                and len(self._pending) < self.max_batch
                and not self._closed
            ):
                # Re-read the head each pass: EDF admission shedding may
                # have evicted the request the timer was anchored to, and
                # a stale anchor would cut the coalescing window short
                # exactly under overload.
                first = self._pending[0]
                dispatch_at = first.enqueue_t + self.max_wait_s
                if self._finite_deadlines:
                    dispatch_at = min(
                        dispatch_at,
                        min(r.deadline_t for r in self._pending),
                    )
                remaining = dispatch_at - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            m = min(self.max_batch, len(self._pending))
            batch = [self._pending.popleft() for _ in range(m)]
            self._finite_deadlines -= sum(
                1 for r in batch if r.deadline_t != math.inf
            )
            return batch

    def _execute(self, batch: List[_Request]) -> None:
        t0 = time.perf_counter()
        try:
            faults.maybe_fail(faults.SITE_SERVING_EXECUTE)
            outs, info = self.plan.apply_batch_info([r.x for r in batch])
        except BaseException as e:  # noqa: BLE001 — re-raised submitter-side
            opened = False
            with self._lock:
                self._failed.add(len(batch))
                if self.breaker_threshold:
                    self._consecutive_failures += 1
                    if self._breaker_probing and any(
                        r.is_probe for r in batch
                    ):
                        # THE half-open probe failed: re-open and
                        # restart the cooldown. Both conditions matter:
                        # batch membership keeps a pre-open queued batch
                        # failing during the probe's wait from being
                        # misattributed, and the probing flag keeps a
                        # STALE probe (breaker already re-closed by an
                        # earlier batch's success) from bumping
                        # breaker_opens on a closed breaker — a stale
                        # probe's failure counts like any other.
                        self._breaker_probing = False
                        self._breaker_open = True
                        self._breaker_opened_t = time.perf_counter()
                        self._breaker_opens.add(1)
                        opened = True
                    elif (
                        self._consecutive_failures >= self.breaker_threshold
                        and not self._breaker_open
                    ):
                        self._breaker_open = True
                        self._breaker_opened_t = time.perf_counter()
                        self._breaker_opens.add(1)
                        opened = True
            if opened:
                # Postmortem context rides the log beside the open: the
                # recent spans/decisions and anything still in flight
                # (obs flight recorder).
                obs.flight.dump_flight_record(
                    f"serving circuit breaker OPENED (replica="
                    f"{self.replica_index}, consecutive_failures="
                    f"{self._consecutive_failures})", e,
                )
            # Failed requests: always-keep trace spans (errors are never
            # tail-sampled out) and bad SLI events for the budget ledger.
            t_err = time.perf_counter()
            tracer = obs.active_tracer()
            for r in batch:
                if tracer is not None:
                    tracer.add_serving_span(
                        "serving.request", r.enqueue_t, t_err,
                        flagged=True, outcome="error",
                        error=f"{type(e).__name__}: {e}",
                        replica=self.replica_index,
                    )
                r.resolve(exc=e)
                if self._slo is not None:
                    self._slo.observe(ok=False)
            return
        with self._lock:
            # Any successful batch (including the half-open probe)
            # re-closes the breaker.
            self._consecutive_failures = 0
            self._breaker_open = False
            self._breaker_probing = False
        t1 = time.perf_counter()
        exec_s = t1 - t0
        # Bridge into the run trace (one branch when disabled): one span
        # per request (enqueue -> completion, the end-to-end latency the
        # SLO gates) on the serving worker's track, plus a batch span.
        # The rolling SpanLog/stats() machinery keeps working unchanged
        # — the tracer is the correlated view, not a replacement.
        tracer = obs.active_tracer()
        if tracer is not None:
            tracer.add_span(
                "serving.batch", t0, t1, batch_size=info.batch_size,
                bucket=info.bucket, pad_fraction=info.pad_fraction,
                replica=self.replica_index,
            )
        for i, r in enumerate(batch):
            self.span_log.record(profiling.RequestSpan(
                queue_wait_s=t0 - r.enqueue_t,
                exec_s=exec_s,
                batch_size=info.batch_size,
                bucket=info.bucket,
                pad_fraction=info.pad_fraction,
                replica=self.replica_index,
            ))
            lat = t1 - r.enqueue_t
            exemplar = None
            if tracer is not None:
                # Tail-sampled: the tracer's sampler (when installed)
                # head-samples healthy fast requests but always keeps
                # slow ones and breaker probes. A KEPT span's id becomes
                # the exemplar its latency bucket carries — the
                # p99-breach→trace link.
                sid = tracer.add_serving_span(
                    "serving.request", r.enqueue_t, t1,
                    flagged=r.is_probe,
                    queue_wait_s=t0 - r.enqueue_t, exec_s=exec_s,
                    bucket=info.bucket, replica=self.replica_index,
                )
                if sid is not None:
                    exemplar = f"{tracer.run_id}/{sid}"
            with self._lock:
                self._latencies.observe(lat, exemplar=exemplar)
                self._completed.add(1)
                if self._first_done_t is None:
                    self._first_done_t = t1
                self._last_done_t = t1
            r.resolve(outs[i])
            if self._slo is not None:
                self._slo.observe(latency_s=lat, ok=True)

    # -- observability -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Requests queued but not yet dispatched (the admission side of
        the load picture; in-flight batches are not counted)."""
        with self._lock:
            return len(self._pending)

    def stats(self) -> Dict[str, Any]:
        """Latency percentiles + throughput counters; None until
        something completes. End-to-end ``p50/p99_latency_s`` come from
        the WHOLE-RUN bucketed histogram (exact to within one ~8%
        bucket — a multi-hour serve's p99 is the run's p99, not the
        last ring window's), while the queue-wait/exec split below
        stays exact over the span-log window.

        End-to-end latency is reported SPLIT into its two sides —
        ``p50/p99_queue_wait_s`` (time queued before the batch
        dispatched) and ``p50/p99_exec_s`` (the batch's execution wall)
        — so admission-control tuning can see which side of the SLO is
        burning budget: queue-wait blowing up wants a lower
        ``max_wait_ms``/``max_queue_depth`` (or another replica), exec
        blowing up wants a smaller ``max_batch`` or a faster plan."""
        with self._lock:
            completed, rejected, failed = (
                self.completed, self.rejected, self.failed
            )
            t_span = (
                self._last_done_t - self._first_done_t
                if self._first_done_t is not None else None
            )
            breaker_state = self._breaker_state_locked()
            breaker_opens = self.breaker_opens
            degraded_rejected = self.degraded_rejected
            consecutive_failures = self._consecutive_failures
        # One consistent histogram read (count + sum + percentiles under
        # a single lock acquisition — the snapshot-vs-observe race the
        # registry regression test pins).
        lat = self._latencies.stats_snapshot()
        # ONE ring copy: the wait/exec percentiles and the summary all
        # derive from the same snapshot (stats() polls contend the span
        # lock with the worker's record() on the serving hot path).
        spans = self.span_log.snapshot()
        wait_pct = profiling.latency_percentiles(
            [s.queue_wait_s for s in spans]
        )
        exec_pct = profiling.latency_percentiles([s.exec_s for s in spans])
        span_summary = profiling.summarize_spans(spans)
        return {
            "completed": completed,
            "rejected": rejected,
            "failed": failed,
            "breaker_state": breaker_state,
            "breaker_opens": breaker_opens,
            "degraded_rejected": degraded_rejected,
            "consecutive_failures": consecutive_failures,
            "p50_latency_s": lat["p50"],
            "p99_latency_s": lat["p99"],
            # The two sides of end-to-end latency, separately (over the
            # span_log window — admission-control tuning reads these).
            "p50_queue_wait_s": wait_pct["p50"] if wait_pct else None,
            "p99_queue_wait_s": wait_pct["p99"] if wait_pct else None,
            "p50_exec_s": exec_pct["p50"] if exec_pct else None,
            "p99_exec_s": exec_pct["p99"] if exec_pct else None,
            "num_latency_samples": lat["count"],
            # completions/second across the observed completion span;
            # needs >= 2 completions to bound a span.
            "achieved_qps": (
                (completed - 1) / t_span if t_span else None
            ),
            "mean_pad_fraction": span_summary.get("mean_pad_fraction"),
            "mean_batch_size": span_summary.get("mean_batch_size"),
            "mean_queue_wait_s": span_summary.get("mean_queue_wait_s"),
            # The full span summary of the same one snapshot, so
            # aggregators (the replicated plane) never re-copy the ring.
            "span_summary": span_summary,
        }

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the server: the batch currently executing completes,
        queued-but-unstarted requests fail with :class:`ServerClosed`,
        and the worker thread joins. Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            drained = list(self._pending)
            self._pending.clear()
            self._finite_deadlines = 0
            self._cond.notify_all()
        for r in drained:
            r.resolve(exc=ServerClosed(
                "server closed before this request executed"
            ))
        if not already:
            self._thread.join(timeout=timeout)

    def _breaker_state_locked(self) -> str:
        if self._worker_dead:
            return "dead"
        if not self.breaker_threshold:
            return "disabled"
        if self._breaker_open:
            if self._breaker_probing or (
                time.perf_counter() - self._breaker_opened_t
                >= self.breaker_reset_s
            ):
                # Probe in flight, or the next submit is admitted as one.
                return "half_open"
            return "open"
        return "closed"

    @property
    def breaker_state(self) -> str:
        """"closed" / "open" / "half_open" / "disabled" / "dead"."""
        with self._lock:
            return self._breaker_state_locked()

    @property
    def routing_state(self) -> "tuple[str, bool]":
        """``(breaker_state, probe_free)`` in ONE lock acquisition — the
        replicated plane's router reads both per candidate per submit
        while holding its own global lock, so splitting them across two
        property calls would double the contended server-lock traffic
        on the admission path. ``probe_free`` is True only when the
        breaker is half-open with the probe slot FREE: while a probe is
        already in flight the state reads ``half_open`` but every
        further submit fails fast, so a router should not offer this
        server traffic until the slot resolves."""
        with self._lock:
            state = self._breaker_state_locked()
            return state, (state == "half_open"
                           and not self._breaker_probing)

    @property
    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "MicroBatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
