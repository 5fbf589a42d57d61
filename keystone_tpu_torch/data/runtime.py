"""The data-plane runtime: one owner for every IO thread (port of
``keystone_tpu/data/runtime.py``).

  - **Named serial lanes.** ``submit(site, fn, *args)`` runs ``fn`` on
    the worker thread dedicated to ``site`` (created lazily, named
    ``keystone-io-<site>``). One worker per lane makes per-lane FIFO
    ordering structural: the checkpoint writer's snapshot order needs no
    extra synchronization, while distinct lanes (``read`` /
    ``checkpoint`` / ``serve``) overlap each other and device compute.
  - **Host work only.** This module imports no torch and its workers run
    submitted host work only (disk, numpy, checksums); device work stays
    on the thread that owns it.
  - **Bounded queues.** Each lane's queue is bounded (``queue_depth``);
    a producer that outruns its lane blocks at ``submit`` —
    backpressure, never unbounded staging memory.
  - **Fault/retry integration.** Submitted callables keep their own
    :mod:`keystone_tpu_torch.utils.faults` sites (``checkpoint.write``),
    so a chaos drill holds on the pooled threads as on inline calls.
  - **Clean shutdown.** ``close()`` cancels queued tasks not yet
    started, lets in-flight tasks complete, and joins EVERY worker. The
    process-wide default runtime closes at interpreter exit.

The runtime's :meth:`DataPlaneRuntime.stats` reports per-lane lifetime
totals (tasks, busy seconds, errors, queue depth), held in a
:class:`~keystone_tpu_torch.obs.metrics.MetricsRegistry`, and every task
runs under a ``runtime.task`` span when the obs plane is tracing. Its
users: the checkpoint write-behind lane (``data/durable.py``) and the
prefetcher's read lane (``data/prefetch.py``).
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs.metrics import (
    METRIC_RUNTIME_LANE_BUSY_S,
    METRIC_RUNTIME_LANE_ERRORS,
    METRIC_RUNTIME_LANE_QUEUED,
    METRIC_RUNTIME_LANE_TASKS,
)

__all__ = [
    "DataPlaneRuntime",
    "LANE_CHECKPOINT",
    "LANE_READ",
    "LANE_SERVE",
    "default_runtime",
]

# Canonical lane names (free-form strings are allowed; these are the
# ones the data plane itself uses — the docs/data.md ownership table).
LANE_READ = "read"
LANE_CHECKPOINT = "checkpoint"
LANE_SERVE = "serve"

_SENTINEL = object()


class _Lane:
    """One named worker thread + its bounded FIFO queue. Lifetime
    counters are registered metrics on the owning runtime's
    :class:`~keystone_tpu.obs.metrics.MetricsRegistry` (labeled by
    ``site``) — the single store :meth:`DataPlaneRuntime.stats` reads."""

    def __init__(self, site: str, depth: int, metrics):
        self.site = site
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._tasks = metrics.counter(METRIC_RUNTIME_LANE_TASKS, site=site)
        self._errors = metrics.counter(METRIC_RUNTIME_LANE_ERRORS, site=site)
        self._busy_s = metrics.counter(METRIC_RUNTIME_LANE_BUSY_S, site=site)
        self._queued = metrics.gauge(METRIC_RUNTIME_LANE_QUEUED, site=site)
        # Set (before the sentinel is enqueued) by the runtime's
        # close(); submit() re-checks it AFTER its put so a task that
        # raced behind the sentinel is cancelled loudly, never stranded
        # unresolved on a queue no worker reads.
        self.closed = False
        self._thread = threading.Thread(
            target=self._worker, name=f"keystone-io-{site}", daemon=True
        )
        self._thread.start()

    # Legacy attribute views (the pre-registry stats shape — tests and
    # dashboards read these through snapshot()).
    @property
    def tasks(self) -> int:
        return int(self._tasks.value)

    @property
    def errors(self) -> int:
        return int(self._errors.value)

    @property
    def busy_s(self) -> float:
        return self._busy_s.value

    def _worker(self):
        """Drain the lane FIFO. Runs submitted host work only; device
        interaction stays on the thread that owns it."""
        while True:
            item = self.queue.get()
            if item is _SENTINEL:
                # A submit racing close() may have landed tasks behind
                # the sentinel; cancel them so their futures resolve
                # (the racing submit sees the cancellation and raises).
                try:
                    while True:
                        late = self.queue.get_nowait()
                        if late is not _SENTINEL:
                            late[0].cancel()
                except queue.Empty:
                    pass
                return
            fut, fn, args, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue  # cancelled before it started
            t0 = time.perf_counter()
            # The lane-task span: every pooled-IO task is visible in the
            # trace on its worker's own track (one no-op branch when
            # tracing is off). The submitted fn keeps its own deeper
            # spans (prefetch.read, checkpoint.write) as children.
            with obs.span("runtime.task", lane=self.site,
                          fn=getattr(fn, "__name__", type(fn).__name__)):
                try:
                    result = fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — via future
                    self._errors.add(1)
                    fut.set_exception(e)
                else:
                    fut.set_result(result)
                finally:
                    dt = time.perf_counter() - t0
                    self._tasks.add(1)
                    self._busy_s.add(dt)

    def snapshot(self) -> Dict[str, Any]:
        self._queued.set(self.queue.qsize())
        return {
            "tasks": self.tasks,
            "errors": self.errors,
            "busy_s": self.busy_s,
            "queued": self.queue.qsize(),
            "alive": self._thread.is_alive(),
        }

    def close(self, timeout: float) -> None:
        self.queue.put(_SENTINEL)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # join(timeout=...) returns silently on timeout; a wedged
            # in-flight task (hung NFS read) would otherwise leak this
            # worker invisibly — the exact opposite of the documented
            # "loud, no leaked threads" contract. Warn; raising here
            # would break atexit / best-effort shutdown paths.
            import logging

            logging.getLogger("keystone_tpu.runtime").warning(
                "keystone-io-%s worker did not join within %.1fs "
                "(in-flight task wedged?); thread leaked", self.site,
                timeout,
            )


class DataPlaneRuntime:
    """Submit/future executor over named serial IO lanes.

    >>> rt = DataPlaneRuntime()
    >>> fut = rt.submit("read", load_segment, 3)
    >>> payload = fut.result()   # raises the task's exception, if any
    >>> rt.close()

    Contracts every consumer leans on:

      - per-lane FIFO: two submissions to one site run in submission
        order (one worker per lane);
      - a returned :class:`concurrent.futures.Future` resolves with the
        task's result or exception — never silently;
      - ``submit`` blocks only when the lane's bounded queue is full
        (backpressure) or raises :class:`RuntimeError` after close;
      - ``close()`` cancels queued-but-unstarted tasks, waits out the
        in-flight ones, and joins every worker thread.
    """

    def __init__(self, queue_depth: int = 64, metrics=None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self._depth = int(queue_depth)
        self._lanes: Dict[str, _Lane] = {}
        self._lock = threading.Lock()
        self._closed = False
        # The runtime's lifetime counters live in ONE registry: stats()
        # is a projection of it, and ops tooling can read the flat
        # snapshot() directly.
        self.metrics = metrics if metrics is not None else (
            obs.MetricsRegistry()
        )

    # -- submission --------------------------------------------------------

    def _lane(self, site: str) -> _Lane:
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "DataPlaneRuntime is closed; create a new runtime "
                    "(or use default_runtime(), which replaces a closed "
                    "default)"
                )
            lane = self._lanes.get(site)
            if lane is None:
                lane = _Lane(site, self._depth, self.metrics)
                self._lanes[site] = lane
            return lane

    def submit(self, site: str, fn: Callable, *args, **kwargs) -> Future:
        """Run ``fn(*args, **kwargs)`` on ``site``'s worker; FIFO per
        site. The callable must be host-only work (disk/numpy); its
        exceptions surface through the returned future, never on the
        worker."""
        lane = self._lane(site)
        fut: Future = Future()
        lane.queue.put((fut, fn, args, kwargs))
        if obs.enabled():
            # Counter track: queue depth per lane at every submit — the
            # backpressure picture in the Perfetto view. Guarded so the
            # disabled path pays one branch, not an f-string.
            obs.counter_track(f"runtime.{site}.queued",
                              lane.queue.qsize())
        # close() may have run between _lane()'s check and our put: it
        # marks the lane closed BEFORE draining/sentinel, so re-checking
        # here catches every interleaving. If the cancel wins (the task
        # has not started — either a drain got it or it sits stranded
        # behind the sentinel), fail the submit loudly instead of
        # handing back a future nobody will ever run; if the worker
        # already started it, the task completes normally.
        if lane.closed and fut.cancel():
            raise RuntimeError(
                "DataPlaneRuntime closed during submit; the task was "
                "cancelled before it started"
            )
        return fut

    def flush(self, site: Optional[str] = None, timeout: float = 60.0) -> None:
        """Block until every task queued so far on ``site`` (or on every
        lane) has finished — a FIFO barrier task per lane. Task errors do
        NOT surface here (they belong to their own futures)."""
        with self._lock:
            lanes = (
                list(self._lanes.values()) if site is None
                else [self._lanes[site]] if site in self._lanes else []
            )
        barriers = []
        for lane in lanes:
            fut: Future = Future()
            lane.queue.put((fut, lambda: None, (), {}))
            barriers.append(fut)
        for fut in barriers:
            fut.result(timeout=timeout)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-lane lifetime counters: tasks run, errors, busy seconds,
        current queue depth, worker liveness (the ops view). A
        projection of :attr:`metrics`
        (``metrics.snapshot()`` is the same data flat)."""
        with self._lock:
            lanes = dict(self._lanes)
        return {site: lane.snapshot() for site, lane in lanes.items()}

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The flat registry view of the same counters (``name{site=...}``
        keys) — what dashboards and bench rows read."""
        for lane in list(self._lanes.values()):
            lane.snapshot()  # refresh queue-depth gauges
        return self.metrics.snapshot()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Idempotent shutdown: refuse new submissions, cancel queued
        tasks that have not started, let in-flight tasks finish, and
        join every worker thread (no leaked runtime threads, ever)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            # Mark closed BEFORE draining: submit() re-checks this flag
            # after its put, so a task racing past _lane()'s check is
            # cancelled (by this drain, or by the worker's post-sentinel
            # sweep) instead of stranded unresolved.
            lane.closed = True
            # Cancel everything still queued; the sentinel then lands
            # behind the (at most one) in-flight task.
            try:
                while True:
                    item = lane.queue.get_nowait()
                    if item is not _SENTINEL:
                        item[0].cancel()
            except queue.Empty:
                pass
        for lane in lanes:
            lane.close(timeout)

    def __enter__(self) -> "DataPlaneRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[DataPlaneRuntime] = None


def default_runtime() -> DataPlaneRuntime:
    """The process-wide shared runtime (created lazily; a closed default
    is replaced — tests may close it freely). This is what the
    write-behind checkpoint layer uses when no explicit runtime is
    passed, so one pool of named IO workers serves the whole process
    instead of one thread per component."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT.closed:
            _DEFAULT = DataPlaneRuntime()
        return _DEFAULT


@atexit.register
def _close_default() -> None:  # pragma: no cover - interpreter exit
    with _DEFAULT_LOCK:
        if _DEFAULT is not None and not _DEFAULT.closed:
            _DEFAULT.close(timeout=5.0)
