"""Replicated serving plane: N micro-batch replicas behind one
admission-controlled front door (docs/serving.md; port of
``keystone_tpu/serving/replicas.py``).

A single :class:`~keystone_tpu_torch.serving.batcher.MicroBatchServer` is one
worker thread driving one plan — a replica death or a model refresh is a
full outage. This module composes the batcher's reliability ingredients
(per-replica circuit breakers, the worker watchdog, deterministic fault
sites) into the thing the north star actually requires: a serving plane
that keeps meeting its SLO while replicas die and plans swap underneath
live traffic.

  - **One front door.** Submitters call
    :meth:`ReplicatedServer.submit` exactly as they would a single
    server and get the same ``Future`` contract (result, or a NAMED
    error — nothing is ever silently dropped). Admission is decided at
    the front: a request is admitted iff some in-rotation replica
    admits it. The queue is logically one, physically partitioned per
    replica worker — a single shared deque would serialize every worker
    on one lock and put a cross-thread device handoff in the hot path;
    partitioning keeps each worker's dispatch loop lock-local while the
    admission decision (and its earliest-deadline-first shedding,
    delegated to the chosen replica's bounded queue) stays global.
  - **Least-loaded routing with per-replica breakers.** The replica
    with the fewest outstanding requests wins. A replica whose breaker
    is OPEN is removed from rotation entirely; when its cooldown
    elapses (state ``half_open``) the router deliberately hands it the
    next request as the recovery probe — without that, healthy replicas
    would absorb all traffic and an opened breaker could never re-close.
    If the chosen replica sheds or fails fast, the router FAILS OVER to
    the next candidate; only when every in-rotation replica rejects
    does the submitter see an error (``ServerOverloaded`` if anything
    shed on load, else ``ServerDegraded``).
  - **Replica watchdog + bounded restarts.** A background watchdog
    (numpy/threading only — it never touches the device) notices a
    dead replica worker and respawns it from the SAME exported plan.
    Each spawn attempt runs the ``serving.replica.spawn`` fault site
    and burns one unit of the per-replica ``restart_budget``; past the
    budget the replica is PERMANENTLY EVICTED — loudly: a warning log
    and ``stats()["degraded"]``/``evicted_replicas`` flip, because a
    plane quietly running at N-1 capacity is how the next death becomes
    an outage.
  - **Atomic zero-drop hot-swap.** :meth:`swap_plan` replaces the plan
    under live traffic, one replica at a time: the new plan is warm
    at the same padding buckets (export builds every bucket) *before*
    any capacity is taken out, then each replica in turn leaves rotation, drains its in-flight
    work to zero (queued requests finish — they are never failed), is
    closed, and re-enters rotation wrapped around the new plan. Each
    replica serves EXACTLY ONE plan version for the lifetime of its
    worker, every response's future carries that version's fingerprint
    (``fut.plan_fingerprint``), and no batch ever mixes versions — the
    bit-identity contract of docs/reliability.md is stated per
    fingerprint.
  - **Zero-drop elasticity.** :meth:`add_replica` and
    :meth:`remove_replica` are the first-class capacity primitives the
    SLO-closed-loop autoscaler (``serving/autoscale.py``) drives.
    Addition clones a live replica's (warm) plan BEFORE it enters rotation
    (spawn attempts run the ``serving.autoscale.spawn`` fault site with
    bounded retries inside the restart budget — a chaos kill mid-spawn
    is absorbed, never a dropped request). Removal reuses the hot-swap
    drain protocol: the victim leaves rotation, drains its admitted
    work to zero on the reservation counters, closes on an empty queue,
    and rotation membership updates atomically — and removal never
    picks the half-open-probe replica (evicting the probe would leave
    its breaker's recovery unobservable). At every instant
    ``offered == completed + rejected + failed``.
  - **Brownout ladder.** The wall past ``max_replicas``: when scale-up
    is exhausted and burn keeps rising, admission degrades in NAMED,
    REVERSIBLE steps (:data:`BROWNOUT_STEPS`, entered/exited strictly
    LIFO): ``widen_deadlines`` (coalescing windows stretch by
    ``brownout_wait_factor`` — bigger batches, more throughput per
    dispatch at a latency cost), then ``aggressive_shed`` (the EDF shed
    depth shrinks by ``brownout_shed_factor`` — load is refused
    earlier, explicitly), then ``reject_admissions`` (the front door
    fast-fails every new request with :class:`ServerOverloaded`).
    Every step keeps the zero-drop accounting: a browned-out rejection
    is a NAMED error and a counted bad SLI event, never a silent drop.
  - **Chaos-provable.** ``serving.replica.execute`` is a loop-level
    fault site on replica workers (outside the per-batch error guard —
    an injected error there kills the whole worker, watchdog
    territory); ``serving.replica.spawn`` fires per respawn attempt and
    ``serving.autoscale.spawn`` per scale-up spawn attempt.
    tests/test_chaos_replicas.py drives kill-mid-Poisson-storm and
    swap-under-load through them; tests/test_chaos_autoscale.py drives
    kill-mid-scale-up and the spike→recover→quiesce closed loop.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from keystone_tpu_torch import obs
from keystone_tpu_torch.obs.metrics import METRIC_SERVING_LATENCY_S
from keystone_tpu_torch.utils import faults, profiling

from .batcher import (
    MicroBatchServer,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
)
from .export import ExportedPlan

__all__ = ["BROWNOUT_STEPS", "ReplicatedServer"]

logger = logging.getLogger("keystone_tpu_torch.serving")

# Breaker states eligible for normal least-loaded routing.
_ROUTABLE = ("closed", "disabled")

# The overload brownout ladder, in ENTRY order (exit is strictly LIFO):
# each step is a named, reversible admission degradation the autoscaler
# climbs when scale-up is exhausted past max_replicas (module docstring).
BROWNOUT_STEPS = ("widen_deadlines", "aggressive_shed", "reject_admissions")


class _ReplicaBatchServer(MicroBatchServer):
    """A MicroBatchServer whose worker loop runs the
    ``serving.replica.execute`` fault site OUTSIDE the per-batch error
    guard: an injected error here propagates to the worker loop's
    watchdog-of-last-resort and kills the whole replica (every in-flight
    and queued future fails loudly with ServerDegraded) — modeling
    whole-replica death rather than one bad batch. The per-batch
    ``serving.execute`` site inside the guard still models plan/batch
    failures."""

    def _execute(self, batch) -> None:
        faults.maybe_fail(faults.SITE_REPLICA_EXECUTE)
        super()._execute(batch)


class _Replica:
    """One slot in the rotation: the current server generation, the
    plan it wraps, and the lifecycle counters. ``outstanding`` counts
    futures submitted through the front door and not yet resolved — the
    load signal routing sorts by, and the drain signal hot-swap waits
    on (mutated only under the ReplicatedServer lock / done-callbacks)."""

    __slots__ = (
        "index", "plan", "server", "outstanding", "restarts",
        "evicted", "out_of_rotation", "busy",
    )

    def __init__(self, index: int, plan: ExportedPlan,
                 server: MicroBatchServer):
        self.index = index
        self.plan = plan
        self.server = server
        self.outstanding = 0
        self.restarts = 0
        self.evicted = False
        self.out_of_rotation = False
        # Lifecycle ownership token (under the plane lock): exactly one
        # actor — the watchdog's restart or a swap — may be replacing
        # this replica's server generation at a time; without it a death
        # DURING a swap could have both spawn a server and leak one.
        self.busy = False


class ReplicatedServer:
    """Front N micro-batch replicas behind one admission-controlled
    submit path (module docstring for the full design).

    ``plans`` is one :class:`ExportedPlan` shared by every replica (the
    N-workers-on-one-device shape — a bucket's CUDA graph replays into
    static buffers, so each bucket program serialises its copy-in →
    replay → copy-out on its own lock: replicas take turns per bucket
    and run different buckets concurrently), a sequence of N plans (one
    copy per device), or a ``factory(replica_index) -> ExportedPlan``.
    All plans must serve the same request signature (item shape/dtype).

    Knobs beyond the per-replica ``MicroBatchServer`` surface:

      - ``num_replicas``: rotation size (ignored when ``plans`` is a
        sequence — its length wins).
      - ``restart_budget``: spawn attempts per replica before permanent
        eviction (0 = never restart, first death evicts).
      - ``watchdog_interval_s``: dead-replica detection cadence — the
        floor on restart latency, and therefore on how fast p99
        recovers after a kill.
      - ``drain_timeout_s``: hot-swap's bound on waiting for one
        replica's in-flight work; on timeout the replica re-enters
        rotation on its OLD plan and the swap raises (zero-drop is
        preserved either way).
      - ``slo``: an :class:`~keystone_tpu_torch.obs.slo.SLOTracker` fed at
        the FRONT DOOR (one outcome per admitted/rejected request, at
        future resolution) — the verdict survives replica restarts and
        swaps exactly like the front-door counters do.
    """

    def __init__(
        self,
        plans: Union[ExportedPlan, Sequence[ExportedPlan],
                     Callable[[int], ExportedPlan]],
        num_replicas: int = 2,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_queue_depth: int = 1024,
        span_log_len: int = 4096,
        breaker_threshold: int = 5,
        breaker_reset_s: float = 1.0,
        restart_budget: int = 3,
        watchdog_interval_s: float = 0.05,
        drain_timeout_s: float = 30.0,
        brownout_wait_factor: float = 4.0,
        brownout_shed_factor: float = 0.25,
        slo=None,
    ):
        factory, n = self._plan_factory(plans, num_replicas)
        if n < 1:
            raise ValueError(f"num_replicas must be >= 1, got {n}")
        if restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if brownout_wait_factor < 1.0:
            raise ValueError("brownout_wait_factor must be >= 1 (widening)")
        if not 0.0 < brownout_shed_factor <= 1.0:
            raise ValueError("brownout_shed_factor must be in (0, 1]")
        self.num_replicas = n
        self.restart_budget = int(restart_budget)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.brownout_wait_factor = float(brownout_wait_factor)
        self.brownout_shed_factor = float(brownout_shed_factor)
        self._server_kwargs = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue_depth=max_queue_depth, span_log_len=span_log_len,
            breaker_threshold=breaker_threshold,
            breaker_reset_s=breaker_reset_s,
        )
        # Active brownout steps, in entry order (exit pops the tail —
        # LIFO). Mutated only under _lock.
        self._brownout: List[str] = []

        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()  # serializes swap_plan calls
        self._closed = False
        self._next_index = n  # elasticity: added replicas get fresh indices
        self._replicas: List[_Replica] = []
        self._item_shape: Optional[tuple] = None
        self._dtype = None
        try:
            for i in range(n):
                plan = factory(i)
                self._check_signature(plan)
                self._replicas.append(
                    _Replica(i, plan, self._build_server(i, plan))
                )
        except BaseException:
            # Replica servers start their worker threads at build; a
            # half-constructed plane must not leak the ones already
            # running when a later plan fails validation.
            for rep in self._replicas:
                rep.server.close(timeout=1.0)
            raise

        # Front-door accounting (all under _lock). Counters folded in
        # from retired server generations live in _retired so restarts
        # and swaps never lose history. End-to-end latency lives in the
        # plane's own registry as a MERGEABLE bucketed histogram: whole-run percentiles at O(1) memory, and the live
        # exporter renders the registry directly.
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.degraded_rejected = 0
        self.restarts_total = 0
        self.swaps_completed = 0
        self.replicas_added = 0
        self.replicas_removed = 0
        self.brownout_rejected = 0
        # First-completion clock per plan fingerprint (monotonic stamp
        # of the first successfully served response under each plan
        # version) — the serving-side half of the lifecycle plane's
        # model-staleness measurement (shard arrival -> first response
        # under the covering fingerprint). Stamped in the done-callback,
        # so it is exact, not a poll-granularity estimate.
        self._first_completed: Dict[str, float] = {}
        self.metrics = obs.MetricsRegistry()
        self._latencies = self.metrics.bucketed_histogram(
            METRIC_SERVING_LATENCY_S
        )
        self._slo = slo
        self._retired: Dict[str, int] = {
            "completed": 0, "rejected": 0, "failed": 0, "breaker_opens": 0,
        }

        self._stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop,
            name="keystone-serving-replica-watchdog", daemon=True,
        )
        self._watchdog.start()

    # -- construction helpers ---------------------------------------------

    @staticmethod
    def _plan_factory(plans, num_replicas):
        if isinstance(plans, ExportedPlan):
            return (lambda i: plans), int(num_replicas)
        if callable(plans):
            return plans, int(num_replicas)
        seq = list(plans)
        if not seq:
            raise ValueError("plans sequence is empty")
        return (lambda i: seq[i]), len(seq)

    def _check_signature(self, plan: ExportedPlan) -> None:
        """Every replica must serve the same request signature — routing
        is load-based, so any request must be servable by any replica."""
        if self._item_shape is None:
            self._item_shape = plan.item_shape
            self._dtype = plan.dtype
            return
        if plan.item_shape != self._item_shape or plan.dtype != self._dtype:
            raise ValueError(
                f"replica plan signature {plan.item_shape}/{plan.dtype} != "
                f"plane signature {self._item_shape}/{self._dtype} — every "
                "replica must serve the same request shape and dtype"
            )

    def _effective_server_kwargs(self) -> Dict[str, Any]:
        """The base server kwargs with the ACTIVE brownout overrides
        applied — so a worker generation spawned mid-brownout (watchdog
        restart, swap, scale-up) admits under the same degraded policy
        as the live generations (mutating only live servers would let a
        restart silently undo a brownout step)."""
        kw = dict(self._server_kwargs)
        with self._lock:
            steps = list(self._brownout)
        if "widen_deadlines" in steps:
            kw["max_wait_ms"] = float(kw["max_wait_ms"]) \
                * self.brownout_wait_factor
        if "aggressive_shed" in steps:
            kw["max_queue_depth"] = max(
                1, int(kw["max_queue_depth"] * self.brownout_shed_factor)
            )
        return kw

    def _build_server(self, index: int, plan: ExportedPlan):
        return _ReplicaBatchServer(
            plan, replica_index=index, **self._effective_server_kwargs()
        )

    # -- submit side -------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Route one request to the best replica; returns its Future,
        annotated with ``replica_index`` and ``plan_fingerprint`` (the
        version of the plan that will serve it — fixed at admission,
        because a replica's worker serves exactly one plan version for
        its whole lifetime).

        Raises :class:`ServerClosed` after close(); fails over across
        replicas on shed/degraded rejections and raises only when EVERY
        in-rotation replica rejected (:class:`ServerOverloaded` if any
        rejection was load shedding, else :class:`ServerDegraded`)."""
        t_sub = time.perf_counter()
        x = np.asarray(x)
        tried: set = set()
        saw_overload = False
        last_exc: Optional[BaseException] = None
        with self._lock:
            if self._closed:
                raise ServerClosed("submit() after close()")
            # Brownout ladder top: the front door fast-fails every new
            # admission with the NAMED overload error (counted, SLO-fed
            # below — a browned-out reject is never a silent drop).
            browned_out = "reject_admissions" in self._brownout
            if browned_out:
                self.rejected += 1
                self.brownout_rejected += 1
        if browned_out:
            if self._slo is not None:
                self._slo.observe(ok=False)
            raise ServerOverloaded(
                "brownout ladder at reject_admissions: scale-up is "
                "exhausted and admission is fast-failing new requests "
                "until load subsides (docs/serving.md brownout contract)"
            )
        while True:
            with self._lock:
                if self._closed:
                    raise ServerClosed("submit() after close()")
                rep = self._pick_locked(tried)
                if rep is None:
                    break
                # Reserve BEFORE the replica sees the request: hot-swap
                # drains on this counter, and a request queued before
                # its reservation is visible could be closed mid-swap.
                rep.outstanding += 1
            try:
                fut = rep.server.submit(x, deadline_ms)
            except (ServerOverloaded, ServerDegraded, ServerClosed) as e:
                with self._lock:
                    rep.outstanding -= 1
                saw_overload = saw_overload or isinstance(e, ServerOverloaded)
                last_exc = e
                tried.add(rep.index)
                continue
            except BaseException:
                # Anything else (e.g. a malformed deadline) is the
                # caller's error, not a failover signal — but the
                # reservation MUST still be released, or this replica
                # reads permanently loaded and every later swap drain
                # of it times out.
                with self._lock:
                    rep.outstanding -= 1
                raise
            fut.replica_index = rep.index
            fut.plan_fingerprint = rep.server.plan.fingerprint
            fut.add_done_callback(self._done_callback(rep, t_sub))
            return fut
        with self._lock:
            if saw_overload:
                self.rejected += 1
            else:
                self.degraded_rejected += 1
        if self._slo is not None:
            # A request EVERY replica rejected is a front-door bad event
            # — the degraded window spends error budget even though no
            # replica ever queued it.
            self._slo.observe(ok=False)
        if saw_overload:
            raise ServerOverloaded(
                f"every in-rotation replica shed this request "
                f"(last: {last_exc})"
            )
        raise ServerDegraded(
            f"no replica available: all {self.num_replicas} replicas are "
            f"open-breaker, restarting, evicted, or dead (last: {last_exc})"
        )

    def _pick_locked(self, tried: set) -> Optional[_Replica]:
        """Routing policy (under _lock): a probe-ready half-open replica
        first (it needs the next request as its recovery probe), else
        the least-loaded replica whose breaker admits traffic. A
        half-open replica whose probe is already IN FLIGHT is skipped
        outright — its server fails every further submit fast, so
        offering it traffic would only buy a reject/failover round-trip
        per request for the whole probe-execution window."""
        candidates = [
            r for r in self._replicas
            if not r.evicted and not r.out_of_rotation
            and r.index not in tried
        ]
        probe_ready = None
        routable = []
        for r in candidates:
            state, probe_free = r.server.routing_state
            if state == "half_open":
                if probe_free:
                    probe_ready = probe_ready or r
            elif state in _ROUTABLE:
                routable.append(r)
        if probe_ready is not None:
            return probe_ready
        if not routable:
            return None
        return min(routable, key=lambda r: (r.outstanding, r.index))

    def _done_callback(self, rep: _Replica, t_sub: float):
        def _cb(fut: Future) -> None:
            t_done = time.perf_counter()
            try:
                exc = fut.exception()
            except BaseException:  # noqa: BLE001 — client cancelled
                with self._lock:
                    rep.outstanding -= 1
                return
            lat = t_done - t_sub
            fp = getattr(fut, "plan_fingerprint", None)
            with self._lock:
                rep.outstanding -= 1
                if exc is None:
                    self.completed += 1
                    self._latencies.observe(lat)
                    if fp is not None and fp not in self._first_completed:
                        self._first_completed[fp] = time.monotonic()
                        # Bounded: one entry per plan version EVER
                        # served would grow forever under a continuous
                        # trainer; the staleness consumer settles each
                        # fingerprint within one publication cycle, so
                        # retiring the oldest entries is safe.
                        while len(self._first_completed) > 256:
                            self._first_completed.pop(
                                next(iter(self._first_completed))
                            )
                elif isinstance(exc, ServerOverloaded):
                    self.rejected += 1
                else:
                    self.failed += 1
            # SLO feed OUTSIDE the plane lock (a transition may dump the
            # flight record — rendering under the routing lock would
            # stall every submit behind a postmortem).
            if self._slo is not None:
                if exc is None:
                    self._slo.observe(latency_s=lat, ok=True)
                else:
                    self._slo.observe(ok=False)
        return _cb

    # -- watchdog / restart ------------------------------------------------

    # lint: device-owner-thread: a restart builds a replica's server on its plan
    def _watchdog_loop(self) -> None:
        while not self._stop.wait(self.watchdog_interval_s):
            self._sweep_dead_replicas()

    def _sweep_dead_replicas(self) -> None:
        # Snapshot: remove_replica() mutates membership concurrently,
        # and iterating the live list could skip a neighbour mid-sweep.
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            with self._lock:
                if rep not in self._replicas:  # removed while sweeping
                    continue
                if self._closed:
                    return
                if rep.evicted or rep.out_of_rotation or rep.busy:
                    continue
                if not self._server_dead_locked(rep.server):
                    continue
                rep.busy = True
                rep.out_of_rotation = True
            try:
                self._restart(rep)
            finally:
                with self._lock:
                    rep.busy = False

    @staticmethod
    def _server_dead_locked(server: MicroBatchServer) -> bool:
        return server._worker_dead or not server.is_alive

    def _restart(self, rep: _Replica) -> None:
        """Replace a dead replica's server generation from its exported
        plan, within the restart budget; past it, evict permanently —
        and loudly."""
        self._retire_server(rep.server)
        rep.server.close(timeout=1.0)  # dead worker: join is immediate
        if self._try_spawn(rep, rep.plan):
            with self._lock:
                rep.out_of_rotation = False
            logger.warning(
                "serving replica %d worker died; restarted (%d/%d of the "
                "restart budget used)", rep.index, rep.restarts,
                self.restart_budget,
            )

    def _spawn_backoff_interrupted(self, attempt: int) -> bool:
        """Paced spawn-retry backoff shared by the watchdog-restart,
        swap, and scale-up paths: a transient blip (fd exhaustion, a
        briefly busy device) must not burn a whole spawn budget in
        microseconds. Bounded exponential; returns True when close()
        cut the wait short (the caller must abandon the spawn)."""
        return self._stop.wait(min(0.05 * (2 ** (attempt - 1)), 1.0))

    def _try_spawn(self, rep: _Replica, plan: ExportedPlan,
                   count_restart: bool = True) -> bool:
        """Spawn attempts through the ``serving.replica.spawn`` fault
        site. Death restarts (``count_restart=True``) burn the
        per-replica lifetime ``restart_budget``; planned swap spawns
        track their own bounded attempts instead — a healthy plan
        refresh must not eat the budget reserved for real deaths.
        Returns True on success; False means the replica was
        permanently evicted."""
        swap_attempts = 0
        while True:
            with self._lock:
                if self._closed:
                    return False
                if count_restart:
                    if rep.restarts >= self.restart_budget:
                        rep.evicted = True
                        rep.out_of_rotation = True
                        break
                    rep.restarts += 1
                    self.restarts_total += 1
                else:
                    # A swap gets at least one attempt even at budget 0.
                    if swap_attempts >= max(1, self.restart_budget):
                        rep.evicted = True
                        rep.out_of_rotation = True
                        break
                    swap_attempts += 1
            try:
                faults.maybe_fail(faults.SITE_REPLICA_SPAWN)
                server = self._build_server(rep.index, plan)
            except BaseException as e:  # noqa: BLE001 — budget-bounded
                attempt = rep.restarts if count_restart else swap_attempts
                logger.warning(
                    "serving replica %d spawn attempt %d failed: %r",
                    rep.index, attempt, e,
                )
                if self._spawn_backoff_interrupted(attempt):
                    return False
                continue
            with self._lock:
                closed = self._closed
                if not closed:
                    rep.server = server
                    rep.plan = plan
            if closed:
                # close() ran while we were building: installing now
                # would leak a worker thread close() already iterated
                # past. Tear the fresh generation down instead.
                server.close(timeout=1.0)
                return False
            return True
        logger.warning(
            "serving replica %d PERMANENTLY EVICTED: restart budget "
            "(%d) exhausted — the plane is degraded to %d replicas",
            rep.index, self.restart_budget,
            sum(1 for r in self._replicas if not r.evicted),
        )
        # Watchdog eviction is a postmortem moment: dump the flight
        # record (recent spans, breaker events, in-flight work) beside
        # the eviction so the degradation has a causal trail.
        obs.flight.dump_flight_record(
            f"serving replica {rep.index} permanently evicted "
            f"(restart budget {self.restart_budget} exhausted)",
            log=logger,
        )
        return False

    # -- hot swap ----------------------------------------------------------

    def swap_plan(
        self,
        new: Union[ExportedPlan, Sequence[ExportedPlan],
                   Callable[[int], ExportedPlan], Any],
        drain_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Atomically hot-swap every replica onto a new plan version
        under live traffic, with ZERO dropped requests.

        ``new`` is an :class:`ExportedPlan` (shared), a sequence /
        ``factory(index)`` of per-replica plans, or a
        ``FittedPipeline`` — the latter is exported here with the SAME
        request signature, max_batch, and padding buckets as the
        current plan, so the drain protocol below holds by construction.

        Protocol, per replica in turn (rolling — capacity never drops
        by more than one replica):

          1. The new plan is warm at the same padding buckets (export
             built every bucket) BEFORE any capacity leaves rotation.
          2. The replica leaves rotation: no new admissions.
          3. Drain: every request already admitted to it completes (the
             old plan finishes its in-flight batches; queued requests
             are served, never failed).
          4. The old server closes on an empty queue; a NEW worker
             generation spawns around the new plan and re-enters
             rotation.

        Each worker generation serves exactly one plan version, so no
        batch ever mixes versions and every response's
        ``plan_fingerprint`` names the version that produced it —
        bit-identical to that version's offline apply
        (docs/reliability.md). Returns a per-replica swap report.
        """
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        with self._swap_lock:
            factory = self._resolve_swap_plans(new)
            report: List[Dict[str, Any]] = []
            with self._lock:
                reps = list(self._replicas)  # membership may shrink mid-swap
            for rep in reps:
                with self._lock:
                    removed = rep not in self._replicas
                if removed:
                    report.append({
                        "replica": rep.index, "swapped": False,
                        "reason": "removed",
                    })
                    continue
                if rep.evicted:
                    report.append({
                        "replica": rep.index, "swapped": False,
                        "reason": "evicted",
                    })
                    continue
                report.append(self._swap_one(rep, factory(rep.index),
                                             timeout))
            with self._lock:
                self.swaps_completed += 1
            return {"replicas": report}

    def _swap_one(self, rep: _Replica, new_plan: ExportedPlan,
                  timeout: float) -> Dict[str, Any]:
        """The per-replica swap protocol (swap_plan docstring steps 1-4):
        check the signature, take lifecycle ownership, drain to zero, close the old
        generation, spawn the new one. Caller holds the SWAP lock.
        Returns the replica's swap-report dict."""
        self._check_signature(new_plan)  # export already warmed it
        # Take lifecycle ownership: wait out a watchdog restart
        # already replacing this replica's server generation.
        own_deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if self._closed:
                    raise ServerClosed("swap_plan() after close()")
                if rep.evicted:
                    break
                if not rep.busy:
                    rep.busy = True
                    rep.out_of_rotation = True
                    break
            if time.perf_counter() >= own_deadline:
                raise TimeoutError(
                    f"replica {rep.index} is mid-restart and did "
                    f"not settle within {timeout:.3g}s"
                )
            time.sleep(0.005)
        if rep.evicted:  # evicted while we waited
            return {
                "replica": rep.index, "swapped": False,
                "reason": "evicted",
            }
        try:
            try:
                t0 = time.perf_counter()
                self._drain(rep, timeout)
                drain_s = time.perf_counter() - t0
            except BaseException:
                with self._lock:  # zero-drop: old plan keeps serving
                    rep.out_of_rotation = False
                raise
            old_fp = rep.server.plan.fingerprint
            self._retire_server(rep.server)
            rep.server.close()
            if not self._try_spawn(rep, new_plan, count_restart=False):
                return {
                    "replica": rep.index, "swapped": False,
                    "reason": "spawn failed; replica evicted",
                    "old_fingerprint": old_fp,
                }
            with self._lock:
                rep.out_of_rotation = False
            return {
                "replica": rep.index, "swapped": True,
                "old_fingerprint": old_fp,
                "new_fingerprint": new_plan.fingerprint,
                "drain_s": round(drain_s, 6),
            }
        finally:
            with self._lock:
                rep.busy = False

    def swap_replica_plan(
        self,
        index: int,
        new: Union[ExportedPlan, Any],
        drain_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Hot-swap ONE replica onto a new plan version — the canary
        primitive the lifecycle controller drives: a passing candidate
        is swapped into a single replica first, compared against the
        incumbent replicas over a sustain window, then promoted
        (:meth:`swap_plan`) or swapped back. Same zero-drop drain
        protocol as the full rollout, per replica; the plane serves
        MIXED fingerprints while a canary is live (each worker
        generation still serves exactly one version — no mixed batch
        ever exists, and every response still names its version).

        ``new`` is an :class:`ExportedPlan` or a ``FittedPipeline``
        (exported at the plane's signature/buckets). Raises
        :class:`ValueError` for an unknown/evicted index; serialized
        against :meth:`swap_plan` and elasticity on the swap lock."""
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        if isinstance(new, (list, tuple)):
            raise TypeError(
                "swap_replica_plan swaps ONE replica — pass a single "
                "ExportedPlan or FittedPipeline, not a sequence"
            )
        with self._swap_lock:
            plan = self._resolve_swap_plans(new)(index)
            with self._lock:
                rep = next(
                    (r for r in self._replicas
                     if r.index == index and not r.evicted), None,
                )
            if rep is None:
                raise ValueError(
                    f"swap_replica_plan: no live replica with index "
                    f"{index}"
                )
            return self._swap_one(rep, plan, timeout)

    def _resolve_swap_plans(self, new) -> Callable[[int], ExportedPlan]:
        # A freshly fitted pipeline: export with the current signature so
        # the new plan warms at the same buckets the plane already runs.
        # (Checked FIRST — FittedPipeline is itself callable, and the
        # factory branch would otherwise apply it to the replica index.)
        from keystone_tpu_torch.workflow.pipeline import FittedPipeline

        if isinstance(new, FittedPipeline):
            from .export import export_plan

            cur = self._replicas[0].plan
            example = np.zeros(self._item_shape, np.dtype(self._dtype))
            plan = export_plan(
                new, example, max_batch=cur.max_batch, buckets=cur.buckets,
            )
            return lambda i: plan
        if isinstance(new, ExportedPlan):
            return lambda i: new
        if isinstance(new, (list, tuple)):
            seq = list(new)
            # Replica indices are not dense once elasticity has
            # added/removed workers (fresh indices beyond the
            # construction range), so a per-replica sequence maps by
            # ROTATION POSITION over the live membership — a raw
            # ``seq[index]`` would drop one device-pinned plan and
            # double-assign another without any error. Membership
            # cannot change under us: swap_plan holds the swap lock and
            # add_replica serializes on it.
            with self._lock:
                live = sorted(
                    (r.index for r in self._replicas if not r.evicted)
                )
            if len(seq) != len(live):
                raise ValueError(
                    f"swap_plan got {len(seq)} plans for "
                    f"{len(live)} replicas (live membership)"
                )
            mapping = dict(zip(live, seq))
            return lambda i: mapping[i]
        if callable(new):
            return new
        raise TypeError(
            f"swap_plan takes an ExportedPlan, a sequence/factory of "
            f"them, or a FittedPipeline (got {type(new).__name__})"
        )

    def _drain(self, rep: _Replica, timeout: float) -> None:
        """Wait until every request admitted to ``rep`` has resolved
        (the batcher guarantees every future resolves — results, plan
        errors, watchdog failures — so drain always terminates unless
        the replica is genuinely wedged past ``timeout``)."""
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if rep.outstanding == 0:
                    return
            if time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"replica {rep.index} failed to drain within "
                    f"{timeout:.3g}s ({rep.outstanding} outstanding); "
                    "it re-enters rotation on its OLD plan"
                )
            time.sleep(0.001)

    # -- elasticity (the autoscaler's capacity primitives) -----------------

    def add_replica(self) -> int:
        """Grow rotation by one replica, ZERO-DROP: the new worker's
        plan is warm at the plane's padding buckets BEFORE the replica
        enters rotation (no cold-compile request ever lands on it), and
        membership updates atomically under the plane lock. The plan is
        cloned from the first live replica, so a scale-up after a
        hot-swap serves the swapped version.

        Spawn attempts run the ``serving.autoscale.spawn`` fault site
        with bounded, paced retries inside the restart budget — a chaos
        kill mid-spawn is ABSORBED (the next attempt succeeds) rather
        than dropped or leaked. Raises :class:`ServerDegraded` when the
        budget is exhausted (the plane keeps serving at its current
        size). Returns the new replica's index.

        Serialized against :meth:`swap_plan` (the swap lock): a replica
        added mid-rollout would be invisible to the swap's membership
        snapshot and leave the plane permanently serving mixed plan
        versions."""
        with self._swap_lock:
            return self._add_replica_locked_swap()

    def _add_replica_locked_swap(self) -> int:
        with self._lock:
            if self._closed:
                raise ServerClosed("add_replica() after close()")
            # Donor preference: an IN-ROTATION replica (under the swap
            # lock the only out-of-rotation/busy members are mid-restart
            # — their plan is current too, but rotation members are the
            # unambiguous source of the live version).
            live = [r for r in self._replicas if not r.evicted]
            donor = next(
                (r for r in live if not r.out_of_rotation and not r.busy),
                live[0] if live else None,
            )
            if donor is None:
                raise ServerDegraded(
                    "add_replica: every replica is evicted — no live "
                    "plan to clone"
                )
            plan = donor.plan
            index = self._next_index
            self._next_index += 1
        attempts = 0
        budget = max(1, self.restart_budget)
        while True:
            attempts += 1
            try:
                faults.maybe_fail(faults.SITE_AUTOSCALE_SPAWN)
                server = self._build_server(index, plan)
                break
            except BaseException as e:  # noqa: BLE001 — budget-bounded
                logger.warning(
                    "autoscale: replica %d spawn attempt %d failed: %r",
                    index, attempts, e,
                )
                if attempts >= budget:
                    raise ServerDegraded(
                        f"add_replica: spawn failed {attempts} time(s) "
                        f"(restart budget {budget}): {e!r}"
                    ) from e
                if self._spawn_backoff_interrupted(attempts):
                    raise ServerClosed("add_replica() during close()")
        rep = _Replica(index, plan, server)
        with self._lock:
            closed = self._closed
            if not closed:
                self._replicas.append(rep)
                self.num_replicas += 1
                self.replicas_added += 1
        if closed:
            server.close(timeout=1.0)
            raise ServerClosed("add_replica() during close()")
        return index

    def remove_replica(
        self, drain_timeout_s: Optional[float] = None
    ) -> int:
        """Shrink rotation by one replica, ZERO-DROP, via the hot-swap
        drain protocol: the victim leaves rotation (no new admissions),
        every request already admitted to it completes (reservation
        ordering — a drain can never close over an invisible in-flight),
        the server closes on an empty queue, and membership updates
        atomically.

        Victim selection: the least-loaded in-rotation replica, and
        NEVER the half-open-probe replica — its breaker is mid-recovery
        and evicting it would leave the probe outcome unobservable
        (highest index wins ties, so elastic scale-down preferentially
        retires the most recently added capacity). Raises
        :class:`ValueError` at one live replica (the plane never scales
        to zero) and :class:`TimeoutError` if the victim fails to drain
        — in which case it re-enters rotation and nothing was dropped.
        Returns the removed replica's index.

        Serialized against :meth:`swap_plan` (the swap lock), like
        :meth:`add_replica`: a removal mid-rollout could hand the
        swap's ownership wait an already-retired replica — its counters
        would fold into the plane history twice and the swap would
        respawn a worker no membership list tracks."""
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        with self._swap_lock:
            return self._remove_replica_locked_swap(timeout)

    def _remove_replica_locked_swap(self, timeout: float) -> int:
        with self._lock:
            if self._closed:
                raise ServerClosed("remove_replica() after close()")
            live = [r for r in self._replicas if not r.evicted]
            if len(live) <= 1:
                raise ValueError(
                    "remove_replica: refusing to remove the last live "
                    "replica"
                )
            candidates = []
            for r in live:
                if r.out_of_rotation or r.busy:
                    continue
                state, _ = r.server.routing_state
                if state == "half_open":
                    continue  # never the probe replica
                candidates.append(r)
            if not candidates:
                raise ServerDegraded(
                    "remove_replica: no removable replica (all are "
                    "mid-restart, mid-swap, or half-open probes)"
                )
            victim = min(
                candidates, key=lambda r: (r.outstanding, -r.index)
            )
            victim.busy = True
            victim.out_of_rotation = True
        try:
            self._drain(victim, timeout)
        except BaseException:
            with self._lock:  # zero-drop: victim resumes serving
                victim.out_of_rotation = False
                victim.busy = False
            raise
        self._retire_server(victim.server)
        victim.server.close()
        with self._lock:
            if victim in self._replicas:
                self._replicas.remove(victim)
                self.num_replicas -= 1
            self.replicas_removed += 1
            victim.busy = False
        return victim.index

    # -- brownout ladder ---------------------------------------------------

    @property
    def brownout_level(self) -> int:
        with self._lock:
            return len(self._brownout)

    @property
    def brownout_steps(self) -> "tuple[str, ...]":
        """Active brownout steps in entry order (exit pops the tail)."""
        with self._lock:
            return tuple(self._brownout)

    def enter_brownout_step(self) -> Optional[str]:
        """Climb one rung of :data:`BROWNOUT_STEPS`; returns the step
        entered, or None at the ladder top. Effects apply to every live
        worker generation immediately and to every generation spawned
        while the step is active (``_effective_server_kwargs``)."""
        with self._lock:
            if self._closed:
                raise ServerClosed("enter_brownout_step() after close()")
            if len(self._brownout) >= len(BROWNOUT_STEPS):
                return None
            step = BROWNOUT_STEPS[len(self._brownout)]
            self._brownout.append(step)
        self._apply_admission_params()
        return step

    def exit_brownout_step(self) -> Optional[str]:
        """Descend one rung — strictly LIFO: the most recently entered
        step is reverted first (``reject_admissions`` lifts before the
        shed depth restores, before the deadlines narrow). Returns the
        step exited, or None when no step is active."""
        with self._lock:
            if not self._brownout:
                return None
            step = self._brownout.pop()
        self._apply_admission_params()
        return step

    def _apply_admission_params(self) -> None:
        """Push the current effective admission knobs onto every live
        server generation (outside the plane lock — set_admission_params
        takes each server's own condition lock)."""
        kw = self._effective_server_kwargs()
        with self._lock:
            servers = [
                r.server for r in self._replicas if not r.evicted
            ]
        for s in servers:
            s.set_admission_params(
                max_wait_ms=kw["max_wait_ms"],
                max_queue_depth=kw["max_queue_depth"],
            )

    def autoscale_signals(self) -> Dict[str, Any]:
        """The numpy-free signal block the autoscaler's tick consumes:
        live replica count, rotation occupancy (outstanding reservations
        — the same counters hot-swap drains on), total queued-not-
        dispatched depth across replicas, and the brownout state."""
        with self._lock:
            reps = [r for r in self._replicas if not r.evicted]
            n = len(reps)
            in_rotation = sum(1 for r in reps if not r.out_of_rotation)
            outstanding = sum(r.outstanding for r in reps)
            brownout = list(self._brownout)
        queue_depth = sum(r.server.queue_depth for r in reps)
        return {
            "replicas": n,
            "in_rotation": in_rotation,
            "outstanding": outstanding,
            "queue_depth": queue_depth,
            "brownout_level": len(brownout),
            "brownout_steps": brownout,
        }

    # -- observability -----------------------------------------------------

    def exec_marks(self) -> Dict[int, Any]:
        """Each replica's current server generation and its span count:
        the start of a window :meth:`exec_p99_since` reads."""
        with self._lock:
            return {r.index: (r.server, r.server.span_log.recorded)
                    for r in self._replicas}

    def exec_p99_since(self, marks: Dict[int, Any]) -> Dict[int, float]:
        """Each replica's exec-latency p99 over the requests its server
        generation served since ``marks`` (a replica swapped or restarted
        since has no entry, nor one that served nothing)."""
        with self._lock:
            reps = list(self._replicas)
        out: Dict[int, float] = {}
        for r in reps:
            server, mark = marks.get(r.index, (None, 0))
            if server is not r.server:
                continue
            pct = profiling.latency_percentiles(
                [s.exec_s for s in server.span_log.since(mark)])
            if pct:
                out[r.index] = pct["p99"]
        return out

    def exec_batches_since(self, marks: Dict[int, Any]) -> Dict[int, List[float]]:
        """Each replica's batch execution walls, one a batch, since
        ``marks``: what its server generation served after the mark, or,
        for a replica whose server was swapped since, everything its new
        generation served. A batch records one span a request, all with
        its wall, so each run of ``batch_size`` spans counts once."""
        with self._lock:
            reps = list(self._replicas)
        out: Dict[int, List[float]] = {}
        for r in reps:
            server, mark = marks.get(r.index, (None, 0))
            spans = r.server.span_log.since(mark if server is r.server else 0)
            walls, i = [], 0
            while i < len(spans):
                walls.append(spans[i].exec_s)
                i += max(int(spans[i].batch_size), 1)
            if walls:
                out[r.index] = walls
        return out

    def live_replica_indices(self) -> List[int]:
        """Sorted indices of live, in-rotation replicas — the canary
        picker's view (the lifecycle controller swaps the lowest live
        index first so canary attribution is deterministic)."""
        with self._lock:
            return sorted(
                r.index for r in self._replicas
                if not r.evicted and not r.out_of_rotation
            )

    def first_completion_times(self) -> Dict[str, float]:
        """``{plan_fingerprint: monotonic stamp}`` of the FIRST response
        successfully served under each plan version this plane has ever
        run — the serving half of the lifecycle plane's model-staleness
        clock. Survives restarts and swaps (stamped at the front-door
        future, like the plane counters)."""
        with self._lock:
            return dict(self._first_completed)

    def _retire_server(self, server: MicroBatchServer) -> None:
        """Fold a closing server generation's counters into the plane's
        history so restarts and swaps never lose completions."""
        s = server.stats()
        with self._lock:
            for k in ("completed", "rejected", "failed", "breaker_opens"):
                self._retired[k] += int(s.get(k) or 0)

    def stats(self) -> Dict[str, Any]:
        """Aggregate plane stats + per-replica attribution.

        Front-door counters (completed / rejected / failed, end-to-end
        p50/p99 over the rolling window) are accounted at the future,
        so they survive replica restarts and swaps; ``replica_*``
        blocks carry each LIVE worker generation's own stats() plus
        lifecycle state, and ``span_summary_by_replica`` attributes
        batch spans to the replica that executed them. ``degraded`` is
        the loud flag: any replica evicted or currently dead."""
        lat = self._latencies.stats_snapshot()
        with self._lock:
            reps = list(self._replicas)
            out: Dict[str, Any] = {
                "num_replicas": self.num_replicas,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "degraded_rejected": self.degraded_rejected,
                "restarts_total": self.restarts_total,
                "swaps_completed": self.swaps_completed,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "brownout_level": len(self._brownout),
                "brownout_steps": list(self._brownout),
                "brownout_rejected": self.brownout_rejected,
                "retired_generations": dict(self._retired),
                "num_latency_samples": lat["count"],
            }
            outstanding = {r.index: r.outstanding for r in reps}
        out["p50_latency_s"] = lat["p50"]
        out["p99_latency_s"] = lat["p99"]

        per_replica: Dict[int, Dict[str, Any]] = {}
        span_by_rep: Dict[int, Dict[str, Any]] = {}
        evicted: List[int] = []
        healthy = 0
        for r in reps:
            s = r.server.stats()
            s.update({
                "outstanding": outstanding[r.index],
                "restarts": r.restarts,
                "evicted": r.evicted,
                "in_rotation": not (r.evicted or r.out_of_rotation),
                "plan_fingerprint": r.server.plan.fingerprint,
            })
            per_replica[r.index] = s
            # Each server's span ring holds only its own spans, so the
            # summary stats() already computed IS this replica's group —
            # re-snapshotting the ring here would take the span lock a
            # second time per replica on the serving hot path.
            if s.get("span_summary"):
                span_by_rep[r.index] = s["span_summary"]
            if r.evicted:
                evicted.append(r.index)
            elif s["breaker_state"] not in ("dead",):
                healthy += 1
        out["per_replica"] = per_replica
        out["span_summary_by_replica"] = span_by_rep
        out["evicted_replicas"] = evicted
        out["healthy_replicas"] = healthy
        out["degraded"] = bool(evicted) or healthy < self.num_replicas
        return out

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the plane: the watchdog joins, then every replica server
        closes (in-flight batches complete, queued requests fail with
        :class:`ServerClosed`). Idempotent."""
        with self._lock:
            already = self._closed
            self._closed = True
        self._stop.set()
        if not already:
            self._watchdog.join(timeout=timeout)
        for rep in list(self._replicas):
            rep.server.close(timeout=timeout)

    def __enter__(self) -> "ReplicatedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
