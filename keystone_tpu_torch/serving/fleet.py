"""Multi-process serving fleet: crash-contained planes behind one
admission router (port of ``keystone_tpu/serving/fleet.py``).

Every serving-side robustness mechanism so far — replica failover, the
autoscaler, tenant isolation, the canary lifecycle — lives as threads
inside ONE process; a single interpreter crash takes the whole fabric
down. This module breaks that ceiling: a :class:`FleetRouter` fronts N
per-process serving planes (each today's full ``ReplicatedServer``
stack, spawned via ``multiprocessing`` — ``serving/fleet_plane.py``)
over the stdlib-socket RPC of ``serving/fleet_rpc.py``.

The router process owns NO device work: this module names no ``torch``
at any scope (``tests/test_torch_fleet_unit.py`` checks its syntax tree;
the port's package root imports torch, so, as with the reference's
``jax-clean-module``, "clean" is a property of the module's own imports).
On one card the planes share it by time-slicing: the fleet buys crash
containment, not capacity.

Contracts:

  - **Admission + routing**: least-loaded across healthy planes with
    per-tenant deficit fairness — a tenant's requests spread across
    its planes by dispatch deficit, so one hot tenant cannot pile a
    single plane while others idle. Routing reads each plane's LIVE
    exporter snapshot (``/snapshot.json``) plus the router's own
    outstanding counters.
  - **Fleet-wide accounting**: ``offered == completed + rejected +
    failed`` at the router front door, across process kills — the
    zero-drop contract extended from thread scope to process scope.
    Every future resolves with a result or a NAMED error; nothing is
    ever silently dropped.
  - **Process watchdog**: a plane that stops heartbeating (snapshot
    scrape + liveness) is declared DEAD: its in-flight requests fail
    LOUDLY at the router (:class:`FleetPlaneDied`), its last-scraped
    latency histogram is folded into the fleet merge (the degraded
    window stays visible), and a replacement process is respawned
    through the ``fleet.plane.spawn`` fault site with paced bounded
    retries inside a per-plane restart budget. Budget exhaustion
    EVICTS the plane loudly; the surviving fleet keeps serving.
  - **Integrity**: plans ship in the zoo's bit-exact split-plane
    encoding and are fingerprint-verified end-to-end on arrival; a
    mismatch QUARANTINES the plane (it heartbeats but refuses every
    request) rather than serving wrong bits.
  - **Fleet p99**: per-plane ``BucketedHistogram`` states merge
    EXACTLY at the router (the histogram's merge property, now
    cross-process over ``/snapshot.json``).

Port differences: the first spawn of every plane runs at once (one
thread each; each plane pays a torch import, a CUDA context and its
bucket captures), and each plane's boot seconds, spawn to bootstrap
reply, are kept (:meth:`FleetRouter.boot_seconds`);
:meth:`FleetRouter.plane_stats` asks every plane for its own ``stats``
reply (the server's books, its kernel launch counters and its device
memory).
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import queue
import threading
import time
import urllib.request
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from keystone_tpu_torch.obs.metrics import BucketedHistogram
from keystone_tpu_torch.serving.batcher import (
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
)
from keystone_tpu_torch.utils import faults

from .fleet_plane import PlanShip, plane_main
from .fleet_rpc import RpcClient

__all__ = [
    "FleetClosed",
    "FleetPlaneDied",
    "FleetRouter",
    "FleetSaturated",
    "PlaneQuarantined",
]

logger = logging.getLogger(__name__)


class FleetSaturated(ServerOverloaded):
    """Router admission bound hit — counted ``rejected`` (the named
    shed, same classification as a plane-level overload)."""


class FleetPlaneDied(ServerDegraded):
    """The plane handling (or chosen for) a request died or its RPC
    failed — counted ``failed``, never silently dropped."""


class PlaneQuarantined(ServerDegraded):
    """The plane refused to serve: its shipped plan failed integrity
    verification."""


class FleetClosed(ServerClosed):
    """Submission after (or unresolved at) ``close()``."""


class _Plane:
    """Router-side state for one plane slot. All mutable fields are
    guarded by the router's lock except the RPC client (thread-safe)
    and the atomic-enough heartbeat stamp."""

    def __init__(self, name: str):
        self.name = name
        self.proc: Optional[Any] = None
        self.client: Optional[RpcClient] = None
        self.rpc_port: Optional[int] = None
        self.metrics_port: Optional[int] = None
        self.pid: Optional[int] = None
        self.quarantined: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.healthy = False
        self.evicted = False
        self.outstanding = 0
        self.offered = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.restarts = 0
        self.budget_left = 0
        self.last_heartbeat = 0.0
        self.last_hist_state: Optional[Dict[str, Any]] = None
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self.boot_s: Optional[float] = None

    def eligible(self) -> bool:
        return self.healthy and not self.evicted \
            and self.quarantined is None


class FleetRouter:
    """N crash-contained serving-plane processes behind one admission
    front door (module docstring). ``ship`` is the split-plane-encoded
    plan every plane boots from (``fleet_plane.encode_plan_ship``).

    Knobs: ``restart_budget`` respawn attempts per plane slot (paced by
    ``spawn_retry_delay_s`` doubling per attempt), ``heartbeat_timeout_s``
    without a successful snapshot scrape (or a dead process) declares a
    plane dead, ``max_outstanding`` bounds router-queued + in-flight
    requests (beyond it submissions shed with :class:`FleetSaturated`).
    """

    def __init__(
        self,
        ship: PlanShip,
        num_planes: int = 2,
        replicas_per_plane: int = 2,
        max_outstanding: int = 1024,
        dispatchers: Optional[int] = None,
        heartbeat_interval_s: float = 0.2,
        heartbeat_timeout_s: float = 5.0,
        restart_budget: int = 2,
        spawn_retry_delay_s: float = 0.05,
        startup_timeout_s: float = 120.0,
        request_timeout_s: float = 30.0,
        plane_cfg: Optional[Dict[str, Any]] = None,
    ):
        if num_planes < 1:
            raise ValueError("num_planes must be >= 1")
        self.ship = ship
        self.num_planes = int(num_planes)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.restart_budget = int(restart_budget)
        self.spawn_retry_delay_s = float(spawn_retry_delay_s)
        self.startup_timeout_s = float(startup_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_outstanding = int(max_outstanding)
        self._cfg = dict(plane_cfg or {})
        self._cfg.setdefault("replicas", int(replicas_per_plane))
        self._cfg.setdefault("default_timeout_s", request_timeout_s)

        # A forked child cannot use CUDA once the parent has initialised
        # it (and the parent that fit the plan has): spawn.
        self._ctx = mp.get_context("spawn")
        self._lock = threading.Lock()
        self._closed = False
        self._planes: List[_Plane] = [
            _Plane(f"plane{i}") for i in range(self.num_planes)
        ]
        for p in self._planes:
            p.budget_left = self.restart_budget
        # Front-door books (the fleet invariant's single source of
        # truth): offered at submit, exactly one of completed /
        # rejected / failed at resolution.
        self.offered = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self._inflight = 0
        # Per-tenant deficit fairness: tenant -> plane name -> sends.
        self._sent: Dict[str, Dict[str, int]] = {}
        # Latency histograms of planes that died or were replaced —
        # their last-scraped state stays in the fleet merge so the
        # degraded window's tail is never erased.
        self._retired_hist = BucketedHistogram()

        self._spawn_initial()

        self._queue: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        n_disp = dispatchers if dispatchers is not None \
            else 4 * self.num_planes
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"fleet-dispatch-{i}", daemon=True)
            for i in range(int(n_disp))
        ]
        for t in self._dispatchers:
            t.start()
        self._watchdog_stop = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="fleet-watchdog",
            daemon=True,
        )
        self._watchdog.start()

    # -- spawn / respawn ---------------------------------------------------

    def _spawn_initial(self) -> None:
        """Boot every plane at once (one thread each); the first failure
        is raised after all have finished."""
        errors: List[BaseException] = []

        def boot(plane: _Plane) -> None:
            try:
                self._spawn_plane(plane, initial=True)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=boot, args=(p,),
                                    name=f"fleet-boot-{p.name}")
                   for p in self._planes]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for p in self._planes:
                if p.proc is not None and p.proc.is_alive():
                    p.proc.terminate()
                    p.proc.join(5.0)
            raise errors[0]

    def _spawn_once(self, plane: _Plane) -> None:
        """One spawn attempt: fire the fault site, start the process,
        wait for its bootstrap handshake."""
        faults.maybe_fail(faults.SITE_FLEET_PLANE_SPAWN)
        t0 = time.monotonic()
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=plane_main,
            args=(plane.name, child_conn, self.ship,
                  dict(self._cfg, spawn_wall=time.time())),
            name=f"keystone-fleet-{plane.name}",
            daemon=True,
        )
        proc.start()
        child_conn.close()
        if not parent_conn.poll(self.startup_timeout_s):
            proc.terminate()
            proc.join(5.0)
            raise OSError(
                f"{plane.name}: no bootstrap handshake within "
                f"{self.startup_timeout_s}s"
            )
        hello = parent_conn.recv()
        parent_conn.close()
        with self._lock:
            plane.boot_s = time.monotonic() - t0
            plane.proc = proc
            plane.pid = hello["pid"]
            plane.rpc_port = hello["rpc_port"]
            plane.metrics_port = hello["metrics_port"]
            plane.quarantined = hello["quarantined"]
            plane.fingerprint = hello["fingerprint"]
            plane.client = RpcClient("127.0.0.1", hello["rpc_port"])
            plane.healthy = True
            plane.last_heartbeat = time.monotonic()
        if plane.quarantined is not None:
            logger.warning(
                "fleet: %s came up QUARANTINED (%s) — heartbeating but "
                "refusing traffic; wrong bits are never served",
                plane.name, plane.quarantined,
            )

    def _spawn_plane(self, plane: _Plane, initial: bool = False) -> None:
        """Paced bounded respawn inside the plane's restart budget.
        At construction (``initial``) the budget is NOT burned — a
        fleet that cannot boot raises instead. On respawn, every
        attempt (success or failure) burns one budget unit; exhaustion
        evicts the plane LOUDLY and permanently."""
        attempt = 0
        while True:
            if not initial:
                with self._lock:
                    if plane.budget_left <= 0:
                        plane.evicted = True
                        plane.healthy = False
                        logger.warning(
                            "fleet: %s restart budget EXHAUSTED — "
                            "permanently evicted; surviving planes "
                            "keep serving", plane.name,
                        )
                        return
                    plane.budget_left -= 1
            try:
                self._spawn_once(plane)
            except Exception as e:  # noqa: BLE001 — budgeted chaos path
                attempt += 1
                if initial and attempt > 3:
                    raise
                logger.warning(
                    "fleet: spawn attempt %d for %s failed: %r",
                    attempt, plane.name, e,
                )
                time.sleep(
                    self.spawn_retry_delay_s * (2 ** min(attempt - 1, 6))
                )
                continue
            if not initial:
                with self._lock:
                    plane.restarts += 1
            return

    # -- submission / dispatch ---------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None,
               tenant: str = "fleet") -> Future:
        """Route one request; returns a Future resolving to the plane's
        response (or a NAMED error — never a silent drop)."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise FleetClosed("fleet is closed")
            self.offered += 1
            if self._inflight >= self.max_outstanding:
                self.rejected += 1
                raise FleetSaturated(
                    f"router outstanding bound {self.max_outstanding} "
                    f"reached"
                )
            if not any(p.eligible() for p in self._planes):
                self.failed += 1
                raise FleetPlaneDied(
                    "no eligible planes (all dead, evicted or "
                    "quarantined)"
                )
            self._inflight += 1
        self._queue.put((fut, tenant, x, deadline_ms,
                         time.monotonic()))
        return fut

    def submit_tenant(self, tenant: str, x,
                      deadline_ms: Optional[float] = None) -> Future:
        """`run_multi_tenant_open_loop`-shaped front door."""
        return self.submit(x, deadline_ms=deadline_ms, tenant=tenant)

    def _pick_plane(self, tenant: str) -> Optional[_Plane]:
        """Least-loaded with per-tenant deficit fairness: among
        eligible planes, minimize (router outstanding, this tenant's
        sends to the plane) lexicographically — the plane with headroom
        wins; ties break toward the plane this tenant has used least,
        spreading each tenant across the fleet by dispatch deficit."""
        with self._lock:
            eligible = [p for p in self._planes if p.eligible()]
            if not eligible:
                return None
            sent = self._sent.setdefault(tenant, {})
            best = min(
                eligible,
                key=lambda p: (p.outstanding, sent.get(p.name, 0)),
            )
            sent[best.name] = sent.get(best.name, 0) + 1
            best.outstanding += 1
            best.offered += 1
            return best

    def _resolve(self, fut: Future, plane: Optional[_Plane],
                 outcome: str, value: Any) -> None:
        """Exactly-once bookkeeping + future resolution."""
        with self._lock:
            self._inflight -= 1
            if outcome == "completed":
                self.completed += 1
            elif outcome == "rejected":
                self.rejected += 1
            else:
                self.failed += 1
            if plane is not None:
                plane.outstanding -= 1
                setattr(plane, outcome, getattr(plane, outcome) + 1)
        if outcome == "completed":
            fut.set_result(value)
        else:
            fut.set_exception(value)

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, tenant, x, deadline_ms, t_submit = item
            with self._lock:
                closed = self._closed
            if closed:
                # FIFO: every request queued before close() reaches a
                # dispatcher before its shutdown sentinel does, so the
                # drain is loud and complete by construction.
                self._resolve(fut, None, "failed", FleetClosed(
                    "fleet closed with request queued"
                ))
                continue
            plane = self._pick_plane(tenant)
            if plane is None:
                self._resolve(fut, None, "failed", FleetPlaneDied(
                    "no eligible planes"
                ))
                continue
            # Deadline propagation: the plane sees the REMAINING
            # budget after router queueing.
            remaining_ms = deadline_ms
            if deadline_ms is not None:
                elapsed_ms = (time.monotonic() - t_submit) * 1e3
                remaining_ms = deadline_ms - elapsed_ms
                if remaining_ms <= 0.0:
                    self._resolve(fut, plane, "rejected", FleetSaturated(
                        f"deadline ({deadline_ms:.1f} ms) burned in "
                        f"router queue"
                    ))
                    continue
            timeout_s = (remaining_ms / 1e3 + 5.0
                         if remaining_ms is not None
                         else self.request_timeout_s)
            try:
                resp = plane.client.request(
                    {"op": "submit", "x": x, "deadline_ms": remaining_ms,
                     "tenant": tenant},
                    timeout_s=timeout_s,
                )
            except Exception as e:  # noqa: BLE001 — named, loud
                logger.warning(
                    "fleet: in-flight request to %s FAILED (%r)",
                    plane.name, e,
                )
                self._resolve(fut, plane, "failed", FleetPlaneDied(
                    f"{plane.name}: rpc failed: "
                    f"{type(e).__name__}: {e}"
                ))
                continue
            if resp.get("ok"):
                self._resolve(fut, plane, "completed", resp["y"])
            else:
                err = resp.get("error")
                msg = f"{plane.name}: {resp.get('message', err)}"
                if err == "overloaded":
                    self._resolve(fut, plane, "rejected",
                                  FleetSaturated(msg))
                elif err == "quarantined":
                    self._resolve(fut, plane, "failed",
                                  PlaneQuarantined(msg))
                else:
                    self._resolve(fut, plane, "failed",
                                  FleetPlaneDied(msg))

    # -- watchdog ----------------------------------------------------------

    def _scrape(self, plane: _Plane) -> bool:
        """One snapshot scrape; True on success (heartbeat)."""
        url = (f"http://127.0.0.1:{plane.metrics_port}/snapshot.json")
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                doc = json.loads(r.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — any scrape failure = no beat
            return False
        section = doc.get("fleet_plane") or {}
        with self._lock:
            plane.last_snapshot = section
            hist = section.get("latency_hist")
            if hist is not None:
                plane.last_hist_state = hist
            # The plane's ADVERTISED fingerprint moves when its own
            # lifecycle controller promotes a canary — the router's
            # attribution must track the live value, not the boot one.
            fp = section.get("fingerprint")
            if fp:
                plane.fingerprint = fp
            plane.last_heartbeat = time.monotonic()
        return True

    def _watchdog_loop(self) -> None:
        while not self._watchdog_stop.wait(self.heartbeat_interval_s):
            for plane in self._planes:
                with self._lock:
                    if self._closed:
                        return
                    if plane.evicted or not plane.healthy:
                        continue
                    proc = plane.proc
                self._scrape(plane)
                dead = (proc is not None and not proc.is_alive())
                with self._lock:
                    beat_age = time.monotonic() - plane.last_heartbeat
                if dead or beat_age > self.heartbeat_timeout_s:
                    self._declare_dead(
                        plane,
                        "process exited" if dead else
                        f"no heartbeat for {beat_age:.1f}s",
                    )

    def _declare_dead(self, plane: _Plane, reason: str) -> None:
        logger.warning(
            "fleet: %s (pid %s) DECLARED DEAD (%s) — failing its "
            "in-flight requests loudly and respawning within budget "
            "(%d left)", plane.name, plane.pid, reason,
            plane.budget_left,
        )
        with self._lock:
            plane.healthy = False
            # Keep the dead plane's tail visible: its last-scraped
            # histogram joins the fleet merge permanently.
            if plane.last_hist_state is not None:
                self._retired_hist.merge_state(plane.last_hist_state)
                plane.last_hist_state = None
            client = plane.client
            plane.client = None
        # Closing the pool wakes any dispatcher blocked on this
        # plane's sockets; each in-flight request fails LOUDLY through
        # its own dispatcher (FleetPlaneDied), never silently.
        if client is not None:
            client.close()
        if plane.proc is not None:
            plane.proc.join(timeout=1.0)
        self._spawn_plane(plane)

    # -- fleet-wide operations ---------------------------------------------

    def offer_canary(self, candidate_ship: PlanShip,
                     timeout_s: float = 120.0) -> Dict[str, Any]:
        """Roll one candidate across the surviving fleet: each eligible
        plane's OWN LifecycleController runs the gate → single-replica
        canary → zero-drop promotion (the lifecycle, per process).
        Returns per-plane results."""
        results: Dict[str, Any] = {}
        for plane in self._planes:
            with self._lock:
                ok = plane.eligible()
                client = plane.client
            if not ok or client is None:
                results[plane.name] = {"ok": False,
                                       "error": "ineligible"}
                continue
            try:
                results[plane.name] = client.request(
                    {"op": "offer", "ship": candidate_ship},
                    timeout_s=timeout_s,
                )
            except Exception as e:  # noqa: BLE001 — named, per plane
                results[plane.name] = {
                    "ok": False, "error": "rpc_failed",
                    "message": f"{type(e).__name__}: {e}",
                }
        return results

    def merged_histogram(self) -> BucketedHistogram:
        """The fleet-wide latency distribution: the retired planes'
        last-scraped states + every live plane's latest snapshot,
        merged EXACTLY (counts add — the histogram's merge property,
        cross-process).
        """
        merged = BucketedHistogram()
        with self._lock:
            merged.merge_state(self._retired_hist.state_dict())
            states = [p.last_hist_state for p in self._planes
                      if p.last_hist_state is not None]
        for s in states:
            merged.merge_state(s)
        return merged

    def stats(self) -> Dict[str, Any]:
        """Fleet books + per-plane attribution: every ``fleet_p99*`` /
        ``aggregate_offered*`` figure rides beside a numeric
        ``num_planes`` and per-plane accounting sums."""
        hist = self.merged_histogram()
        snap = hist.stats_snapshot()
        with self._lock:
            planes = {
                p.name: {
                    "pid": p.pid,
                    "healthy": p.healthy,
                    "evicted": p.evicted,
                    "quarantined": p.quarantined,
                    "fingerprint": p.fingerprint,
                    "outstanding": p.outstanding,
                    "offered": p.offered,
                    "completed": p.completed,
                    "rejected": p.rejected,
                    "failed": p.failed,
                    "restarts": p.restarts,
                    "restart_budget_left": p.budget_left,
                }
                for p in self._planes
            }
            return {
                "num_planes": len(self._planes),
                "healthy_planes": sum(
                    1 for p in self._planes if p.eligible()
                ),
                "evicted_planes": [
                    p.name for p in self._planes if p.evicted
                ],
                "quarantined_planes": [
                    p.name for p in self._planes
                    if p.quarantined is not None
                ],
                "restarts_total": sum(
                    p.restarts for p in self._planes
                ),
                "aggregate_offered": self.offered,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "inflight": self._inflight,
                "fleet_latency_count": snap["count"],
                "fleet_p50_latency_s": snap["p50"],
                "fleet_p99_latency_s": snap["p99"],
                "planes": planes,
            }

    def accounting_ok(self) -> bool:
        """The fleet invariant, checked after a drain: every offered
        request is accounted exactly once."""
        with self._lock:
            return (self._inflight == 0
                    and self.offered == (self.completed + self.rejected
                                         + self.failed))

    def plane_pids(self) -> Dict[str, Optional[int]]:
        with self._lock:
            return {p.name: p.pid for p in self._planes}

    def boot_seconds(self) -> Dict[str, Optional[float]]:
        """Each plane's last boot: spawn to its bootstrap reply, seconds."""
        with self._lock:
            return {p.name: p.boot_s for p in self._planes}

    def plane_stats(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Every live plane's own ``stats`` reply (its server's books,
        its kernel launch counters, its device memory), by plane name;
        a plane without a client, or whose RPC fails, maps to None."""
        out: Dict[str, Any] = {}
        for plane in self._planes:
            with self._lock:
                client = plane.client
            try:
                out[plane.name] = (client.request({"op": "stats"},
                                                  timeout_s=timeout_s)
                                   if client is not None else None)
            except Exception:  # noqa: BLE001 — a dead plane has no stats
                out[plane.name] = None
        return out

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._watchdog_stop.set()
        self._watchdog.join(timeout)
        # One sentinel per dispatcher; anything still queued ahead of
        # the sentinels is failed LOUDLY by the dispatchers themselves
        # (the closed check in _dispatch_loop) — books stay exact.
        for _ in self._dispatchers:
            self._queue.put(None)
        for t in self._dispatchers:
            t.join(timeout)
        for plane in self._planes:
            client = plane.client
            if client is not None:
                try:
                    client.request({"op": "shutdown"}, timeout_s=5.0)
                except Exception:  # noqa: BLE001 — dying anyway
                    pass
                client.close()
            if plane.proc is not None:
                plane.proc.join(timeout=10.0)
                if plane.proc.is_alive():
                    plane.proc.terminate()
                    plane.proc.join(timeout=5.0)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
