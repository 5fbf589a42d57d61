"""Multi-tenant model zoo: many fingerprinted plans on one device budget
(port of ``keystone_tpu/serving/zoo.py``).

Every serving plane below this module serves ONE exported plan. The zoo
lets many tenants share one card, with ISOLATION as the headline
contract:

  - **Weight paging under a hard budget.** A RESIDENT tenant holds a
    live :class:`~keystone_tpu_torch.serving.export.ExportedPlan`
    (weights on the serving device, one CUDA graph per padding bucket on
    the card) behind its own batcher. A PAGED-OUT tenant holds its
    weights host-side in the int16 + bf16 split-plane encoding
    (:class:`PagedWeights`): a float32 tensor splits bit-exactly into its
    bf16 high half and an int16 low-mantissa plane, and a tensor whose
    low plane is all zero (a bf16-representable weight) stores only
    2 B an element. Every tensor carries a CRC
    (``data/durable.py``'s ``crc_of_array``): a bit-flipped paged tensor
    raises :class:`~keystone_tpu_torch.data.durable.ShardCorrupted` at
    page-in and QUARANTINES the plan, never a silently wrong response.
    Encode and decode run as tasks on a
    :class:`~keystone_tpu_torch.data.runtime.DataPlaneRuntime` lane
    (``zoo.page``; numpy only, never a tensor) through the
    ``serving.zoo.page_in`` / ``serving.zoo.page_out`` fault sites with a
    bounded-backoff :class:`~keystone_tpu_torch.utils.faults.RetryPolicy`.
  - **Page-in on the card.** The decoded arrays are staged in page-locked
    host memory and copied to the device on the faulting caller's
    thread, which then rebuilds the plan: every bucket is run eagerly and
    recaptured (``export.py``), in the capture's thread-local mode, so the
    other tenants' replays go on. ``torch.cuda.graph`` synchronises the
    card and collects garbage at each capture, so a page-in stalls the
    other tenants' in-flight replays for its duration. A capture or launch
    failure fails the request loudly or quarantines the tenant; there is
    no fallback.
  - **Page-out on the card.** The tenant is drained and its server closed
    first; then its tensors are pulled to the host, encoded, and the
    operator slots set to ``None``. The plan (its composed closure, its
    bucket programs' static buffers and graph pools) is dropped with the
    server, so no graph that embeds the freed weights can replay.
  - **Bit identity per fingerprint.** A plan's
    :func:`~keystone_tpu_torch.serving.export.plan_fingerprint` is
    recorded at registration; after every page-in the rebuilt plan's
    fingerprint (which covers the weights' content CRCs) must MATCH it.
  - **LRU eviction priced by cost.** When the budget binds, the victim is
    chosen by score = recency / (page-in cost x SLO pressure): least
    recently used first, discounted by how expensive the tenant is to
    bring back (its measured page-in seconds, seeded from the cost
    model's byte pricing) and by its SLO state (a WARN / BREACH tenant is
    held resident). Every choice is a ``zoo.decision`` audit event with
    its scored candidates, winner and reason, and a ``placement.*``
    record.
  - **Per-tenant SLOs and deficit-weighted fair admission.** Each tenant
    carries its own :class:`~keystone_tpu_torch.obs.slo.SLOTracker`;
    every tenant has a queue-depth cap, and once the global outstanding
    pool is full only tenants under their guaranteed share
    (``weight_i / sum(weights) x max_outstanding_total``) admit: a hot
    tenant's overflow is rejected at its own door with a named error
    that burns its own budget. ``offered == completed + rejected +
    failed`` holds per tenant.
  - **Graceful degradation.** A page fault on a cold tenant is
    deadline-aware: an unmeetable deadline fast-fails with
    :class:`TenantColdStart` against the page-in estimate. Retry
    exhaustion or a CRC mismatch quarantines the plan loudly (flight
    record dump, ``zoo.quarantined``, :class:`TenantQuarantined` on every
    later submit) while every other tenant keeps serving.

The budget charges each tenant its plan's ``pinned_bytes`` (its weights),
as the reference does; on the card a resident tenant also holds its
bucket programs' static buffers and graph pools, which the charge leaves
out.

Per-tenant servers are :class:`~keystone_tpu_torch.serving.batcher
.MicroBatchServer`\\ s; ``replicas_per_tenant > 1`` fronts each tenant
with a :class:`~keystone_tpu_torch.serving.replicas.ReplicatedServer`.

Isolation against the collector (ROADMAP C.14): a zoo freezes nothing
itself; the process that owns the heap serves its storm inside
:func:`~keystone_tpu_torch.serving.batcher.frozen_heap`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import durable
from keystone_tpu_torch.placement.engine import (
    KIND_ZOO_EVICT,
    KIND_ZOO_PAGE_IN,
    PlacementEngine,
    active_family,
)
from keystone_tpu_torch.obs.metrics import (
    METRIC_TENANT_COLDSTART_FAILFAST,
    METRIC_TENANT_COMPLETED,
    METRIC_TENANT_FAILED,
    METRIC_TENANT_OFFERED,
    METRIC_TENANT_REJECTED,
    METRIC_ZOO_DECISIONS,
    METRIC_ZOO_PAGE_INS,
    METRIC_ZOO_PAGE_OUTS,
    METRIC_ZOO_QUARANTINED,
    METRIC_ZOO_RESIDENTS,
)
from keystone_tpu_torch.utils import faults

from .batcher import (
    MicroBatchServer,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
)
from .export import ExportedPlan, _operators, _tensor_attrs

__all__ = [
    "ModelZoo",
    "PagedWeights",
    "TenantColdStart",
    "TenantQuarantined",
    "ZooDecision",
]

logger = logging.getLogger("keystone_tpu_torch.serving")

# SLO-pressure multipliers for eviction scoring: a tenant already
# burning budget is held resident (its page-in cost is effectively
# multiplied), so the budget squeeze lands on healthy-idle tenants.
_SLO_PRESSURE = {"OK": 1.0, "WARN": 4.0, "BREACH": 16.0}


class TenantColdStart(ServerOverloaded):
    """A page fault on a cold (paged-out) tenant could not meet the
    request's deadline: the estimated page-in time exceeds the deadline
    budget, so the request fast-fails HERE — named, counted, SLO-fed —
    instead of wedging the batcher behind a multi-second weight rebuild.
    An :class:`~keystone_tpu_torch.serving.batcher.ServerOverloaded` subclass:
    capacity (residency) was the limiting resource."""


class TenantQuarantined(ServerDegraded):
    """The tenant's plan is quarantined — a paged tensor failed its CRC
    (bit flip: serving it would be silently wrong) or page-in failed
    past the retry budget. Every submit fast-fails with this error until
    the operator re-registers the tenant; every OTHER tenant keeps
    serving. A :class:`~keystone_tpu_torch.serving.batcher.ServerDegraded`
    subclass: the plan, not the load, is the problem."""


# ---------------------------------------------------------------------------
# Paged weight encoding: bit-exact int16+bf16 split planes + CRCs
# ---------------------------------------------------------------------------


class _PagedTensor:
    """One weight tensor paged host-side. f32 tensors store the
    two-16-bit-lane layout: ``hi`` is the bf16 high half (truncated f32
    top 16 bits — exactly the bfloat16 bit pattern) and ``lo`` the int16
    low-mantissa residue; ``f32 == (hi << 16) | lo`` bit-for-bit, so the
    round trip is EXACT, and a tensor whose low plane is all zero (a
    bf16-representable weight) drops it — 2 B/elem, the compressed win.
    Non-f32 dtypes ride as raw bytes. ``crc`` digests the ORIGINAL
    array's bytes (durable.py discipline, algorithm recorded)."""

    __slots__ = ("shape", "dtype", "hi", "lo", "raw", "crc", "algo")

    def __init__(self, shape, dtype, hi, lo, raw, crc, algo):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.hi = hi
        self.lo = lo
        self.raw = raw
        self.crc = crc
        self.algo = algo

    @property
    def nbytes(self) -> int:
        total = 0
        for plane in (self.hi, self.lo, self.raw):
            if plane is not None:
                total += plane.nbytes
        return total


def _encode_tensor(arr: np.ndarray) -> _PagedTensor:
    arr = np.ascontiguousarray(arr)
    crc = durable.crc_of_array(arr)
    algo = durable.checksum_algo()
    if arr.dtype == np.float32:
        u = arr.view(np.uint32)
        hi = (u >> np.uint32(16)).astype(np.uint16)
        lo = (u & np.uint32(0xFFFF)).astype(np.uint16)
        if not lo.any():
            lo = None  # bf16-representable: the compressed 2 B/elem form
        return _PagedTensor(arr.shape, arr.dtype, hi, lo, None, crc, algo)
    return _PagedTensor(
        arr.shape, arr.dtype, None, None,
        arr.view(np.uint8).reshape(-1).copy(), crc, algo,
    )


def _decode_tensor(pt: _PagedTensor, site: str) -> np.ndarray:
    """Decode one paged tensor, running each stored plane through the
    fault harness's corruption hook (so chaos plans can flip a byte at
    ``site``) and verifying the recorded CRC over the DECODED bytes —
    a mismatch raises through :func:`durable.corrupted` (flight dump
    beside it), which the retry layer never retries."""
    if pt.raw is not None:
        raw = faults.corrupt_array(site, pt.raw)
        out = raw.view(pt.dtype).reshape(pt.shape).copy()
    else:
        hi = faults.corrupt_array(site, pt.hi)
        u = hi.astype(np.uint32) << np.uint32(16)
        if pt.lo is not None:
            lo = faults.corrupt_array(site, pt.lo)
            u = u | lo.astype(np.uint32)
        out = u.view(np.float32).reshape(pt.shape)
    got = durable.crc_of_array(out, pt.algo)
    if got != pt.crc:
        raise durable.corrupted(
            f"paged weight tensor failed checksum at {site}: "
            f"crc {got:#x} != recorded {pt.crc:#x} ({pt.algo}, shape "
            f"{pt.shape}, dtype {pt.dtype}) — serving it would be "
            f"silently wrong; the plan must be quarantined"
        )
    return out


class PagedWeights:
    """The host-side paged form of one plan's device weights: the
    tensors in slot order (the tensor-attribute walk of the plan graph
    that export's pinning makes), each CRC-guarded. ``decoded_bytes`` is the resident
    footprint the tensors decode back to — what the budget arithmetic
    charges a page-in with."""

    __slots__ = ("tensors", "decoded_bytes")

    def __init__(self, tensors: List[_PagedTensor], decoded_bytes: int):
        self.tensors = tensors
        self.decoded_bytes = int(decoded_bytes)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors)


def _page_out_task(host_arrays: List[np.ndarray]) -> PagedWeights:
    """The page-out lane task (host/numpy only, never a tensor): fire
    the fault site, then encode every tensor. Runs to completion or
    raises with NOTHING published — the caller swaps the result in
    atomically, so a kill mid-encode leaves the previous resident copy
    authoritative."""
    faults.maybe_fail(faults.SITE_ZOO_PAGE_OUT)
    tensors = [_encode_tensor(a) for a in host_arrays]
    return PagedWeights(tensors, sum(a.nbytes for a in host_arrays))


def _page_in_task(paged: PagedWeights) -> List[np.ndarray]:
    """The page-in lane task (host/numpy only): fire the fault site,
    decode + CRC-verify every tensor. A transient injected error is
    retried by the caller's policy; a checksum mismatch raises
    ShardCorrupted and is NEVER retried (persistent state)."""
    faults.maybe_fail(faults.SITE_ZOO_PAGE_IN)
    return [_decode_tensor(t, faults.SITE_ZOO_PAGE_IN) for t in paged.tensors]


# ---------------------------------------------------------------------------
# Decision audit
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ZooDecision:
    """One paging/eviction/quarantine choice, as evidence — the zoo
    analogue of ``cost.decision`` / ``autoscale.decision``: what the zoo
    saw (inputs, scored candidates for evictions), what it did (action,
    tenant), and why (reason). ``ok=False`` records an attempted action
    that failed (e.g. a page-out killed mid-encode)."""

    action: str                  # page_in | page_out | evict | quarantine
    tenant: str
    reason: str
    t_s: float
    ok: bool = True
    inputs: Dict[str, Any] = field(default_factory=dict)
    candidates: List[Dict[str, Any]] = field(default_factory=list)
    # Placement-engine provenance: which weight family priced the
    # paging/eviction candidates — the field every decision stream
    # shares.
    weights_family: Optional[str] = None

    def to_args(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "tenant": self.tenant,
            "reason": self.reason,
            "ok": self.ok,
            "t_s": self.t_s,
            "inputs": dict(self.inputs),
            # Unconditional: the decision-event schema (tools/lint.py)
            # wants candidates/winner on every stream, [] when the
            # action considered no alternatives.
            "candidates": [dict(c) for c in self.candidates],
            "winner": self.tenant,
            "weights_family": self.weights_family,
        }


# ---------------------------------------------------------------------------
# Tenant state
# ---------------------------------------------------------------------------


class _Tenant:
    """One tenant's full state: identity (fingerprint, graph, slots),
    residency (plan+server when resident, PagedWeights when not), the
    front-door accounting counters (authoritative — they survive server
    teardown across page-outs), and the per-tenant SLO tracker."""

    __slots__ = (
        "tenant_id", "weight", "graph", "source", "sink", "example",
        "max_batch", "buckets", "fingerprint", "slots", "op_ids", "plan",
        "server", "paged", "resident_bytes", "quarantined",
        "quarantine_reason", "paging", "outstanding", "offered",
        "completed", "rejected", "failed", "coldstart_failfast",
        "page_ins", "page_outs", "page_retries", "last_used",
        "last_page_in_s", "slo", "replicas", "device", "slot_dtypes",
    )

    def __init__(self, tenant_id: str, plan: ExportedPlan, weight: float,
                 slo, replicas: int, resident_bytes: int):
        self.tenant_id = tenant_id
        self.weight = float(weight)
        self.graph = plan.graph
        self.source = plan.source
        self.sink = plan.sink
        self.example = np.zeros(plan.item_shape, np.dtype(plan.dtype))
        self.max_batch = plan.max_batch
        self.buckets = list(plan.buckets)
        self.fingerprint = plan.fingerprint
        self.device = plan.device
        self.slots: List[Tuple[Any, str, Optional[int]]] = []
        self.slot_dtypes: List[torch.dtype] = []
        self.op_ids: frozenset = frozenset()
        self.plan: Optional[ExportedPlan] = plan
        self.server = None
        self.paged: Optional[PagedWeights] = None
        self.resident_bytes = int(resident_bytes)
        self.quarantined = False
        self.quarantine_reason: Optional[str] = None
        self.paging = False
        self.outstanding = 0
        self.offered = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.coldstart_failfast = 0
        self.page_ins = 0
        self.page_outs = 0
        self.page_retries = 0
        self.last_used = 0.0
        self.last_page_in_s: Optional[float] = None
        self.slo = slo
        self.replicas = int(replicas)

    @property
    def resident(self) -> bool:
        return self.server is not None

    def slo_state(self) -> str:
        return self.slo.worst_state() if self.slo is not None else "OK"


def _collect_weight_slots(graph):
    """``[(operator, attr, list_index_or_None, tensor)]`` — exactly the
    tensors ``export._pin_operator_arrays`` moves onto the serving device
    (``export._operators`` and ``export._tensor_attrs``: every operator
    once, fused members included; tensor attributes and non-empty lists
    of tensors), each operator's attributes in sorted order as in the
    reference. A tensor the pin walk moves and this walk missed would
    stay on the card after page-out and break the budget silently. Slot
    order is the paging identity only between page-out and page-in of
    the same entry (both read ``entry.slots``). Caller-thread only (reads
    tensors)."""
    slots = []
    for op in _operators(graph):
        for k, v in sorted(_tensor_attrs(op), key=lambda kv: kv[0]):
            if isinstance(v, list):
                slots.extend((op, k, i, a) for i, a in enumerate(v))
            else:
                slots.append((op, k, None, v))
    return slots


def _slot_value(op, attr, idx):
    return getattr(op, attr) if idx is None else getattr(op, attr)[idx]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a host numpy array (caller thread: may read the
    card). bfloat16, which numpy lacks, travels as its int16 pattern."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _upload(host: List[np.ndarray], dtypes: List[torch.dtype],
            device: torch.device) -> List[torch.Tensor]:
    """Decoded host arrays as tensors on ``device`` (caller thread). On a
    card the arrays are staged in page-locked memory and copied without
    blocking, then the stream is synchronised once: the rebuilt plan's
    eager runs read the copied weights. A bfloat16 slot is restored from
    its int16 pattern."""
    from keystone_tpu_torch.data.prefetch import stage_segment

    if device.type == "cuda":
        staged = stage_segment(tuple(host), device)
        out = [a.to(device, non_blocking=True) for a in staged]
        torch.cuda.current_stream(device).synchronize()
    else:
        out = [torch.from_numpy(a) for a in host]
    return [t.view(torch.bfloat16) if dt == torch.bfloat16 else t
            for t, dt in zip(out, dtypes)]


def _restore_slot(op, attr, idx, value) -> None:
    if idx is None:
        object.__setattr__(op, attr, value)
    else:
        getattr(op, attr)[idx] = value


# ---------------------------------------------------------------------------
# The zoo
# ---------------------------------------------------------------------------


class ModelZoo:
    """Serve MANY fingerprinted plans under one hard device-memory
    budget with per-tenant isolation (module docstring for the design).

    Knobs:

      - ``budget_bytes``: the hard resident-weight budget. Page-ins
        evict until the faulting tenant fits; a single tenant larger
        than the budget is rejected at :meth:`add_tenant`.
      - ``max_outstanding_total`` / ``tenant_queue_cap``: the fair
        admission surface — the global outstanding pool WFQ shares are
        computed over, and the per-tenant depth cap.
      - ``cold_start_estimate_s``: the page-in time estimate before any
        page-in has been measured (the deadline-aware fast-fail bound;
        replaced by a measured EMA after the first page-in).
      - ``page_retry_attempts``: transient page-task failures absorbed
        per page operation before the tenant is quarantined (page-in)
        or the page-out is abandoned with the resident copy intact.
      - ``evict_drain_timeout_s``: bound on draining an eviction
        victim's in-flight work; a victim that cannot drain re-enters
        rotation untouched (zero-drop) and the page-in fails.
      - ``replicas_per_tenant``: 1 = one MicroBatchServer per resident
        tenant; >1 fronts each with a ReplicatedServer plane.
      - ``max_batch`` / ``max_wait_ms`` / ``max_queue_depth``: the
        per-tenant server knobs.
    """

    def __init__(
        self,
        budget_bytes: int,
        max_outstanding_total: int = 256,
        tenant_queue_cap: int = 64,
        cold_start_estimate_s: float = 1.0,
        page_retry_attempts: int = 3,
        evict_drain_timeout_s: float = 5.0,
        replicas_per_tenant: int = 1,
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        max_queue_depth: int = 256,
        runtime=None,
        metrics=None,
        decision_log_len: int = 256,
    ):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        if max_outstanding_total < 1:
            raise ValueError("max_outstanding_total must be >= 1")
        if tenant_queue_cap < 1:
            raise ValueError("tenant_queue_cap must be >= 1")
        if replicas_per_tenant < 1:
            raise ValueError("replicas_per_tenant must be >= 1")
        self.budget_bytes = int(budget_bytes)
        self.max_outstanding_total = int(max_outstanding_total)
        self.tenant_queue_cap = int(tenant_queue_cap)
        self.cold_start_estimate_s = float(cold_start_estimate_s)
        self.page_retry_attempts = int(page_retry_attempts)
        self.evict_drain_timeout_s = float(evict_drain_timeout_s)
        self.replicas_per_tenant = int(replicas_per_tenant)
        self._server_kwargs = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue_depth=max_queue_depth,
        )
        self._runtime = runtime
        self.metrics = metrics if metrics is not None \
            else obs.MetricsRegistry()
        self._g_residents = self.metrics.gauge(METRIC_ZOO_RESIDENTS)
        self._c_page_ins = self.metrics.counter(METRIC_ZOO_PAGE_INS)
        self._c_page_outs = self.metrics.counter(METRIC_ZOO_PAGE_OUTS)
        self._c_quarantined = self.metrics.counter(METRIC_ZOO_QUARANTINED)
        self._c_decisions = self.metrics.counter(METRIC_ZOO_DECISIONS)

        self._lock = threading.Lock()
        # Serializes ALL residency transitions (page-in, page-out,
        # eviction, add/remove): budget arithmetic stays single-writer
        # and two concurrent page faults cannot double-evict.
        self._page_lock = threading.Lock()
        self._closed = False
        self._t0 = time.monotonic()
        self._tenants: Dict[str, _Tenant] = {}
        self._page_in_ema_s: Optional[float] = None
        self._decisions: "deque[Dict[str, Any]]" = deque(
            maxlen=decision_log_len
        )
        self.num_decisions = 0

    # -- construction / membership -----------------------------------------

    def _rt(self):
        if self._runtime is not None:
            return self._runtime
        from keystone_tpu_torch.data.runtime import default_runtime

        return default_runtime()

    def add_tenant(
        self,
        tenant_id: str,
        plan_or_fitted,
        example=None,
        weight: float = 1.0,
        slo=None,
        resident: bool = True,
        resident_bytes: Optional[int] = None,
        max_batch: Optional[int] = None,
    ) -> str:
        """Register a tenant. ``plan_or_fitted`` is an
        :class:`ExportedPlan` or a ``FittedPipeline`` (exported here at
        ``example``'s signature). The plan's fingerprint is recorded as
        the tenant's bit-identity anchor — every later page-in must
        reproduce it exactly. ``resident=False`` registers the tenant
        paged-out (the weights are encoded immediately and the compiled
        plan dropped — the cold-start-storm shape). ``resident_bytes``
        overrides the budget charge (default: the plan's pinned bytes,
        falling back to the decoded paged footprint). Plans never share
        operator objects across tenants — export per tenant (paging
        mutates operator state in place)."""
        if weight <= 0:
            raise ValueError(f"tenant {tenant_id!r}: weight must be > 0")
        if isinstance(plan_or_fitted, ExportedPlan):
            plan = plan_or_fitted
        else:
            from .export import export_plan

            if example is None:
                raise ValueError(
                    "add_tenant needs example= to export a FittedPipeline"
                )
            plan = export_plan(
                plan_or_fitted, example,
                max_batch=max_batch or self._server_kwargs["max_batch"],
            )
        op_ids = frozenset(
            id(plan.graph.get_operator(n)) for n in plan.graph.nodes
        )
        with self._lock:
            if self._closed:
                raise ServerClosed("add_tenant() after close()")
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} already registered")
            for other in self._tenants.values():
                if op_ids & other.op_ids:
                    raise ValueError(
                        f"tenant {tenant_id!r} shares operator objects "
                        f"with tenant {other.tenant_id!r} — paging one "
                        "would corrupt the other; export a separate plan "
                        "per tenant (deepcopy the fitted pipeline)"
                    )
        slots = _collect_weight_slots(plan.graph)
        bytes_est = resident_bytes if resident_bytes is not None else max(
            plan.pinned_bytes,
            sum(a.numel() * a.element_size() for _, _, _, a in slots),
            1,
        )
        if bytes_est > self.budget_bytes:
            raise ValueError(
                f"tenant {tenant_id!r} needs {bytes_est} resident bytes "
                f"but the zoo budget is {self.budget_bytes} — it could "
                "never be paged in"
            )
        entry = _Tenant(
            tenant_id, plan, weight, slo,
            self.replicas_per_tenant, bytes_est,
        )
        entry.slots = [(op, k, i) for op, k, i, _ in slots]
        entry.slot_dtypes = [a.dtype for _, _, _, a in slots]
        entry.op_ids = op_ids
        with self._page_lock:
            self._evict_until_fits(entry)
            server = self._build_server(entry, plan)
            with self._lock:
                # Re-validate ATOMICALLY with the insertion: the checks
                # above ran before the (slow) slot walk released the
                # lock, and a concurrent add_tenant racing through that
                # window must not silently replace an entry (leaking its
                # live server) or smuggle shared operator objects past
                # the guard.
                conflict = None
                if self._closed:
                    conflict = ServerClosed("add_tenant() after close()")
                elif tenant_id in self._tenants:
                    conflict = ValueError(
                        f"tenant {tenant_id!r} already registered"
                    )
                elif any(
                    op_ids & other.op_ids
                    for other in self._tenants.values()
                ):
                    conflict = ValueError(
                        f"tenant {tenant_id!r} shares operator objects "
                        "with a registered tenant"
                    )
                if conflict is None:
                    entry.server = server
                    entry.last_used = self._now()
                    self._tenants[tenant_id] = entry
            if conflict is not None:
                server.close(timeout=1.0)
                raise conflict
            self._g_residents.set(self._num_residents())
        if not resident:
            self.page_out(tenant_id)
        return entry.fingerprint

    def _build_server(self, entry: _Tenant, plan: ExportedPlan):
        kw = dict(self._server_kwargs)
        if entry.replicas > 1:
            from .replicas import ReplicatedServer

            return ReplicatedServer(
                plan, num_replicas=entry.replicas, slo=entry.slo, **kw
            )
        return MicroBatchServer(plan, slo=entry.slo, **kw)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _num_residents(self) -> int:
        with self._lock:
            return sum(1 for t in self._tenants.values() if t.resident)

    def _resident_bytes_total(self) -> int:
        with self._lock:
            return sum(
                t.resident_bytes for t in self._tenants.values()
                if t.resident
            )

    # -- fair admission + submit -------------------------------------------

    def guaranteed_share(self, tenant_id: str) -> int:
        """The tenant's deficit-weighted guaranteed slice of the global
        outstanding pool: ``max(1, weight_i / Σweights ×
        max_outstanding_total)``. Below it a tenant ALWAYS admits (up to
        its queue cap) even when the pool is full of someone else's
        load — the starvation-proof floor of the isolation contract."""
        with self._lock:
            entry = self._tenants[tenant_id]
            total_w = sum(t.weight for t in self._tenants.values())
        return max(
            1, int(self.max_outstanding_total * entry.weight / total_w)
        )

    def submit(self, tenant: str, x, deadline_ms: Optional[float] = None):
        """Route one request to ``tenant``'s plan; returns a Future
        annotated with ``tenant`` and ``plan_fingerprint``. Admission is
        decided FIRST (quarantine fast-fail, per-tenant queue cap,
        deficit-weighted fair share), then a page fault on a cold tenant
        either fast-fails (:class:`TenantColdStart`, deadline-aware) or
        pages the plan in synchronously — the measured cold-start cost
        this one caller pays, never the batcher's worker."""
        with self._lock:
            if self._closed:
                raise ServerClosed("submit() after close()")
            entry = self._tenants.get(tenant)
            if entry is None:
                raise ValueError(f"unknown tenant {tenant!r}")
            entry.offered += 1
            self.metrics.counter(
                METRIC_TENANT_OFFERED, tenant=tenant
            ).add(1)
            if entry.quarantined:
                entry.rejected += 1
                self.metrics.counter(
                    METRIC_TENANT_REJECTED, tenant=tenant
                ).add(1)
                reason = entry.quarantine_reason
                self._observe_slo_bad(entry)
                raise TenantQuarantined(
                    f"tenant {tenant!r} is quarantined: {reason}"
                )
            if entry.outstanding >= self.tenant_queue_cap:
                entry.rejected += 1
                self.metrics.counter(
                    METRIC_TENANT_REJECTED, tenant=tenant
                ).add(1)
                self._observe_slo_bad(entry)
                raise ServerOverloaded(
                    f"tenant {tenant!r} is at its queue cap "
                    f"({self.tenant_queue_cap}) — its own offered load "
                    "exceeds its admission share"
                )
            total_out = sum(t.outstanding for t in self._tenants.values())
            total_w = sum(t.weight for t in self._tenants.values())
            share = max(1, int(
                self.max_outstanding_total * entry.weight / total_w
            ))
            if (total_out >= self.max_outstanding_total
                    and entry.outstanding >= share):
                # The pool is full AND this tenant is at/over its
                # deficit-weighted share: ITS overflow is what yields.
                # Under-share tenants keep admitting — the WFQ floor.
                entry.rejected += 1
                self.metrics.counter(
                    METRIC_TENANT_REJECTED, tenant=tenant
                ).add(1)
                self._observe_slo_bad(entry)
                raise ServerOverloaded(
                    f"tenant {tenant!r} is over its fair admission share "
                    f"({entry.outstanding}/{share} outstanding) while the "
                    f"global pool is full ({total_out}/"
                    f"{self.max_outstanding_total}) — another tenant's "
                    "guaranteed share is protected"
                )
            entry.last_used = self._now()
        # Serve loop: reserve ONLY while the tenant is observably
        # resident (a reservation held while blocked on the page lock
        # would wedge an eviction drain forever — the drain counts
        # outstanding reservations); a page fault runs WITHOUT a
        # reservation, then re-checks residency. Bounded: an eviction
        # racing this tenant back out between iterations is pathological
        # and still terminates with a named error.
        for _ in range(8):
            with self._lock:
                server = (
                    entry.server
                    if entry.resident and not entry.paging else None
                )
                if server is not None:
                    entry.outstanding += 1  # reserve: drains count us
            if server is None:
                est = self.page_in_estimate_s()
                if deadline_ms is not None and est > deadline_ms / 1e3:
                    with self._lock:
                        entry.rejected += 1
                        entry.coldstart_failfast += 1
                        self.metrics.counter(
                            METRIC_TENANT_REJECTED, tenant=tenant
                        ).add(1)
                        self.metrics.counter(
                            METRIC_TENANT_COLDSTART_FAILFAST,
                            tenant=tenant,
                        ).add(1)
                    self._observe_slo_bad(entry)
                    raise TenantColdStart(
                        f"tenant {tenant!r} is paged out and the page-in "
                        f"estimate ({est:.3g}s) exceeds the request "
                        f"deadline ({deadline_ms:.3g}ms) — fast-failing "
                        "instead of wedging the request behind a cold "
                        "start"
                    )
                try:
                    self._ensure_resident(entry)
                except BaseException:
                    with self._lock:
                        entry.failed += 1
                        self.metrics.counter(
                            METRIC_TENANT_FAILED, tenant=tenant
                        ).add(1)
                    self._observe_slo_bad(entry)
                    raise
                continue
            try:
                fut = server.submit(x, deadline_ms)
            except ServerOverloaded:
                with self._lock:
                    entry.outstanding -= 1
                    entry.rejected += 1
                    self.metrics.counter(
                        METRIC_TENANT_REJECTED, tenant=tenant
                    ).add(1)
                raise  # the tenant's own server already fed its SLO
            except BaseException:
                with self._lock:
                    entry.outstanding -= 1
                    entry.failed += 1
                    self.metrics.counter(
                        METRIC_TENANT_FAILED, tenant=tenant
                    ).add(1)
                raise
            fut.tenant = tenant
            fut.plan_fingerprint = entry.fingerprint
            fut.add_done_callback(self._done_callback(entry))
            return fut
        with self._lock:
            entry.failed += 1
            self.metrics.counter(METRIC_TENANT_FAILED, tenant=tenant).add(1)
        self._observe_slo_bad(entry)
        raise ServerDegraded(
            f"tenant {tenant!r} was repeatedly evicted between page-in "
            "and dispatch — the zoo budget is thrashing"
        )

    def _observe_slo_bad(self, entry: _Tenant) -> None:
        if entry.slo is not None:
            entry.slo.observe(ok=False)

    def _done_callback(self, entry: _Tenant):
        def _cb(fut) -> None:
            try:
                exc = fut.exception()
            except BaseException:  # noqa: BLE001 — client cancelled
                exc = None
            with self._lock:
                entry.outstanding -= 1
                if exc is None:
                    entry.completed += 1
                    name = METRIC_TENANT_COMPLETED
                elif isinstance(exc, ServerOverloaded):
                    entry.rejected += 1
                    name = METRIC_TENANT_REJECTED
                else:
                    entry.failed += 1
                    name = METRIC_TENANT_FAILED
                self.metrics.counter(name, tenant=entry.tenant_id).add(1)
        return _cb

    # -- residency transitions ---------------------------------------------

    def page_in_estimate_s(self) -> float:
        """The deadline-aware cold-start bound: the measured page-in EMA
        once one has completed, else the placement engine's priced
        worst-case tenant footprint under the active weight family
        (``zoo_page_overhead``), floored at ``cold_start_estimate_s``
        (conservative by design — a first-ever cold start against a
        tight deadline should fast-fail, not gamble)."""
        with self._lock:
            if self._page_in_ema_s is not None:
                return self._page_in_ema_s
            worst_bytes = max(
                (t.resident_bytes for t in self._tenants.values()),
                default=0,
            )
        if worst_bytes:
            priced = PlacementEngine().price_page_in(worst_bytes)
            return max(priced, self.cold_start_estimate_s)
        return self.cold_start_estimate_s

    def _retry_policy(self) -> faults.RetryPolicy:
        return faults.RetryPolicy(attempts=self.page_retry_attempts)

    def page_in(self, tenant_id: str) -> None:
        """Make ``tenant_id`` resident (public form of the page-fault
        path — a caller pre-warms through it). No-op when already
        resident; raises :class:`TenantQuarantined` when the decode
        fails its CRCs or the retry budget exhausts."""
        with self._lock:
            entry = self._tenants[tenant_id]
        self._ensure_resident(entry)

    def _ensure_resident(self, entry: _Tenant) -> None:
        with self._page_lock:
            with self._lock:
                if self._closed:
                    raise ServerClosed("page_in() after close()")
                if entry.resident and not entry.paging:
                    return  # someone paged it in while we waited
                if entry.quarantined:
                    raise TenantQuarantined(
                        f"tenant {entry.tenant_id!r} is quarantined: "
                        f"{entry.quarantine_reason}"
                    )
                paged = entry.paged
            if paged is None:  # pragma: no cover — structural invariant
                raise RuntimeError(
                    f"tenant {entry.tenant_id!r} is neither resident nor "
                    "paged"
                )
            t0 = time.perf_counter()
            self._evict_until_fits(entry)
            # Price the fault before paying it: the unified placement
            # stream records the PREDICTED page-in (the calibrated
            # ``zoo_page_overhead`` family) and gets the measured wall
            # stamped onto the same record below (the rows a refit of
            # the weight family reads).
            engine = PlacementEngine(metrics=self.metrics)
            placement_ref = engine.audit(
                KIND_ZOO_PAGE_IN, entry.tenant_id,
                [{
                    "label": entry.tenant_id,
                    "cost_s": engine.price_page_in(entry.resident_bytes),
                    "feasible": True,
                    "resident_bytes": entry.resident_bytes,
                }],
                reason="page_fault",
                context={
                    "budget_bytes": self.budget_bytes,
                    "fingerprint": entry.fingerprint,
                },
            )
            retries = [0]

            def _on_retry(attempt, delay_s, exc):
                retries[0] += 1
                logger.warning(
                    "zoo: page-in of tenant %r attempt %d failed "
                    "(retrying in %.3gs): %r",
                    entry.tenant_id, attempt, delay_s, exc,
                )

            policy = self._retry_policy()
            try:
                host = policy.call(
                    lambda: self._rt().submit(
                        "zoo.page", _page_in_task, paged
                    ).result(),
                    key=f"zoo.page_in:{entry.tenant_id}",
                    on_retry=_on_retry,
                )
            except durable.ShardCorrupted as e:
                self._quarantine_locked_page(
                    entry, f"paged weights failed CRC verification: {e}"
                )
                raise TenantQuarantined(
                    f"tenant {entry.tenant_id!r} quarantined: {e}"
                ) from e
            except OSError as e:
                self._quarantine_locked_page(
                    entry,
                    f"page-in failed {self.page_retry_attempts} "
                    f"attempt(s): {e!r}",
                )
                raise TenantQuarantined(
                    f"tenant {entry.tenant_id!r} quarantined after "
                    f"{self.page_retry_attempts} failed page-in "
                    f"attempt(s): {e!r}"
                ) from e
            # Host decode verified — restore the slots (as tensors on the
            # serving device) and rebuild the plan on THIS thread, which
            # runs and recaptures every bucket (the lane never sees a
            # tensor). A capture or launch failure raises to the caller:
            # there is no fallback.
            try:
                for (op, attr, idx), t in zip(
                        entry.slots,
                        _upload(host, entry.slot_dtypes, entry.device)):
                    _restore_slot(op, attr, idx, t)
                plan = ExportedPlan(
                    entry.graph, entry.source, entry.sink, entry.example,
                    max_batch=entry.max_batch, buckets=entry.buckets,
                    device=entry.device,
                )
            except BaseException:
                # The tenant stays paged out: free what was uploaded.
                self._release_slots(entry)
                raise
            if plan.fingerprint != entry.fingerprint:
                plan.release()
                self._release_slots(entry)
                self._quarantine_locked_page(
                    entry,
                    f"rebuilt plan fingerprint {plan.fingerprint} != "
                    f"registered {entry.fingerprint} — the paging round "
                    "trip was not bit-identical",
                )
                raise TenantQuarantined(
                    f"tenant {entry.tenant_id!r} quarantined: paging "
                    f"round trip broke bit-identity ({plan.fingerprint} "
                    f"!= {entry.fingerprint})"
                )
            server = self._build_server(entry, plan)
            wall = time.perf_counter() - t0
            with self._lock:
                entry.plan = plan
                entry.server = server
                entry.paging = False
                # Drop the host-side copy: a resident tenant holding its
                # PagedWeights forever would grow host RAM by a full
                # fleet weight copy over paging cycles, and read as
                # still-paged in stats(). Page-out re-encodes from the
                # live slots; the quarantine paths (which keep the copy
                # for the postmortem) never reach this commit block.
                entry.paged = None
                entry.page_ins += 1
                entry.page_retries += retries[0]
                entry.last_page_in_s = wall
                self._page_in_ema_s = (
                    wall if self._page_in_ema_s is None
                    else 0.5 * self._page_in_ema_s + 0.5 * wall
                )
            self._c_page_ins.add(1)
            self._g_residents.set(self._num_residents())
            if placement_ref is not None:
                placement_ref.stamp(wall, timing="single_run_cold")
            self._record_decision(
                "page_in", entry.tenant_id,
                reason=f"page fault; decode+rebuild took {wall:.4g}s "
                f"({retries[0]} transient retr{'y' if retries[0] == 1 else 'ies'} absorbed)",
                inputs={
                    "resident_bytes": entry.resident_bytes,
                    "budget_bytes": self.budget_bytes,
                    "page_in_s": round(wall, 6),
                    "retries": retries[0],
                    "fingerprint": entry.fingerprint,
                },
            )

    def page_out(self, tenant_id: str) -> None:
        """Page ``tenant_id``'s weights host-side and release its device
        residency. The encode runs on the page lane through the
        ``serving.zoo.page_out`` fault site and is swapped in ATOMICALLY
        after it completes — a kill mid-encode raises with the resident
        copy untouched and still authoritative (chaos-pinned)."""
        with self._lock:
            entry = self._tenants[tenant_id]
        with self._page_lock:
            self._page_out_locked(entry, reason="explicit page_out")

    def _page_out_locked(self, entry: _Tenant, reason: str) -> None:
        """Page out one tenant (page lock held). Drains the tenant's
        outstanding work first (no admissions race: ``paging`` flips
        under the zoo lock, and submit routes paging tenants into the
        page-fault path which serializes behind the page lock)."""
        with self._lock:
            if not entry.resident:
                return
            entry.paging = True
        try:
            deadline = time.perf_counter() + self.evict_drain_timeout_s
            while True:
                with self._lock:
                    if entry.outstanding == 0:
                        break
                if time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"tenant {entry.tenant_id!r} failed to drain "
                        f"within {self.evict_drain_timeout_s:.3g}s "
                        f"({entry.outstanding} outstanding); it stays "
                        "resident"
                    )
                time.sleep(0.001)
            # Pull to host on THIS thread (it reads the card), encode on
            # the lane (numpy) — nothing is published until the encode
            # verifies.
            host = [_to_host(_slot_value(op, attr, idx))
                    for op, attr, idx in entry.slots]
            policy = self._retry_policy()
            try:
                paged = policy.call(
                    lambda: self._rt().submit(
                        "zoo.page", _page_out_task, host
                    ).result(),
                    key=f"zoo.page_out:{entry.tenant_id}",
                )
            except BaseException as e:
                self._record_decision(
                    "page_out", entry.tenant_id, ok=False,
                    reason=f"page-out failed ({e!r}); the resident copy "
                    "stays authoritative",
                    inputs={"resident_bytes": entry.resident_bytes},
                )
                raise
            # Point of no return — everything below only releases. The
            # server closes (in-flight batches finish) BEFORE the plan's
            # programs and the slots let go of the weights: a graph that
            # embeds them must never replay after they are freed.
            server, plan = entry.server, entry.plan
            with self._lock:
                entry.paged = paged
                entry.server = None
                entry.plan = None
                entry.page_outs += 1
            server.close()
            plan.release()
            self._release_slots(entry)
            self._c_page_outs.add(1)
            self._g_residents.set(self._num_residents())
            self._record_decision(
                "page_out", entry.tenant_id, reason=reason,
                inputs={
                    "resident_bytes": entry.resident_bytes,
                    "paged_bytes": paged.nbytes,
                    "compression": round(
                        paged.nbytes / max(paged.decoded_bytes, 1), 4
                    ),
                },
            )
        finally:
            with self._lock:
                entry.paging = False

    @staticmethod
    def _release_slots(entry: _Tenant) -> None:
        for op, attr, idx in entry.slots:
            _restore_slot(op, attr, idx, None)

    # -- eviction (LRU priced by cost) -------------------------------------

    def _page_cost_estimate_s(self, entry: _Tenant) -> float:
        """What bringing this tenant BACK would cost: its measured
        page-in wall when one exists, else the zoo EMA, else the cost
        model's byte pricing (active mem weight × resident bytes) with
        the cold-start seed as the floor — so eviction scoring is priced
        even before the first measurement."""
        if entry.last_page_in_s is not None:
            return entry.last_page_in_s
        with self._lock:
            ema = self._page_in_ema_s
        if ema is not None:
            return ema
        return max(
            PlacementEngine().price_page_in(entry.resident_bytes),
            self.cold_start_estimate_s,
        )

    def _evict_until_fits(self, incoming: _Tenant) -> None:
        """Evict resident tenants (page lock held) until ``incoming``
        fits the budget. Victim score = recency / (page-in cost × SLO
        pressure) — the LRU-priced-by-cost policy: old, cheap-to-restore,
        healthy tenants go first; a WARN/BREACH tenant is 4–16× stickier.
        Deterministic: ties break on tenant id. Raises
        :class:`TenantColdStart` when nothing can be evicted (every
        resident tenant is the faulting one, draining, or undrainable)."""
        while (self._resident_bytes_total() + incoming.resident_bytes
               > self.budget_bytes):
            now = self._now()
            with self._lock:
                candidates = [
                    t for t in self._tenants.values()
                    if t.resident and not t.paging
                    and t.tenant_id != incoming.tenant_id
                ]
            if not candidates:
                raise TenantColdStart(
                    f"tenant {incoming.tenant_id!r} needs "
                    f"{incoming.resident_bytes} bytes but nothing can be "
                    f"evicted (budget {self.budget_bytes}, resident "
                    f"{self._resident_bytes_total()})"
                )
            scored = []
            for t in candidates:
                age_s = max(now - t.last_used, 1e-9)
                cost_s = max(self._page_cost_estimate_s(t), 1e-9)
                pressure = _SLO_PRESSURE.get(t.slo_state(), 1.0)
                scored.append({
                    "tenant": t.tenant_id,
                    "age_s": round(age_s, 6),
                    "page_in_cost_s": round(cost_s, 6),
                    "slo_state": t.slo_state(),
                    "slo_pressure": pressure,
                    "resident_bytes": t.resident_bytes,
                    "score": age_s / (cost_s * pressure),
                })
            # Highest score evicts first; ties by tenant id so the
            # choice replays identically (tests pin this).
            scored.sort(key=lambda c: (-c["score"], c["tenant"]))
            victim_id = scored[0]["tenant"]
            with self._lock:
                victim = self._tenants[victim_id]
            reason = (
                f"budget binds paging in {incoming.tenant_id!r} "
                f"(+{incoming.resident_bytes}B over "
                f"{self.budget_bytes}B); LRU-by-cost winner"
            )
            candidates = [
                {k: v for k, v in c.items() if k != "score"}
                | {"score": round(c["score"], 6)}
                for c in scored
            ]
            self._record_decision(
                "evict", victim_id,
                reason=reason,
                inputs={
                    "incoming": incoming.tenant_id,
                    "incoming_bytes": incoming.resident_bytes,
                    "budget_bytes": self.budget_bytes,
                    "resident_bytes": self._resident_bytes_total(),
                },
                candidates=candidates,
            )
            # The placement mirror: eviction scoring is policy-chosen
            # (LRU-priced-by-cost, not a cost argmin), so the engine
            # audits rather than decides — each candidate's restore
            # price rides in ``page_in_cost_s``.
            PlacementEngine(metrics=self.metrics).audit(
                KIND_ZOO_EVICT, victim_id,
                [
                    {**c, "cost_s": c.get("page_in_cost_s")}
                    for c in candidates
                ],
                reason="lru_by_cost",
                context={
                    "incoming": incoming.tenant_id,
                    "incoming_bytes": incoming.resident_bytes,
                    "budget_bytes": self.budget_bytes,
                },
            )
            self._page_out_locked(
                victim,
                reason=f"evicted for {incoming.tenant_id!r} (LRU-by-cost)",
            )

    # -- quarantine ---------------------------------------------------------

    def _quarantine_locked_page(self, entry: _Tenant, reason: str) -> None:
        """Quarantine a tenant (page lock held): tear down any live
        server, keep the paged copy for the postmortem, flip the loud
        signals (flight dump, ``zoo.quarantined`` metric, decision
        event). Every other tenant keeps serving."""
        server = None
        with self._lock:
            entry.quarantined = True
            entry.quarantine_reason = reason
            server = entry.server
            entry.server = None
            entry.plan = None
            entry.paging = False
        if server is not None:
            server.close()
        self._c_quarantined.add(1)
        self._g_residents.set(self._num_residents())
        logger.warning(
            "zoo tenant %r QUARANTINED: %s", entry.tenant_id, reason
        )
        obs.flight.dump_flight_record(
            f"zoo tenant {entry.tenant_id!r} quarantined: {reason}",
            log=logger,
        )
        self._record_decision(
            "quarantine", entry.tenant_id, reason=reason,
            inputs={"fingerprint": entry.fingerprint},
        )

    # -- decision audit ----------------------------------------------------

    def _record_decision(self, action, tenant, reason, ok=True,
                         inputs=None, candidates=None) -> Dict[str, Any]:
        decision = ZooDecision(
            action=action, tenant=tenant, reason=reason, ok=ok,
            t_s=round(self._now(), 6),
            inputs=dict(inputs or {}),
            candidates=list(candidates or []),
            weights_family=active_family(),
        )
        rec = decision.to_args()
        with self._lock:
            self._decisions.append(rec)
            self.num_decisions += 1
        self._c_decisions.add(1)
        obs.event("zoo.decision", **rec)
        obs.flight_note(
            "zoo", f"{action}:{tenant}", ok=ok, reason=reason,
        )
        return rec

    def decision_log(self) -> List[Dict[str, Any]]:
        """The bounded in-memory audit trail (newest last)."""
        with self._lock:
            return list(self._decisions)

    # -- observability -----------------------------------------------------

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def stats(self) -> Dict[str, Any]:
        """The zoo summary block: per-tenant accounting + residency +
        compact SLO verdicts, zoo-level paging counters, the decision
        log tail, and ``accounting_ok`` — the per-tenant zero-silent-drop
        claim (``offered == completed + rejected + failed + outstanding``
        at the instant of the snapshot; exactly ``== completed +
        rejected + failed`` once the plane is drained)."""
        now = self._now()
        per_tenant: Dict[str, Dict[str, Any]] = {}
        accounting_ok = True
        quarantined = 0
        coldstart_failfast = 0
        # Counter fields are mutated in single lock acquisitions at the
        # front door (offered+outstanding together, resolution
        # outstanding+outcome together), so the balance check must read
        # them under the SAME lock — a half-observed submit would read
        # as a spurious accounting violation.
        with self._lock:
            tenants = list(self._tenants.values())
            decisions = list(self._decisions)
            num_decisions = self.num_decisions
            total_out = sum(t.outstanding for t in tenants)
            total_w = sum(t.weight for t in tenants) or 1.0
            for t in tenants:
                balanced = (
                    t.offered
                    == t.completed + t.rejected + t.failed + t.outstanding
                )
                accounting_ok = accounting_ok and balanced
                quarantined += int(t.quarantined)
                coldstart_failfast += t.coldstart_failfast
                block: Dict[str, Any] = {
                    "resident": t.resident,
                    "quarantined": t.quarantined,
                    "weight": t.weight,
                    "offered": t.offered,
                    "completed": t.completed,
                    "rejected": t.rejected,
                    "failed": t.failed,
                    "outstanding": t.outstanding,
                    "coldstart_failfast": t.coldstart_failfast,
                    "accounting_ok": balanced,
                    "resident_bytes": t.resident_bytes,
                    "paged_bytes": t.paged.nbytes if t.paged else None,
                    "page_ins": t.page_ins,
                    "page_outs": t.page_outs,
                    "page_retries": t.page_retries,
                    "last_used_age_s": round(
                        max(now - t.last_used, 0.0), 6
                    ),
                    "guaranteed_share": max(1, int(
                        self.max_outstanding_total * t.weight / total_w
                    )),
                    "admission_share": round(
                        t.outstanding / total_out, 4
                    ) if total_out else 0.0,
                    "fingerprint": t.fingerprint,
                }
                if t.quarantine_reason:
                    block["quarantine_reason"] = t.quarantine_reason
                per_tenant[t.tenant_id] = block
        # SLO verdicts OUTSIDE the zoo lock (each tracker takes its own
        # lock and renders ledgers).
        for t in tenants:
            if t.slo is not None:
                v = t.slo.verdict()
                per_tenant[t.tenant_id]["slo"] = {
                    "state": v["state"],
                    "objectives": {
                        name: {
                            "state": o["state"],
                            "burn_fast": o["burn_fast"],
                            "burn_slow": o["burn_slow"],
                            "budget_spent_fraction":
                                o["budget_spent_fraction"],
                        }
                        for name, o in v["objectives"].items()
                    },
                }
        return {
            "num_tenants": len(tenants),
            "residents": sum(1 for t in tenants if t.resident),
            "budget_bytes": self.budget_bytes,
            "resident_bytes": sum(
                t.resident_bytes for t in tenants if t.resident
            ),
            "page_ins": int(self._c_page_ins.value),
            "page_outs": int(self._c_page_outs.value),
            "quarantined": quarantined,
            "coldstart_failfast": coldstart_failfast,
            "accounting_ok": accounting_ok,
            "num_decisions": num_decisions,
            "page_in_estimate_s": round(self.page_in_estimate_s(), 6),
            "max_outstanding_total": self.max_outstanding_total,
            "tenant_queue_cap": self.tenant_queue_cap,
            "tenants": per_tenant,
            "decisions": decisions[-64:],
        }

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop the zoo: every resident tenant's server closes
        (in-flight batches complete, queued requests fail with
        :class:`~keystone_tpu_torch.serving.batcher.ServerClosed`).
        Idempotent; paged copies are left in place."""
        with self._page_lock:
            with self._lock:
                self._closed = True
                servers = [
                    t.server for t in self._tenants.values()
                    if t.server is not None
                ]
            for s in servers:
                s.close(timeout=timeout)

    def __enter__(self) -> "ModelZoo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
