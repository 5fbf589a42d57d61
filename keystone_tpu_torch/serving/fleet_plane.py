"""One serving-plane PROCESS of the fleet: plan-ship codec + the
``multiprocessing`` bootstrap target (port of
``keystone_tpu/serving/fleet_plane.py``).

The router (``serving/fleet.py``) names no ``torch``; everything that must
touch it — decoding shipped weights onto the device, exporting the plan,
running today's full :class:`ReplicatedServer` stack — lives here, and
ONLY runs inside the spawned plane process. Module level stays
import-light (stdlib + numpy + the fault harness) so the parent can
reference :func:`plane_main` as a spawn target without dragging the
device stack into the router; ``torch`` is imported inside the functions
that run in a plane or in the encoding caller, never at module level (the
reference does the same with ``jax``).

Plan shipping (the integrity contract): a plan travels as

  - a pickled *skeleton* — the fitted pipeline (fused operators rebuild
    their composed closures when unpickled, so the skeleton must unpickle
    standalone — weight slots cannot be stripped to sentinels). It is
    pickled with every tensor copied to the host first
    (:func:`_pickle_on_host`): a CUDA tensor pickled as it lies would
    carry its device in ``torch.save``'s storage bytes, and unpickling it
    would put it on ``cuda:0`` behind the plane's back. The plane places
    every tensor of the skeleton on its own device explicitly;
  - the weights, AGAIN, as the zoo's bit-exact split-plane tensors
    (``uint16`` hi/lo planes + per-tensor CRC, unchanged). These are the
    AUTHORITATIVE bits: on arrival each is CRC-verified, decoded,
    required to be BIT-IDENTICAL to the skeleton's corresponding slot (a
    disagreement between the two channels means wire corruption or
    tampering), and then restored into the slots on the plane's device —
    the skeleton's own copies are never trusted un-cross-checked;
  - the export signature (item shape/dtype, max_batch, padding buckets)
    and the CLAIMED ``plan_fingerprint``.

After restore the plane re-exports the plan and recomputes the
fingerprint end-to-end (the ``fleet.rpc.send`` corrupt site models wire
corruption of a shipped weight plane). Any mismatch — CRC,
cross-channel bit-identity, or fingerprint — QUARANTINES the plane: it
stays up, answers heartbeats, and refuses every request with a named
error; wrong bits are never served (the zoo's posture, extended across
the process boundary).

The plane serves on ``cfg["device"]``: left unset, the CUDA device (it
raises without one); tests pass ``"cpu"``. Its ``stats`` reply and its
``/snapshot.json`` carry the process's kernel launch counters
(``cuda_ops.launches``): the counters are per process, so the fleet's
launches are the planes' sums.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.utils import faults

from .fleet_rpc import RpcServer

__all__ = ["PlanShip", "ShipRejected", "encode_plan_ship", "decode_plan_ship",
           "plane_main"]

logger = logging.getLogger(__name__)


class PlanShip:
    """The cross-process form of one exported plan (see module
    docstring). ``tensors`` are zoo ``_PagedTensor`` objects — hi/lo
    ``uint16`` planes + per-tensor CRC."""

    __slots__ = ("skeleton", "tensors", "item_shape", "dtype",
                 "max_batch", "buckets", "fingerprint")

    def __init__(self, skeleton: bytes, tensors: List[Any],
                 item_shape: Tuple[int, ...], dtype: str,
                 max_batch: Optional[int], buckets: Sequence[int],
                 fingerprint: str):
        self.skeleton = skeleton
        self.tensors = tensors
        self.item_shape = tuple(item_shape)
        self.dtype = str(dtype)
        self.max_batch = max_batch
        self.buckets = tuple(buckets)
        self.fingerprint = str(fingerprint)

    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        for s in self.__slots__:
            setattr(self, s, state[s])


class ShipRejected(RuntimeError):
    """A shipped plan failed its integrity verification (tensor CRC or
    end-to-end fingerprint) — the receiving plane must quarantine."""


def _pickle_on_host(obj) -> bytes:
    """``pickle.dumps(obj)`` with every tensor off the host pickled as its
    host copy, so the bytes name no device (module docstring)."""
    import torch

    class _HostPickler(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor) and o.device.type != "cpu":
                return o.detach().cpu().__reduce_ex__(4)
            return NotImplemented

    buf = io.BytesIO()
    _HostPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


def _unpickle_onto(blob: bytes, device):
    """``pickle.loads(blob)`` with every tensor it rebuilds placed on
    ``device``."""
    from torch._utils import _rebuild_tensor_v2

    def rebuild(*args):
        return _rebuild_tensor_v2(*args).to(device)

    class _DeviceUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == ("torch._utils", "_rebuild_tensor_v2"):
                return rebuild
            return super().find_class(module, name)

    return _DeviceUnpickler(io.BytesIO(blob)).load()


def plane_device(device=None):
    """The plane's serving device: ``device`` as given, else the CUDA
    device (raises without one)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fleet plane: no CUDA device is available (pass "
            "plane_cfg={'device': 'cpu'} to serve on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def encode_plan_ship(fitted, plan) -> PlanShip:
    """Encode ``fitted`` (the pipeline ``plan`` was exported from) for
    shipping. Runs in the caller process (the process that fit the
    model). The weight slots are walked in the zoo's sorted
    deterministic order and split-plane encoded (per-tensor CRC); the
    receiving plane re-walks the unpickled skeleton in the same order,
    so slot ``i`` on both sides names the same weight."""
    from keystone_tpu_torch.serving.zoo import (
        _collect_weight_slots,
        _encode_tensor,
        _to_host,
    )

    slots = _collect_weight_slots(fitted.transformer_graph)
    tensors = [_encode_tensor(_to_host(a)) for (_op, _k, _i, a) in slots]
    return PlanShip(
        skeleton=_pickle_on_host(fitted),
        tensors=tensors,
        item_shape=plan.item_shape,
        dtype=str(plan.dtype),
        max_batch=plan.max_batch,
        buckets=plan.buckets,
        fingerprint=plan.fingerprint,
    )


def decode_plan_ship(ship: PlanShip, device=None):
    """Rebuild an :class:`ExportedPlan` on ``device`` (default: the CUDA
    device) from a ship, verifying every tensor CRC, the cross-channel
    bit-identity (split-plane tensors vs the skeleton's own slots) and
    the end-to-end ``plan_fingerprint``. Runs in the PLANE process.
    Raises :class:`ShipRejected` on any integrity failure — callers
    quarantine, never serve."""
    from keystone_tpu_torch.data.durable import ShardCorrupted
    from keystone_tpu_torch.serving.export import export_plan
    from keystone_tpu_torch.serving.zoo import (
        _collect_weight_slots,
        _decode_tensor,
        _restore_slot,
        _to_host,
        _upload,
    )

    device = plane_device(device)
    try:
        decoded = [
            _decode_tensor(t, faults.SITE_FLEET_RPC_SEND)
            for t in ship.tensors
        ]
    except ShardCorrupted as e:
        raise ShipRejected(f"weight plane CRC mismatch: {e}") from e
    fitted = _unpickle_onto(ship.skeleton, device)
    slots = _collect_weight_slots(fitted.transformer_graph)
    if len(slots) != len(decoded):
        raise ShipRejected(
            f"skeleton carries {len(slots)} weight slots, ship carries "
            f"{len(decoded)} tensors"
        )
    for ordinal, ((_op, k, _i, skel_val), arr) in enumerate(
        zip(slots, decoded)
    ):
        skel = _to_host(skel_val)
        if (skel.dtype != arr.dtype or skel.shape != arr.shape
                or skel.tobytes() != arr.tobytes()):
            raise ShipRejected(
                f"weight slot {ordinal} ({k}): split-plane channel "
                f"disagrees with skeleton channel — wire corruption "
                f"or tampering"
            )
    # The CRC'd split-plane copy is the authoritative one.
    restored = _upload(decoded, [s[3].dtype for s in slots], device)
    for (op, k, i, _skel), value in zip(slots, restored):
        _restore_slot(op, k, i, value)
    example = np.zeros(ship.item_shape, np.dtype(ship.dtype))
    plan = export_plan(
        fitted, example, max_batch=ship.max_batch,
        buckets=list(ship.buckets), device=device,
    )
    if plan.fingerprint != ship.fingerprint:
        raise ShipRejected(
            f"fingerprint mismatch: shipped {ship.fingerprint}, "
            f"rebuilt {plan.fingerprint}"
        )
    return plan


# ---------------------------------------------------------------------------
# The plane process
# ---------------------------------------------------------------------------


def _launches() -> Dict[str, int]:
    """This process's kernel launch counters."""
    from keystone_tpu_torch.ops import cuda_ops

    return dict(cuda_ops.launches)


def _device_memory(device) -> Dict[str, int]:
    """The caching allocator's allocated and reserved bytes on the
    plane's device (0 on the CPU)."""
    import torch

    if device is None or device.type != "cuda":
        return {"allocated": 0, "reserved": 0}
    return {"allocated": int(torch.cuda.memory_allocated(device)),
            "reserved": int(torch.cuda.memory_reserved(device))}


def _plane_handler(state: Dict[str, Any]):
    """Build the RPC handler closure over the plane's mutable state."""
    from keystone_tpu_torch.serving.batcher import (
        ServerClosed,
        ServerDegraded,
        ServerOverloaded,
    )

    def handler(req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pid": os.getpid(),
                    "quarantined": state["quarantined"] is not None}
        if op == "shutdown":
            state["shutdown"].set()
            return {"ok": True}
        if op == "stats":
            srv = state["server"]
            return {
                "ok": True,
                "quarantined": state["quarantined"],
                "fingerprint": state["fingerprint"],
                "stats": srv.stats() if srv is not None else {},
                "launches": _launches(),
                "device_memory": _device_memory(state["device"]),
                "boot": state["boot"],
            }
        if op == "submit":
            if state["quarantined"] is not None:
                return {"ok": False, "error": "quarantined",
                        "message": state["quarantined"]}
            deadline_ms = req.get("deadline_ms")
            timeout_s = (deadline_ms / 1e3 + state["grace_s"]
                         if deadline_ms is not None
                         else state["default_timeout_s"])
            t0 = time.perf_counter()
            try:
                fut = state["server"].submit(
                    req["x"], deadline_ms=deadline_ms
                )
                y = fut.result(timeout=timeout_s)
            except ServerOverloaded as e:
                return {"ok": False, "error": "overloaded",
                        "message": str(e)}
            except (ServerDegraded, ServerClosed) as e:
                return {"ok": False, "error": "degraded",
                        "message": f"{type(e).__name__}: {e}"}
            state["hist"].observe(time.perf_counter() - t0)
            return {"ok": True, "y": np.asarray(y),
                    "fingerprint": getattr(fut, "plan_fingerprint",
                                           state["fingerprint"])}
        if op == "offer":
            # Lifecycle roll across the fleet: decode the candidate
            # ship (same CRC + fingerprint verification as boot) and
            # run it through THIS plane's LifecycleController —
            # validation gate, single-replica canary, zero-drop
            # promotion — per process.
            if state["quarantined"] is not None:
                return {"ok": False, "error": "quarantined",
                        "message": state["quarantined"]}
            try:
                candidate = decode_plan_ship(req["ship"], state["device"])
            except ShipRejected as e:
                return {"ok": False, "error": "ship_rejected",
                        "message": str(e)}
            ctrl = state["lifecycle"]()
            result = ctrl.offer(candidate)
            if result.get("published"):
                state["fingerprint"] = result["fingerprint"]
            return {"ok": True, "result": result}
        return {"ok": False, "error": "unknown_op",
                "message": f"unknown op {op!r}"}

    return handler


def plane_main(name: str, conn, ship: PlanShip,
               cfg: Dict[str, Any]) -> None:
    """Child-process entry: decode the shipped plan (quarantine on any
    integrity failure), stand up the full per-process serving stack
    (:class:`ReplicatedServer` + latency histogram + ``LiveExporter``
    publishing ``/snapshot.json``), serve the fleet RPC until told to
    shut down. ``conn`` is the bootstrap pipe: exactly one dict with
    the ports/pid/quarantine verdict is sent, then it is closed.

    The boot's seconds by stage ride the bootstrap reply and every
    ``stats`` reply (``boot``): before this function ran (interpreter,
    the spawn's re-import of ``__main__``, the arguments; from the
    router's ``spawn_wall`` stamp), the imports, the device context, the
    plan (decode, checks, export with its captures) and the serving
    stack."""
    t_enter = time.time()
    boot: Dict[str, float] = {}
    if "spawn_wall" in cfg:
        boot["before_main"] = t_enter - float(cfg["spawn_wall"])
    t0 = time.perf_counter()
    # The parent's export verified this plan's graph, and the fingerprint
    # check below proves the plane rebuilt the same one, so the plane
    # skips the static verifier (whose first run imports torch._dynamo: 9 s
    # on an H100's host) unless the environment asks for it.
    os.environ.setdefault("KEYSTONE_VERIFY", "off")
    # Heavy imports here — this IS the device-owning process.
    import torch

    from keystone_tpu_torch.obs.live import LiveExporter
    from keystone_tpu_torch.obs.metrics import BucketedHistogram
    from keystone_tpu_torch.serving.batcher import frozen_heap
    from keystone_tpu_torch.serving.lifecycle import LifecycleController
    from keystone_tpu_torch.serving.replicas import ReplicatedServer

    boot["imports"] = time.perf_counter() - t0
    quarantined: Optional[str] = None
    plan = None
    device = None
    try:
        t0 = time.perf_counter()
        device = plane_device(cfg.get("device"))
        torch.zeros(1, device=device)  # the device context
        boot["context"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = decode_plan_ship(ship, device)
        boot["plan"] = time.perf_counter() - t0
    except ShipRejected as e:
        quarantined = str(e)
        logger.warning(
            "fleet plane %s QUARANTINED on arrival: %s", name, e
        )
    except Exception as e:  # noqa: BLE001 — quarantine, never serve
        quarantined = f"{type(e).__name__}: {e}"
        logger.warning(
            "fleet plane %s QUARANTINED (decode error): %r", name, e
        )

    t0 = time.perf_counter()
    server = None
    if quarantined is None:
        server = ReplicatedServer(
            plan,
            num_replicas=int(cfg.get("replicas", 2)),
            max_wait_ms=float(cfg.get("max_wait_ms", 2.0)),
            max_queue_depth=int(cfg.get("max_queue_depth", 1024)),
            restart_budget=int(cfg.get("replica_restart_budget", 3)),
            watchdog_interval_s=float(
                cfg.get("watchdog_interval_s", 0.02)
            ),
        )

    hist = BucketedHistogram()
    state: Dict[str, Any] = {
        "server": server,
        "hist": hist,
        "device": device,
        "quarantined": quarantined,
        "fingerprint": ship.fingerprint,
        "shutdown": threading.Event(),
        "grace_s": float(cfg.get("deadline_grace_s", 5.0)),
        "default_timeout_s": float(cfg.get("default_timeout_s", 30.0)),
        "boot": boot,
    }

    _lc_lock = threading.Lock()
    _lc: List[Any] = []

    def _lifecycle() -> LifecycleController:
        with _lc_lock:
            if not _lc:
                _lc.append(LifecycleController(
                    server, plan,
                    canary_sustain_s=float(
                        cfg.get("canary_sustain_s", 0.5)
                    ),
                    canary_min_samples=int(
                        cfg.get("canary_min_samples", 5)
                    ),
                ))
            return _lc[0]

    state["lifecycle"] = _lifecycle

    def _export_stats() -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "pid": os.getpid(),
            "name": name,
            "quarantined": state["quarantined"],
            "fingerprint": state["fingerprint"],
            "latency_hist": hist.state_dict(),
            "launches": _launches(),
        }
        srv = state["server"]
        if srv is not None:
            doc["server"] = srv.stats()
        return doc

    exporter = LiveExporter(
        {"fleet_plane": _export_stats},
        port=0,
        interval_s=float(cfg.get("metrics_interval_s", 0.25)),
    )
    rpc = RpcServer(_plane_handler(state))
    try:
        # This process owns its heap: serve with it frozen (C.14).
        with frozen_heap():
            boot["serve"] = time.perf_counter() - t0
            conn.send({
                "rpc_port": rpc.port,
                "metrics_port": exporter.port,
                "pid": os.getpid(),
                "quarantined": quarantined,
                "fingerprint": ship.fingerprint,
            })
            conn.close()
            state["shutdown"].wait()
    finally:
        rpc.close()
        exporter.close()
        if server is not None:
            server.close()
