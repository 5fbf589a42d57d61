"""The port's fleet building blocks on the CPU, no subprocesses
(``keystone_tpu_torch/serving/fleet_rpc.py``, the histogram's
cross-process state, the plan-ship codec's tensors):

  - the reference's 13 cases of ``tests/test_fleet_unit.py`` on the port:
    the RPC frame codec (magic / length / CRC — a corrupt frame NEVER
    yields an object), the client's at-most-once retry discipline around
    the ``fleet.rpc.send`` fault site, and the histogram state round trip
    (``state_dict`` / ``merge_state`` merge EXACTLY — the fleet p99 merge
    property);
  - against the reference: a frame written by either package's
    ``send_frame`` is read by the other's ``recv_frame`` and the bytes on
    the wire are the same for the same payload; for the same numpy
    weights (carried across with ``interop``) the port's ship tensors
    are the reference's hi / lo planes and CRCs slot for slot;
  - the router and the RPC name ``torch`` at no scope (their syntax
    trees), and the plane module imports it inside functions only.

The multi-process scenarios live in ``tests/test_torch_chaos_fleet.py``.
"""

import ast
import os
import pickle
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from keystone_tpu_torch.obs.metrics import BucketedHistogram
from keystone_tpu_torch.serving.fleet_rpc import (
    MAGIC,
    MAX_FRAME_BYTES,
    FrameCorrupted,
    RpcClient,
    RpcServer,
    recv_frame,
    send_frame,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule

SERVING = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "keystone_tpu_torch", "serving")


def _pair():
    a, b = socket.socketpair()
    return a, b


class TestFrameCodec:
    def test_round_trip(self):
        a, b = _pair()
        try:
            obj = {"op": "submit", "x": np.arange(5, dtype=np.float32),
                   "deadline_ms": 12.5}
            send_frame(a, obj)
            got = recv_frame(b, timeout_s=5.0)
            assert got["op"] == "submit"
            assert got["deadline_ms"] == 12.5
            np.testing.assert_array_equal(got["x"], obj["x"])
        finally:
            a.close()
            b.close()

    def test_payload_corruption_raises_never_yields(self):
        """Flip ONE payload byte in transit: the CRC must reject the
        frame — a corrupt object must never come out of recv_frame."""
        a, b = _pair()
        try:
            payload = pickle.dumps({"op": "ping"}, protocol=4)
            header = struct.Struct("!4sII").pack(
                MAGIC, len(payload), zlib.crc32(payload)
            )
            tampered = bytearray(payload)
            tampered[0] ^= 0x40
            a.sendall(header + bytes(tampered))
            with pytest.raises(FrameCorrupted, match="CRC"):
                recv_frame(b, timeout_s=5.0)
        finally:
            a.close()
            b.close()

    def test_bad_magic_raises(self):
        a, b = _pair()
        try:
            a.sendall(b"NOPE" + b"\x00" * 8)
            with pytest.raises(FrameCorrupted, match="magic"):
                recv_frame(b, timeout_s=5.0)
        finally:
            a.close()
            b.close()

    def test_length_bound_rejected_before_allocation(self):
        """A corrupt length field must be rejected by the bound check,
        not trusted into a giant allocation."""
        a, b = _pair()
        try:
            a.sendall(struct.Struct("!4sII").pack(
                MAGIC, MAX_FRAME_BYTES + 1, 0
            ))
            with pytest.raises(FrameCorrupted, match="bound"):
                recv_frame(b, timeout_s=5.0)
        finally:
            a.close()
            b.close()

    def test_peer_close_mid_frame_is_connection_error(self):
        a, b = _pair()
        try:
            a.sendall(MAGIC)  # header cut short
            a.close()
            with pytest.raises(ConnectionError, match="mid-frame"):
                recv_frame(b, timeout_s=5.0)
        finally:
            b.close()


class TestRpcServerClient:
    def test_round_trip_and_handler_error_is_named(self):
        calls = []

        def handler(req):
            calls.append(req["op"])
            if req["op"] == "boom":
                raise ValueError("kaboom")
            return {"ok": True, "echo": req["op"]}

        with RpcServer(handler) as srv, \
                RpcClient("127.0.0.1", srv.port) as cli:
            assert cli.request({"op": "hi"}, timeout_s=10.0) == {
                "ok": True, "echo": "hi"
            }
            # A handler exception is a NAMED error reply; the
            # connection (and the server) survive it.
            resp = cli.request({"op": "boom"}, timeout_s=10.0)
            assert resp["ok"] is False
            assert resp["error"] == "handler_error"
            assert "kaboom" in resp["message"]
            assert cli.request({"op": "hi"}, timeout_s=10.0)["ok"]
        assert calls == ["hi", "boom", "hi"]

    def test_concurrent_requests_multiplex(self):
        barrier = threading.Barrier(4)

        def handler(req):
            barrier.wait(timeout=10.0)  # all 4 in flight at once
            return {"ok": True, "i": req["i"]}

        with RpcServer(handler) as srv, \
                RpcClient("127.0.0.1", srv.port) as cli:
            out = [None] * 4

            def call(i):
                out[i] = cli.request({"i": i}, timeout_s=10.0)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=15.0)
            assert [r["i"] for r in out] == [0, 1, 2, 3]

    def test_injected_send_fault_is_absorbed_by_paced_retry(self):
        """An error rule at ``fleet.rpc.send`` fires BEFORE any bytes hit
        the wire, so the client's bounded paced retries absorb it — the
        request still completes, and the site counter proves the fault
        actually fired."""
        def handler(req):
            return {"ok": True}

        plan = FaultPlan([
            FaultRule("fleet.rpc.send", "error", calls=[0]),
        ])
        with RpcServer(handler) as srv, \
                RpcClient("127.0.0.1", srv.port,
                          retry_base_delay_s=0.001) as cli:
            with plan:
                assert cli.request({"op": "hi"}, timeout_s=10.0)["ok"]
            assert plan.calls_seen("fleet.rpc.send") == 2  # fault + retry

    def test_send_fault_exhaustion_raises_named(self):
        def handler(req):  # pragma: no cover - never reached
            return {"ok": True}

        plan = FaultPlan([
            FaultRule("fleet.rpc.send", "error", p=1.0),
        ])
        with RpcServer(handler) as srv, \
                RpcClient("127.0.0.1", srv.port, send_retries=2,
                          retry_base_delay_s=0.001) as cli:
            with plan, pytest.raises(OSError):
                cli.request({"op": "hi"}, timeout_s=10.0)
            # Initial attempt + 2 retries, all pre-write.
            assert plan.calls_seen("fleet.rpc.send") == 3


class TestHistogramStateMerge:
    def test_state_round_trip_is_exact(self):
        rng = np.random.default_rng(7)
        h = BucketedHistogram()
        for v in rng.lognormal(-3.0, 1.0, size=500):
            h.observe(float(v))
        h2 = BucketedHistogram.from_state(h.state_dict())
        assert h2.count == h.count
        assert h2.total == h.total
        for q in (50.0, 90.0, 99.0):
            assert h2.percentile(q) == h.percentile(q)

    def test_cross_process_merge_matches_single_histogram(self):
        """The fleet p99 merge property: per-plane states merged at the
        router equal ONE histogram that saw every observation — counts
        add exactly, so any percentile agrees bucket-for-bucket."""
        rng = np.random.default_rng(11)
        whole = BucketedHistogram()
        parts = [BucketedHistogram() for _ in range(4)]
        for i, v in enumerate(rng.lognormal(-3.5, 0.8, size=800)):
            whole.observe(float(v))
            parts[i % 4].observe(float(v))
        merged = BucketedHistogram()
        for p in parts:
            # The wire form: what each plane publishes in its exporter
            # snapshot and the router folds in.
            merged.merge_state(p.state_dict())
        assert merged.count == whole.count
        assert merged.total == pytest.approx(whole.total)
        for q in (50.0, 95.0, 99.0, 99.9):
            assert merged.percentile(q) == whole.percentile(q)

    def test_geometry_mismatch_is_loud(self):
        h = BucketedHistogram()
        state = h.state_dict()
        state["geometry"] = {"lo": 1e-5, "growth": 2.0}
        with pytest.raises(ValueError, match="geometry"):
            BucketedHistogram().merge_state(state)

    def test_empty_state_merges_as_noop(self):
        h = BucketedHistogram()
        h.observe(0.25)
        h.merge_state(BucketedHistogram().state_dict())
        assert h.count == 1
        assert h.percentile(99.0) == pytest.approx(0.25, rel=0.1)


class _Capture:
    """A socket stand-in that keeps what ``sendall`` is given."""

    def __init__(self):
        self.data = b""

    def sendall(self, data):
        self.data += data


class TestAgainstReference:
    PAYLOADS = [
        {"op": "ping"},
        {"op": "submit", "x": np.arange(440, dtype=np.float32) / 7.0,
         "deadline_ms": 25.0, "tenant": "t3"},
        {"ok": False, "error": "quarantined", "message": "weight plane CRC mismatch"},
    ]

    @pytest.mark.parametrize("payload", PAYLOADS, ids=["ping", "submit", "refusal"])
    def test_frames_cross_both_ways_with_the_same_bytes(self, payload):
        from keystone_tpu.serving import fleet_rpc as j_rpc

        port_wire, ref_wire = _Capture(), _Capture()
        send_frame(port_wire, payload)
        j_rpc.send_frame(ref_wire, payload)
        assert port_wire.data == ref_wire.data
        # The port's bound is wider (a TIMIT canary's 77 MB ship), so every
        # frame the reference accepts, the port accepts.
        assert MAGIC == j_rpc.MAGIC and MAX_FRAME_BYTES >= j_rpc.MAX_FRAME_BYTES
        for write, read in ((send_frame, j_rpc.recv_frame),
                            (j_rpc.send_frame, recv_frame)):
            a, b = _pair()
            try:
                write(a, payload)
                got = read(b, timeout_s=5.0)
            finally:
                a.close()
                b.close()
            assert pickle.dumps(got, protocol=4) == pickle.dumps(payload, protocol=4)

    def test_a_corrupt_reference_frame_is_refused_by_the_port(self):
        from keystone_tpu.serving import fleet_rpc as j_rpc

        wire = _Capture()
        j_rpc.send_frame(wire, {"op": "ping"})
        tampered = bytearray(wire.data)
        tampered[-1] ^= 0x01
        a, b = _pair()
        try:
            a.sendall(bytes(tampered))
            with pytest.raises(FrameCorrupted, match="CRC"):
                recv_frame(b, timeout_s=5.0)
        finally:
            a.close()
            b.close()

    def test_ship_tensors_are_the_references_slot_for_slot(self):
        """The same fitted weights encoded for shipping by both packages:
        both walk the fitted (unfused) graph's slots in the same order,
        and every slot has the reference's hi / lo planes, CRC and byte
        count."""
        from keystone_tpu.serving import export_plan as j_export
        from keystone_tpu.serving.fleet_plane import encode_plan_ship as j_encode
        from keystone_tpu.serving.zoo import _collect_weight_slots as j_slots

        from keystone_tpu_torch.serving import export_plan
        from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship
        from keystone_tpu_torch.serving.zoo import _collect_weight_slots
        from tests._torch_serving_util import TINY_D_IN, reference_tiny_mnist

        j_fitted, t_fitted, _X = reference_tiny_mnist(seed=0)
        example = np.zeros(TINY_D_IN, np.float32)
        j_ship = j_encode(j_fitted, j_export(j_fitted, example, max_batch=8))
        t_ship = encode_plan_ship(t_fitted, export_plan(t_fitted, example, max_batch=8))

        def keys(slots):
            return [(type(op).__name__, k, i) for op, k, i, _ in slots]

        assert keys(_collect_weight_slots(t_fitted.transformer_graph)) == keys(
            j_slots(j_fitted.transformer_graph))
        assert len(t_ship.tensors) == len(j_ship.tensors) == 4
        for tt, jt in zip(t_ship.tensors, j_ship.tensors):
            for plane in ("hi", "lo", "raw"):
                a, b = getattr(tt, plane), getattr(jt, plane)
                assert (a is None) == (b is None), plane
                if a is not None:
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), plane
            assert (tt.crc, tt.algo, tt.nbytes, tt.shape) == (jt.crc, jt.algo, jt.nbytes,
                                                               jt.shape)
        assert (t_ship.item_shape, t_ship.dtype, t_ship.max_batch, t_ship.buckets) == (
            j_ship.item_shape, j_ship.dtype, j_ship.max_batch, j_ship.buckets)

def _torch_names(path):
    """Every place a module's syntax tree names ``torch``: imports of it
    (at any scope) and the bare name."""
    tree = ast.parse(open(path).read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] == "torch"]
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                found.append(node.module)
        elif isinstance(node, ast.Name) and node.id == "torch":
            found.append("torch")
        elif isinstance(node, ast.Attribute) and node.attr == "torch":
            found.append("torch")
    return found


class TestTorchFreeModules:
    @pytest.mark.parametrize("name", ["fleet.py", "fleet_rpc.py"])
    def test_router_and_rpc_name_no_torch(self, name):
        assert _torch_names(os.path.join(SERVING, name)) == []

    def test_plane_imports_torch_inside_functions_only(self):
        tree = ast.parse(open(os.path.join(SERVING, "fleet_plane.py")).read())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top for a in n.names] + [
            n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not any((x or "").split(".")[0] == "torch" for x in names)
        assert _torch_names(os.path.join(SERVING, "fleet_plane.py"))  # inside functions
