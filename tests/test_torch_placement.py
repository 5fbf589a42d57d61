"""The control-plane pieces ``run.py learn`` stands on, in the port and
against the reference: the placement engine (``placement/engine.py``:
winners, fallbacks, audits, its ``placement.decision`` events, flight
notes and counters), the data-plane runtime (``data/runtime.py``: the
reference's ``TestRuntimeCore`` cases), and the checkpoint half of
``data/durable.py`` (``atomic_write_json``, ``CheckpointSpec``,
``resolve_checkpoint``: each package reads what the other writes), with
the ``--checkpoint-dir`` flag and the segmented streamed fit it insures.

The reference resolves its weight family from ``KEYSTONE_COST_WEIGHTS``
(``tpu`` by default); the port has one, ``ec2``, so the comparisons set
``KEYSTONE_COST_WEIGHTS=ec2`` for the reference.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data.durable import (
    CheckpointSpec,
    ShardCorrupted,
    atomic_write_json,
    resolve_checkpoint,
)
from keystone_tpu_torch.data.runtime import DataPlaneRuntime, default_runtime
from keystone_tpu_torch.ops.learning import cost
from keystone_tpu_torch.placement import (
    ALL_KINDS,
    KIND_LIFECYCLE,
    KIND_REPLICAS,
    KIND_SOLVER,
    PLACEMENT_EVENT,
    PlacementEngine,
    active_family,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule

INF = float("inf")

# Decisions both engines make: (kind, candidates, fallback).
DECISIONS = [
    (KIND_SOLVER, [{"label": "exact", "cost_s": 3.0, "resident_bytes": 10},
                   {"label": "block", "cost_s": 1.5, "resident_bytes": 30},
                   {"label": "lbfgs", "cost_s": 1.5, "resident_bytes": 5}], None),
    (KIND_SOLVER, [{"label": "exact", "cost_s": INF, "resident_bytes": 40},
                   {"label": "block", "cost_s": None, "resident_bytes": 20},
                   {"label": "lbfgs", "cost_s": INF, "resident_bytes": 20}],
     "least_resident"),
    (KIND_REPLICAS, [{"label": "2", "cost_s": 0.25}, {"label": "3", "cost_s": 0.125},
                     {"label": "4", "cost_s": 0.125, "feasible": False}], None),
]


@pytest.fixture
def ec2_weights(monkeypatch):
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")


def _placement_events(tracer):
    return [e["args"] for e in tracer.events if e.get("name") == PLACEMENT_EVENT]


class TestPlacementEngine:
    def test_first_minimum_wins(self):
        choice = PlacementEngine().decide(*DECISIONS[0][:2])
        assert (choice.winner, choice.index, choice.reason) == ("block", 1, "argmin")

    def test_all_infeasible_falls_back_to_least_resident_or_raises(self):
        engine = PlacementEngine()
        choice = engine.decide(*DECISIONS[1][:2], fallback="least_resident")
        assert (choice.winner, choice.reason) == ("block", "least_resident_fallback")
        with pytest.raises(ValueError, match="every candidate infeasible: exact, block"):
            engine.decide(*DECISIONS[1][:2])
        with pytest.raises(ValueError, match="no candidates"):
            engine.decide(KIND_SOLVER, [])

    def test_family_is_the_cost_models(self):
        assert active_family() == cost.weights_family_name() == "ec2"
        assert PlacementEngine().weights_family == "ec2"
        assert PlacementEngine(weights_family="custom").weights_family == "custom"

    def test_prices_page_in_and_queue_residence_with_the_ec2_weights(self):
        _, mem_w, _ = cost.active_weights()
        assert PlacementEngine().price_page_in(1000) == pytest.approx(
            mem_w * cost.zoo_page_overhead() * 1000)
        assert PlacementEngine.price_queue_residence(6, 2, 4, 0.5) == 1.0
        assert PlacementEngine.price_queue_residence(-3, 0, 0, 0.5) == 0.0

    def test_events_counters_and_flight_notes(self):
        reg = obs.MetricsRegistry()
        engine = PlacementEngine(metrics=reg)
        with obs.tracing() as tracer:
            choice = engine.decide(*DECISIONS[1][:2], fallback="least_resident",
                                   context={"site": "test"})
            ref = engine.audit(KIND_LIFECYCLE, "fp1", [{"label": "fp1", "cost_s": None}],
                               reason="gate")
            (first, second) = _placement_events(tracer)
        assert choice.ref is not None and ref is not None
        assert first["decision"] == KIND_SOLVER and first["site"] == "test"
        assert [c["cost_s"] for c in first["candidates"]] == [None, None, None]
        assert [c["feasible"] for c in first["candidates"]] == [False] * 3
        assert second["winner"] == "fp1" and second["reason"] == "gate"
        snap = reg.snapshot()
        assert snap["placement.decisions"] == 2 and snap["placement.infeasible_candidates"] == 4
        notes = [e for e in obs.flight_snapshot() if e.get("kind") == "placement"]
        assert notes and notes[-1]["name"] == KIND_LIFECYCLE

    def test_no_tracer_no_ref(self):
        assert PlacementEngine().decide(*DECISIONS[0][:2]).ref is None

    def test_kinds_match_the_reference(self):
        from keystone_tpu import placement as j_placement

        assert ALL_KINDS == j_placement.ALL_KINDS
        assert PLACEMENT_EVENT == j_placement.PLACEMENT_EVENT

    @pytest.mark.parametrize("case", range(len(DECISIONS)))
    def test_winners_and_events_match_the_reference(self, ec2_weights, case):
        from keystone_tpu import obs as j_obs
        from keystone_tpu.placement import PlacementEngine as JEngine

        kind, candidates, fallback = DECISIONS[case]
        with obs.tracing() as tracer:
            choice = PlacementEngine().decide(kind, candidates, fallback=fallback,
                                              context={"n": 7})
            PlacementEngine().audit(kind, "x", candidates, reason="policy")
            events = _placement_events(tracer)
        with j_obs.tracing() as j_tracer:
            j_choice = JEngine().decide(kind, candidates, fallback=fallback, context={"n": 7})
            JEngine().audit(kind, "x", candidates, reason="policy")
            j_events = [e["args"] for e in j_tracer.events if e.get("name") == PLACEMENT_EVENT]
        assert (choice.winner, choice.index, choice.reason) == (
            j_choice.winner, j_choice.index, j_choice.reason)
        assert events == j_events


class TestDataPlaneRuntime:
    """The reference's ``tests/test_runtime.py::TestRuntimeCore``."""

    def test_submit_returns_result_through_future(self):
        with DataPlaneRuntime() as rt:
            fut = rt.submit("read", lambda a, b: a + b, 2, 3)
            assert fut.result(timeout=10) == 5

    def test_errors_deliver_through_future_never_kill_worker(self):
        with DataPlaneRuntime() as rt:
            def boom():
                raise OSError("disk gone")

            with pytest.raises(OSError, match="disk gone"):
                rt.submit("read", boom).result(timeout=10)
            assert rt.submit("read", lambda: 42).result(timeout=10) == 42
            assert rt.stats()["read"]["errors"] == 1

    def test_per_lane_fifo_ordering(self):
        order = []
        with DataPlaneRuntime() as rt:
            def slowpoke(i):
                time.sleep(0.01)
                order.append(i)
                return i

            futs = [rt.submit("read", slowpoke, i) for i in range(8)]
            assert [f.result(timeout=10) for f in futs] == list(range(8))
        assert order == list(range(8))

    def test_distinct_lanes_run_concurrently(self):
        gate = threading.Event()
        with DataPlaneRuntime() as rt:
            blocked = rt.submit("read", gate.wait, 10.0)
            assert rt.submit("checkpoint", lambda: 7).result(timeout=5) == 7
            gate.set()
            assert blocked.result(timeout=5)

    def test_worker_threads_named_and_joined_on_close(self):
        def io_threads():
            return [t for t in threading.enumerate() if t.name.startswith("keystone-io-")]

        before = set(io_threads())
        rt = DataPlaneRuntime()
        rt.submit("read", lambda: None).result(timeout=10)
        rt.submit("checkpoint", lambda: None).result(timeout=10)
        ours = set(io_threads()) - before
        assert {t.name for t in ours} == {"keystone-io-read", "keystone-io-checkpoint"}
        rt.close()
        assert not (set(io_threads()) - before)
        assert rt.closed
        rt.close()

    def test_close_cancels_queued_tasks_and_refuses_new_ones(self):
        rt = DataPlaneRuntime()
        gate = threading.Event()
        started = threading.Event()
        ran = []

        def inflight():
            started.set()
            return gate.wait(10.0)

        blocked = rt.submit("read", inflight)
        queued = rt.submit("read", lambda: ran.append(1))
        assert started.wait(timeout=10)
        closer = threading.Thread(target=rt.close)
        closer.start()
        deadline = time.monotonic() + 10.0
        while not queued.cancelled() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert queued.cancelled()
        gate.set()
        closer.join(timeout=10)
        assert not closer.is_alive()
        assert blocked.result(timeout=5)
        assert queued.cancelled() and not ran
        with pytest.raises(RuntimeError, match="closed"):
            rt.submit("read", lambda: None)

    def test_flush_is_a_fifo_barrier(self):
        done = []
        with DataPlaneRuntime() as rt:
            for i in range(5):
                rt.submit("read", lambda i=i: done.append(i))
            rt.flush("read")
            assert done == list(range(5))

    def test_stats_account_busy_time_per_lane(self):
        with DataPlaneRuntime() as rt:
            rt.submit("read", time.sleep, 0.05).result(timeout=10)
            s = rt.stats()["read"]
            assert s["tasks"] == 1 and s["busy_s"] >= 0.05

    def test_default_runtime_is_shared_and_replaced_after_close(self):
        rt = default_runtime()
        assert default_runtime() is rt
        rt.close()
        rt2 = default_runtime()
        assert rt2 is not rt and not rt2.closed


FINGERPRINT = {"fit": "continuous_linear", "d": 8, "k": 3, "lam": 0.001,
               "source": "continuous", "num_segments": 6}


def _carry(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(8, 8)), rng.normal(size=(8, 3)).astype(np.float32),
            np.array([42.0])]


class TestCheckpoints:
    def test_atomic_json_matches_the_reference(self, tmp_path):
        from keystone_tpu.data.durable import atomic_write_json as j_write

        obj = {"a": [1, 2.5, None], "b": "x"}
        atomic_write_json(str(tmp_path / "p.json"), obj)
        j_write(str(tmp_path / "r.json"), obj)
        assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
        assert sorted(os.listdir(tmp_path)) == ["p.json", "r.json"]  # no temp left

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_round_trip_across_packages(self, tmp_path, writer):
        from keystone_tpu.data.durable import CheckpointSpec as JSpec

        port, ref = CheckpointSpec(str(tmp_path), runtime=False), JSpec(str(tmp_path),
                                                                        runtime=False)
        w, r = (port, ref) if writer == "port" else (ref, port)
        arrays = _carry()
        w.save(arrays, 4, FINGERPRINT)
        assert port._fit_dir(FINGERPRINT) == ref._fit_dir(FINGERPRINT)
        got, cursor = r.load(FINGERPRINT)
        assert cursor == 4
        for a, b in zip(got, arrays):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert r.load(dict(FINGERPRINT, lam=0.01)) is None
        assert port.restore(dict(FINGERPRINT, d=9)) == (None, 0)

    def test_tensor_carry_saves_its_host_copy(self, tmp_path):
        spec = CheckpointSpec(str(tmp_path), runtime=False)
        G = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        spec.save([G], 1, FINGERPRINT)
        (got,), _ = spec.load(FINGERPRINT)
        assert np.array_equal(got, G.numpy())

    def test_write_behind_snapshot_owns_its_bytes(self, tmp_path):
        spec = CheckpointSpec(str(tmp_path), every_segments=2)
        G = np.ones((3, 3))
        assert not spec.maybe_save([G], 0, 6, FINGERPRINT)  # off the cadence
        assert spec.maybe_save([G], 1, 6, FINGERPRINT)
        G += 1.0  # the fold moves on before the write lands
        assert not spec.maybe_save([G], 5, 6, FINGERPRINT)  # final segment: no snapshot
        (got,), cursor = spec.load(FINGERPRINT)
        assert cursor == 2 and np.array_equal(got, np.ones((3, 3)))
        assert spec.has_snapshot() and spec.has_snapshot(FINGERPRINT)
        spec.clear(FINGERPRINT)
        assert not spec.has_snapshot()
        assert not os.path.exists(spec._fit_dir(FINGERPRINT))

    def test_only_the_latest_snapshot_is_kept(self, tmp_path):
        spec = CheckpointSpec(str(tmp_path), runtime=False)
        for cursor in (2, 4, 6):
            spec.save(_carry(cursor), cursor, FINGERPRINT)
        files = sorted(os.listdir(spec._fit_dir(FINGERPRINT)))
        assert files == ["carry-6.bin", "checkpoint.json"]
        other = dict(FINGERPRINT, source="other")
        spec.save(_carry(), 2, other)
        spec.clear(FINGERPRINT)  # the other fit keeps its snapshot
        assert spec.has_snapshot(other) and not spec.has_snapshot(FINGERPRINT)

    def test_corrupt_carry_raises(self, tmp_path):
        spec = CheckpointSpec(str(tmp_path), runtime=False)
        spec.save(_carry(), 2, FINGERPRINT)
        data = os.path.join(spec._fit_dir(FINGERPRINT), "carry-2.bin")
        blob = bytearray(open(data, "rb").read())
        blob[3] ^= 0xFF
        open(data, "wb").write(bytes(blob))
        with pytest.raises(ShardCorrupted, match="checksum mismatch"):
            spec.load(FINGERPRINT)

    def test_async_write_failure_surfaces_at_flush(self, tmp_path):
        spec = CheckpointSpec(str(tmp_path), every_segments=1)
        with FaultPlan([FaultRule("checkpoint.write", calls=[0], exc="OSError")]).active():
            assert spec.maybe_save(_carry(), 0, 4, FINGERPRINT)
            with pytest.raises(OSError):
                spec.flush()
        assert not spec.has_snapshot()

    def test_resolve_checkpoint_matches_the_reference(self, tmp_path, monkeypatch):
        from keystone_tpu.data.durable import resolve_checkpoint as j_resolve

        monkeypatch.delenv("KEYSTONE_CHECKPOINT_DIR", raising=False)
        assert resolve_checkpoint(None) is None and j_resolve(None) is None
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_DIR", str(tmp_path))
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_EVERY", "3")
        for arg in (None, str(tmp_path / "x")):
            spec, j_spec = resolve_checkpoint(arg), j_resolve(arg)
            assert (spec.directory, spec.every_segments) == (j_spec.directory,
                                                             j_spec.every_segments)
        spec = CheckpointSpec(str(tmp_path), every_segments=5)
        assert resolve_checkpoint(spec) is spec

    def test_checkpoint_dir_flag_sets_the_variable(self, monkeypatch, tmp_path):
        from keystone_tpu_torch import run

        monkeypatch.setenv("KEYSTONE_CHECKPOINT_DIR", "")  # the flag's write is undone
        rest = run._extract_global_flags([f"--checkpoint-dir={tmp_path}", "learn", "--seed", "1"])
        assert rest == ["learn", "--seed", "1"]
        assert os.environ["KEYSTONE_CHECKPOINT_DIR"] == str(tmp_path)

    def test_segmented_sparse_fold_refuses_an_unhonoured_checkpoint_dir(self, monkeypatch,
                                                                        tmp_path):
        from keystone_tpu_torch.ops.learning.lbfgs import run_lbfgs_gram_streamed

        def chunk(cid):
            idx = torch.tensor([[0, 1], [1, 2]])
            val = torch.ones(2, 2)
            return idx, val, torch.ones(2, 1)

        monkeypatch.setenv("KEYSTONE_CHECKPOINT_DIR", str(tmp_path))
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_EVERY", "1")
        # The variable is honoured now: the segmented fold snapshots its
        # carry there (a killed one resumes: tests/test_torch_outofcore.py)
        # and clears the snapshot when it completes.
        W1, _ = run_lbfgs_gram_streamed(chunk, 4, 3, 1, lam=1e-2, num_iterations=3, n=8,
                                        max_chunks_per_dispatch=2)
        # Unsegmented, the reference does not checkpoint either: it runs.
        W, _ = run_lbfgs_gram_streamed(chunk, 4, 3, 1, lam=1e-2, num_iterations=3, n=8)
        monkeypatch.delenv("KEYSTONE_CHECKPOINT_DIR")
        W2, _ = run_lbfgs_gram_streamed(chunk, 4, 3, 1, lam=1e-2, num_iterations=3, n=8,
                                        max_chunks_per_dispatch=2)
        assert torch.equal(W, W2) and torch.equal(W1, W2)
        assert json.dumps(os.listdir(tmp_path)) == "[]"
