"""Card-only cases of the port's serving path: bucket programs captured as
CUDA graphs at export, the warm path never capturing, launch counts across
replays, two replicas hammering one captured bucket, a failed capture,
the fingerprints of CUDA tensors, captures that garbage collection cannot
break, the model zoo's page round trip
(memory freed, bits and launches kept) and a page-in captured while another
tenant replays, and the process fleet on the card (two plane processes
serving every bucket bit-equal to the parent's plan, each launching the
kernels; a SIGKILLed plane's device memory returned after the respawn).

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one. The file imports neither JAX nor the JAX package, so that it runs on
the machine with the card: ``python -m pytest
tests/test_torch_serving_cuda.py -m cuda --noconftest``.

Tolerances: a replayed bucket equals its eager first run bit for bit (the
same kernels on the same inputs); served rows of the small cosine plan
equal the walked pipeline's batch apply bit for bit (its products are
row-stable: ``cuda_ops.row_stable_matmul``, ROADMAP C.8); the MNIST plan's
against its walked pipeline 1e-6 relative (the fused plan and the walked
nodes compose the FFT featurizer differently).
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.durable import fingerprint_token
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.serving import MicroBatchServer, ReplicatedServer, export_plan
from keystone_tpu_torch.serving.export import ExportedPlan

# The shared fixtures by file, not as ``tests._torch_serving_util``: run
# with --noconftest on the card's machine, ``tests`` may name another
# installed package.
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_serving_util import (  # noqa: E402
    TINY_D_IN,
    CallCountingScale,
    fit_tiny_mnist,
    fitted_from_transformer,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


def _cosine_plan(device, max_batch=16, seed=0):
    """A fitted cosine featurizer -> LinearMapper on the card, exported."""
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures
    from keystone_tpu_torch.workflow import PipelineEnv

    PipelineEnv.get_or_create().reset()
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(256, 24)).astype(np.float32)).to(device)
    Y = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32)).to(device)
    crf = CosineRandomFeatures(24, 64, 0.3, seed=seed, device=device)
    fitted = crf.to_pipeline().and_then(LinearMapEstimator(lam=1e-2), Dataset(X),
                                        Dataset(Y)).fit()
    PipelineEnv.get_or_create().reset()
    plan = export_plan(fitted, np.zeros(24, np.float32), max_batch=max_batch)
    return fitted, plan, X.cpu().numpy()


@pytest.mark.cuda
class TestBucketGraphs:
    def test_every_bucket_captured_once_replays_never_capture(self, cuda_device):
        t = CallCountingScale()
        plan = export_plan(fitted_from_transformer(t), np.zeros(6, np.float32),
                           max_batch=16, device=cuda_device)
        assert plan.compiled and plan.trace_count == len(plan.buckets) == 4
        # The verifier's meta run, then an eager run and a capture a bucket.
        assert t.calls == 1 + 2 * 4
        rng = np.random.default_rng(0)
        for m in (1, 3, 4, 5, 11, 16, 2, 7):
            X = rng.normal(size=(m, 6)).astype(np.float32)
            np.testing.assert_array_equal(plan.apply_batch(list(X)), X * 2.0)
        assert t.calls == 9 and plan.trace_count == 4
        assert sum(plan.replays.values()) == 8

    def test_launches_counted_a_replay(self, cuda_device):
        _, plan, X = _cosine_plan(cuda_device)
        assert plan.launches_per_replay == {
            b: {"cosine_features": 1, "row_stable_matmul": 1} for b in plan.buckets}
        cuda_ops.reset_launch_counts()
        for m in (1, 5, 16):
            plan.apply_batch(list(X[:m]))
        assert cuda_ops.launches["cosine_features"] == 3
        assert cuda_ops.launches["row_stable_matmul"] == 3

    def test_replay_equals_eager_bits(self, cuda_device):
        _, plan, X = _cosine_plan(cuda_device)
        for b in plan.buckets:
            got = plan.apply_padded(X[:b])
            want = plan._composed(torch.from_numpy(X[:b]).to(cuda_device)).cpu().numpy()
            np.testing.assert_array_equal(got, want)

    def test_mnist_plan_captures_the_fft_gather(self, cuda_device):
        fitted, _ = fit_tiny_mnist(device=cuda_device)
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        assert plan.compiled and len(plan.graph.nodes) == 1
        assert plan.device.type == "cuda" and len(plan.launches_per_replay) == 3
        X = np.random.default_rng(1).normal(size=(7, TINY_D_IN)).astype(np.float32)
        got = plan.apply_batch(list(X))
        want = fitted.apply(Dataset(torch.from_numpy(X).to(cuda_device))).array.cpu().numpy()
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)

    def test_failed_capture_raises_and_restores_the_card(self, cuda_device):
        from keystone_tpu_torch.workflow import Transformer

        class ReadsHost(Transformer):
            def apply(self, x):
                return x

            def device_fn(self):
                return lambda X: X * float(X.sum().item())

        # ExportedPlan directly: export_plan's verifier would refuse the
        # host read on meta tensors before any capture.
        fitted = fitted_from_transformer(ReadsHost())
        stream = torch.cuda.current_stream()
        with pytest.raises(RuntimeError) as exc:
            ExportedPlan(fitted.transformer_graph, fitted.source, fitted.sink,
                         np.zeros(4, np.float32), max_batch=4, device=cuda_device)
        assert "capture" in str(exc.value) and "ReadsHost" in str(exc.value)
        assert torch.cuda.current_stream() == stream
        assert torch.randn(8, device=cuda_device).shape == (8,)


@pytest.mark.cuda
class TestCaptureAndGarbage:
    def test_capture_runs_with_automatic_collection_off(self, cuda_device):
        import gc

        from keystone_tpu_torch.workflow.pipeline import CapturedProgram

        seen = []

        def fn(X):
            seen.append(gc.isenabled())
            return X * 2.0

        assert gc.isenabled()
        CapturedProgram(fn, torch.zeros(4, device=cuda_device), "collection probe")
        assert seen == [False] and gc.isenabled()

    def test_garbage_freed_mid_capture_cannot_break_it(self, cuda_device):
        """Cyclic garbage that owns another captured program becomes
        collectable inside a capture (a page-in while an older plan awaits
        collection): a collection there would free that program's graph
        on the capturing thread, which the capture forbids. The capture
        holds and the victim goes at the next collection."""
        import gc

        from keystone_tpu_torch.workflow.pipeline import CapturedProgram

        victim = [CapturedProgram(lambda X: X + 1.0, torch.zeros(4, device=cuda_device),
                                  "victim")]

        def fn(X):
            holder = {"program": victim.pop()}
            holder["self"] = holder  # a cycle: only a collection frees it
            del holder
            kept = [[] for _ in range(2000)]  # live containers: collections would run
            return X * 2.0 + len(kept) * 0.0

        threshold = gc.get_threshold()
        gc.set_threshold(10)
        try:
            program = CapturedProgram(fn, torch.zeros(4, device=cuda_device), "survivor")
        finally:
            gc.set_threshold(*threshold)
        gc.collect()
        out = program.run(torch.ones(4, device=cuda_device), lambda t: t.clone())
        assert torch.equal(out, torch.full((4,), 2.0, device=cuda_device))


@pytest.mark.cuda
class TestSharedPlanOnCard:
    def test_two_replicas_hammer_one_bucket(self, cuda_device):
        fitted, plan, X = _cosine_plan(cuda_device, max_batch=2)
        want = fitted.apply(Dataset(torch.from_numpy(X[:96]).to(cuda_device))).array.cpu().numpy()
        out = [None] * 96
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # switch threads often: races show
        try:
            with ReplicatedServer(plan, num_replicas=2, max_wait_ms=0.0) as srv:
                def client(rows):
                    for i in rows:
                        f = srv.submit(X[i])
                        out[i] = (f.replica_index, f.result(timeout=60))

                threads = [threading.Thread(target=client, args=(range(k, 96, 8),))
                           for k in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert {o[0] for o in out} == {0, 1}
        got = np.stack([o[1] for o in out])
        # The walked pipeline's 96-row batch apply, bit for bit (C.8).
        np.testing.assert_array_equal(got, want)
        # Each row equals its own bucket-2 replay alone: no row took
        # another request's bits through the shared static buffers.
        for i in range(0, 96, 7):
            np.testing.assert_array_equal(got[i], plan.apply_batch([X[i]])[0])
        assert plan.trace_count == len(plan.buckets)

    def test_two_buckets_replayed_at_once_count_exactly(self, cuda_device):
        """Replicas sharing a plan replay different buckets at the same
        time: every replay's launches reach the counters."""
        _, plan, X = _cosine_plan(cuda_device, max_batch=4)
        cuda_ops.reset_launch_counts()
        before = sum(plan.replays.values())

        def client(rows):
            for _ in range(50):
                plan.apply_padded(X[:rows])

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=client, args=(b,)) for b in (2, 4) * 3]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert sum(plan.replays.values()) - before == 300
        assert cuda_ops.launches["cosine_features"] == 300

    def test_micro_batcher_on_card(self, cuda_device):
        _, plan, X = _cosine_plan(cuda_device, max_batch=16)
        with MicroBatchServer(plan, max_wait_ms=1.0) as srv:
            futs = [srv.submit(x) for x in X[:40]]
            got = np.stack([f.result(timeout=60) for f in futs])
        assert got.shape == (40, 3) and np.isfinite(got).all()
        assert plan.trace_count == len(plan.buckets)


    def test_export_while_serving_fails_nothing(self, cuda_device):
        """A plan exported (its buckets captured) while two replicas serve
        another, as the lifecycle gate exports a trainer's candidate:
        neither the capture nor any replica's request fails."""
        from keystone_tpu_torch.serving import run_open_loop

        fitted, plan, X = _cosine_plan(cuda_device, max_batch=16, seed=0)
        other, _, _ = _cosine_plan(cuda_device, max_batch=16, seed=1)
        holder = {}
        with ReplicatedServer(plan, num_replicas=2, max_wait_ms=1.0) as srv:
            storm = threading.Thread(target=lambda: holder.update(report=run_open_loop(
                srv.submit, lambda i: X[i % len(X)], rate_hz=1000.0, duration_s=1.5, seed=1)))
            storm.start()
            plans = [export_plan(other, np.zeros(24, np.float32), max_batch=16)
                     for _ in range(3)]
            storm.join(timeout=60)
        report = holder["report"]
        assert report.failed == 0 and report.completed > 0
        assert report.num_offered == report.completed + report.rejected
        assert all(p.trace_count == len(p.buckets) for p in plans)


@pytest.mark.cuda
class TestPhaseTimerOnCard:
    def test_phase_timed_with_cuda_events(self, cuda_device):
        from keystone_tpu_torch.utils.profiling import PhaseTimer

        A = torch.randn(2048, 2048, device=cuda_device)
        timer = PhaseTimer("t", device=cuda_device)
        with timer.phase("matmul"):
            for _ in range(4):
                A = A @ A / 2048
        # The end event was synchronized: the work is done on the card.
        assert timer.counts == {"matmul": 1} and timer.total("matmul") > 0.0
        assert torch.cuda.current_stream().query()


@pytest.mark.cuda
class TestFingerprintsOnCard:
    def test_cuda_tensor_tokens_read_content(self, cuda_device):
        a = torch.arange(12, dtype=torch.float32, device=cuda_device).reshape(3, 4)
        b = a.clone()
        b[2, 3] = 0.5
        assert fingerprint_token(a) == fingerprint_token(a.cpu())
        assert fingerprint_token(a) != fingerprint_token(b)
        h = a.to(torch.bfloat16)
        assert fingerprint_token(h) == fingerprint_token(h.cpu())
        assert fingerprint_token(h)["dtype"] == "bfloat16"

    def test_plans_differing_only_in_weights_on_the_card(self, cuda_device):
        from keystone_tpu_torch.ops.learning.linear import LinearMapper
        from keystone_tpu_torch.workflow.fusion import fused_members

        fitted, plan, _ = _cosine_plan(cuda_device, seed=0)
        (mapper,) = {id(m): m for op in plan.graph.operators.values()
                     for m in fused_members(op) + [op] if isinstance(m, LinearMapper)}.values()
        assert mapper.x.is_cuda
        before = plan.fingerprint
        mapper.x[0, 0] += 1.0  # the fitted pipeline shares the operator
        again = export_plan(fitted, np.zeros(24, np.float32), max_batch=16)
        assert again.fingerprint != before


@pytest.mark.cuda
class TestZooOnCard:
    def test_page_round_trip_frees_the_weights_and_keeps_the_bits(self, cuda_device):
        """A page-out frees at least the tenant's charge on the card (the
        weights and the bucket programs go); the page-in recaptures every
        bucket, serves the same bits and counts its replays' launches."""
        from keystone_tpu_torch.serving import ModelZoo

        _, plan, X = _cosine_plan(cuda_device, seed=3)
        charge = plan.pinned_bytes
        zoo = ModelZoo(budget_bytes=10 * charge, max_batch=16, max_wait_ms=1.0)
        try:
            zoo.add_tenant("a", plan)
            before = np.stack([zoo.submit("a", X[i]).result(timeout=60) for i in range(8)])
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            zoo.page_out("a")
            torch.cuda.synchronize()
            assert resident - torch.cuda.memory_allocated() >= charge
            cuda_ops.reset_launch_counts()
            zoo.page_in("a")
            rebuilt = {k: v for k, v in cuda_ops.launches.items() if v}
            after = np.stack([zoo.submit("a", X[i]).result(timeout=60) for i in range(8)])
            assert np.array_equal(before, after)
            entry = zoo._tenants["a"]
            replays = sum(entry.plan.replays.values())
            per = entry.plan.launches_per_replay[2]
            assert per == {"cosine_features": 1, "row_stable_matmul": 1}
            # Each bucket's eager run before its capture, then the replays.
            want = {k: v * (len(entry.plan.buckets) + replays) for k, v in per.items()}
            assert {k: v for k, v in cuda_ops.launches.items() if v} == want
            assert rebuilt == {k: v * len(entry.plan.buckets) for k, v in per.items()}
            assert zoo.stats()["tenants"]["a"]["fingerprint"] == plan.fingerprint
        finally:
            zoo.close()

    def test_page_in_while_another_tenant_serves(self, cuda_device):
        """A page-in captures (thread-local mode) while another tenant's
        bucket graphs replay on its server's thread: nothing fails and
        every response keeps its bits."""
        from keystone_tpu_torch.serving import ModelZoo

        _, plan_a, X = _cosine_plan(cuda_device, seed=4)
        _, plan_b, _ = _cosine_plan(cuda_device, seed=5)
        zoo = ModelZoo(budget_bytes=10 * plan_a.pinned_bytes, max_batch=16, max_wait_ms=1.0)
        try:
            zoo.add_tenant("a", plan_a)
            zoo.add_tenant("b", plan_b, resident=False)
            want = zoo.submit("a", X[0]).result(timeout=60)
            stop, got, errors = threading.Event(), [], []

            def loop():
                while not stop.is_set():
                    try:
                        got.append(zoo.submit("a", X[0]).result(timeout=60))
                    except Exception as e:  # noqa: BLE001 — the test reads them
                        errors.append(e)

            t = threading.Thread(target=loop)
            t.start()
            try:
                for _ in range(3):
                    zoo.page_in("b")
                    zoo.page_out("b")
            finally:
                stop.set()
                t.join(timeout=60)
            assert not errors and got
            assert all(np.array_equal(g, want) for g in got)
            assert zoo.stats()["accounting_ok"] and zoo.stats()["quarantined"] == 0
        finally:
            zoo.close()


def _fleet_on_card(ship, num_planes=2):
    from keystone_tpu_torch.serving.fleet import FleetRouter

    return FleetRouter(ship, num_planes=num_planes, replicas_per_plane=1,
                       heartbeat_interval_s=0.1, heartbeat_timeout_s=5.0,
                       restart_budget=2, startup_timeout_s=180.0,
                       plane_cfg={"device": "cuda"})


def _free_bytes():
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


@pytest.mark.cuda
class TestFleetOnCard:
    """The process fleet with its planes on the card: each plane is its own
    process with its own CUDA context, bucket captures and launch
    counters."""

    def test_two_planes_serve_every_bucket_bit_equal(self, cuda_device):
        from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

        fitted, plan, X = _cosine_plan(cuda_device, max_batch=16, seed=6)
        fleet = _fleet_on_card(encode_plan_ship(fitted, plan))
        try:
            for b in plan.buckets:
                want = plan.apply_batch(list(X[:b]))
                got = np.stack([f.result(timeout=120) for f in
                                [fleet.submit(x) for x in X[:b]]])
                assert got.tobytes() == np.ascontiguousarray(want).tobytes(), b
            launches = {n: r["launches"] for n, r in fleet.plane_stats().items()}
            stats = fleet.stats()
        finally:
            fleet.close()
        assert all(p["completed"] > 0 for p in stats["planes"].values())
        for name, counts in launches.items():
            assert counts["cosine_features"] > 0 and counts["row_stable_matmul"] > 0, name
        assert fleet.accounting_ok()

    def test_a_killed_planes_memory_is_returned(self, cuda_device):
        import os
        import signal
        import time

        from keystone_tpu_torch.serving.fleet_plane import encode_plan_ship

        fitted, plan, X = _cosine_plan(cuda_device, max_batch=16, seed=7)
        ship = encode_plan_ship(fitted, plan)
        free0 = _free_bytes()
        fleet = _fleet_on_card(ship)
        try:
            footprint = (free0 - _free_bytes()) / 2
            fleet.submit(X[0]).result(timeout=120)
            free_before = _free_bytes()
            victim = fleet.plane_pids()["plane0"]
            os.kill(victim, signal.SIGKILL)
            deadline = time.monotonic() + 180.0
            while time.monotonic() < deadline:
                s = fleet.stats()
                if s["restarts_total"] >= 1 and s["healthy_planes"] == 2:
                    break
                time.sleep(0.05)
            assert fleet.plane_pids()["plane0"] not in (None, victim)
            free_after = _free_bytes()
            fleet.submit(X[0]).result(timeout=120)
        finally:
            fleet.close()
        assert footprint > 0
        # A context left behind by the dead plane would take a whole
        # plane's footprint.
        assert free_before - free_after < footprint / 2, (free_before, free_after, footprint)
