"""Card-only cases of the port's serving path: bucket programs captured as
CUDA graphs at export, the warm path never capturing, launch counts across
replays, two replicas hammering one captured bucket, a failed capture,
and the fingerprints of CUDA tensors.

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
