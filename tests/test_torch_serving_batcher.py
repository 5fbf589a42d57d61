"""The port's micro-batcher (``keystone_tpu_torch/serving/batcher.py``)
against the reference's on the CPU, and the reference's own contract
cases on the port.

  - The same arrival script through both packages' ``MicroBatchServer``
    (a gated host stage holds each worker inside a batch) sheds the same
    victims, synchronously and through futures, with the same counters.
  - Served outputs equal offline apply bit for bit under any bucket
    interleaving (the tiny MNIST fit, float32).
  - Overload, shutdown without a thread leak, the circuit breaker with
    its half-open probe, a plan error re-raised in the submitter, and a
    worker death that never hangs a submitter.

Every wait is bounded (``result(timeout=...)``, ``close(timeout=...)``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.serving import (
    MicroBatchServer,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
    export_plan,
    run_open_loop,
)
from tests._torch_serving_util import (
    TINY_D_IN,
    Exploding,
    GatedScale,
    fit_tiny_mnist,
    fitted_from_transformer,
)

EDF_DEADLINES = [500.0, 40.0, None, 120.0, 15.0, 800.0, None, 60.0, 25.0, 300.0]


def _gated_server(**kw):
    op = GatedScale()
    plan = export_plan(fitted_from_transformer(op), np.zeros(4, np.float32), max_batch=8)
    assert not plan.compiled
    return op, MicroBatchServer(plan, **kw)


def _reference_gated_server(**kw):
    import jax.numpy as jnp

    from keystone_tpu.data import Dataset as JDataset
    from keystone_tpu.serving import MicroBatchServer as JServer
    from keystone_tpu.serving import export_plan as j_export
    from keystone_tpu.workflow import Transformer as JTransformer
    from tests._serving_util import fitted_from_transformer as j_fitted

    class JGated(JTransformer):
        def __init__(self):
            self.gate = threading.Event()
            self.gate.set()

        def apply(self, x):
            return jnp.asarray(x) * 3.0

        def batch_apply(self, ds):
            self.gate.wait(timeout=10.0)
            return JDataset(jnp.asarray(ds.array) * 3.0, n=ds.n)

    op = JGated()
    plan = j_export(j_fitted(op), np.zeros(4, np.float32), max_batch=8)
    return op, JServer(plan, **kw)


def _edf_script(op, server, overloaded):
    """The reference's deterministic-replay script: a blocked worker, ten
    submissions with spread deadlines; each outcome and the counters."""
    outcomes = []
    op.gate.clear()
    try:
        blocker = server.submit(np.ones(4, np.float32))
        time.sleep(0.05)  # the worker is now blocked inside the batch
        futs = []
        for d in EDF_DEADLINES:
            try:
                futs.append(server.submit(np.ones(4, np.float32), deadline_ms=d))
            except overloaded:
                futs.append(None)
        op.gate.set()
        for f in futs:
            if f is None:
                outcomes.append("sync_shed")
                continue
            try:
                f.result(timeout=10)
                outcomes.append("ok")
            except overloaded:
                outcomes.append("shed")
        blocker.result(timeout=10)
    finally:
        op.gate.set()
        server.close(timeout=10)
    stats = server.stats()
    return outcomes, {k: stats[k] for k in ("completed", "rejected", "failed",
                                            "breaker_state", "degraded_rejected")}


class TestAgainstReference:
    def test_same_shedding_victims_and_counters(self):
        from keystone_tpu.serving import ServerOverloaded as JOverloaded

        kw = dict(max_batch=4, max_wait_ms=0.0, max_queue_depth=3)
        t = _edf_script(*_gated_server(**kw), ServerOverloaded)
        j = _edf_script(*_reference_gated_server(**kw), JOverloaded)
        assert t == j
        assert {"ok", "shed", "sync_shed"} <= set(t[0])

    def test_same_served_rows_as_the_reference_server(self):
        from keystone_tpu.serving import MicroBatchServer as JServer
        from keystone_tpu.serving import export_plan as j_export
        from tests._torch_serving_util import reference_tiny_mnist

        j_fitted, t_fitted, _ = reference_tiny_mnist()
        example = np.zeros(TINY_D_IN, np.float32)
        X = np.random.default_rng(8).normal(size=(11, TINY_D_IN)).astype(np.float32)
        outs = []
        for server in (MicroBatchServer(export_plan(t_fitted, example, max_batch=4)),
                       JServer(j_export(j_fitted, example, max_batch=4))):
            try:
                outs.append(np.stack([np.asarray(f.result(timeout=30))
                                      for f in [server.submit(x) for x in X]]))
            finally:
                server.close(timeout=10)
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0)


class TestBitIdentity:
    def test_served_equals_offline_any_interleaving(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        X = np.random.default_rng(3).normal(size=(37, TINY_D_IN)).astype(np.float32)
        offline = fitted.apply(Dataset.of(torch.from_numpy(X))).array.numpy()
        server = MicroBatchServer(plan, max_batch=8, max_wait_ms=1.0)
        try:
            futures = []
            for i in range(len(X)):
                futures.append(server.submit(X[i]))
                if i % 7 == 3:
                    time.sleep(0.003)  # stagger arrivals: varied buckets
            served = np.stack([f.result(timeout=30) for f in futures])
        finally:
            server.close(timeout=10)
        np.testing.assert_array_equal(served, offline)
        assert len({s.bucket for s in server.span_log.snapshot()}) >= 2

    @pytest.mark.parametrize("order", ["ascending", "descending", "shuffled"])
    def test_every_bucket_gives_offline_bits(self, order):
        fitted, _ = fit_tiny_mnist(seed=2)
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=16)
        X = np.random.default_rng(9).normal(size=(16, TINY_D_IN)).astype(np.float32)
        offline = fitted.apply(Dataset.of(torch.from_numpy(X))).array.numpy()
        sizes = list(range(1, 17))
        if order == "descending":
            sizes.reverse()
        elif order == "shuffled":
            np.random.default_rng(1).shuffle(sizes)
        for m in sizes:
            np.testing.assert_array_equal(plan.apply_batch(list(X[:m])), offline[:m])

    def test_spans_and_stats_populated(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=4)
        with MicroBatchServer(plan, max_wait_ms=1.0) as server:
            for f in [server.submit(np.zeros(TINY_D_IN, np.float32)) for _ in range(9)]:
                f.result(timeout=30)
            stats = server.stats()
        assert stats["completed"] == 9 and stats["num_latency_samples"] == 9
        assert stats["p99_latency_s"] >= stats["p50_latency_s"] > 0.0
        assert 0.0 <= stats["mean_pad_fraction"] < 1.0
        span = server.span_log.snapshot()[0]
        assert span.queue_wait_s >= 0.0 and span.exec_s > 0.0
        assert span.bucket >= span.batch_size and span.replica is None


class TestOverload:
    def test_bounded_queue_sheds_explicitly_and_inflight_completes(self):
        op, server = _gated_server(max_batch=4, max_wait_ms=0.0, max_queue_depth=4)
        op.gate.clear()
        try:
            first = server.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            futs = [server.submit(np.ones(4, np.float32) * i) for i in range(12)]
            op.gate.set()
            outcomes = {"ok": 0, "shed": 0}
            for f in [first] + futs:
                try:
                    f.result(timeout=10)
                    outcomes["ok"] += 1
                except ServerOverloaded:
                    outcomes["shed"] += 1
        finally:
            op.gate.set()
            server.close(timeout=10)
        assert outcomes["ok"] + outcomes["shed"] == 13
        assert outcomes["shed"] > 0 and outcomes["ok"] >= 5
        assert server.stats()["rejected"] == outcomes["shed"]

    def test_earliest_deadline_is_the_shedding_victim(self):
        op, server = _gated_server(max_batch=2, max_wait_ms=0.0, max_queue_depth=2)
        op.gate.clear()
        try:
            blocker = server.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            f_tight = server.submit(np.ones(4, np.float32), deadline_ms=50.0)
            f_loose = server.submit(np.ones(4, np.float32), deadline_ms=1e6)
            with pytest.raises(ServerOverloaded):
                server.submit(np.ones(4, np.float32), deadline_ms=1.0)
            f_new = server.submit(np.ones(4, np.float32))
            with pytest.raises(ServerOverloaded):
                f_tight.result(timeout=5)
            op.gate.set()
            for f in (blocker, f_loose, f_new):
                f.result(timeout=10)
        finally:
            op.gate.set()
            server.close(timeout=10)
        assert server.stats()["rejected"] == 2

    def test_edf_shedding_is_deterministic_on_replay(self):
        kw = dict(max_batch=4, max_wait_ms=0.0, max_queue_depth=3)
        first = _edf_script(*_gated_server(**kw), ServerOverloaded)
        assert _edf_script(*_gated_server(**kw), ServerOverloaded) == first


class TestShutdown:
    def test_shutdown_midload_no_deadlock_no_thread_leak(self):
        op, server = _gated_server(max_batch=4, max_wait_ms=0.0, max_queue_depth=64)
        op.gate.clear()
        inflight = server.submit(np.ones(4, np.float32))
        time.sleep(0.05)
        queued = [server.submit(np.ones(4, np.float32) * i) for i in range(10)]
        op.gate.set()
        t0 = time.perf_counter()
        server.close(timeout=10.0)
        assert time.perf_counter() - t0 < 10.0
        assert not server.is_alive
        assert not server._thread.is_alive()
        np.testing.assert_array_equal(np.asarray(inflight.result(timeout=1)), np.ones(4) * 3.0)
        for f in queued:
            with pytest.raises(ServerClosed):
                f.result(timeout=1)

    def test_submit_after_close_raises(self):
        _, server = _gated_server()
        server.close(timeout=10)
        with pytest.raises(ServerClosed):
            server.submit(np.zeros(4, np.float32))

    def test_close_is_idempotent(self):
        _, server = _gated_server()
        server.close(timeout=10)
        server.close(timeout=10)
        assert not server.is_alive


class TestRobustness:
    def test_client_cancelled_future_does_not_kill_worker(self):
        op, server = _gated_server(max_batch=4, max_wait_ms=0.0)
        op.gate.clear()
        try:
            blocker = server.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            doomed = server.submit(np.ones(4, np.float32))
            assert doomed.cancel()
            op.gate.set()
            blocker.result(timeout=10)
            out = server.submit(np.ones(4, np.float32)).result(timeout=10)
            np.testing.assert_array_equal(np.asarray(out), np.ones(4) * 3.0)
            assert server.is_alive
        finally:
            op.gate.set()
            server.close(timeout=10)

    def test_nonpositive_max_batch_rejected_at_build(self):
        plan = export_plan(fitted_from_transformer(GatedScale()), np.zeros(4, np.float32),
                           max_batch=8)
        for bad in (0, -1):
            with pytest.raises(ValueError, match="max_batch"):
                MicroBatchServer(plan, max_batch=bad)


class TestErrorsAndDegradation:
    def _exploding_server(self, **kw):
        op = Exploding()
        plan = export_plan(fitted_from_transformer(op), np.zeros(4, np.float32), max_batch=4)
        return op, MicroBatchServer(plan, max_wait_ms=kw.pop("max_wait_ms", 0.0), **kw)

    def test_plan_error_reraises_in_submitter_and_server_survives(self):
        op, server = self._exploding_server()
        try:
            with pytest.raises(ValueError, match="plan down"):
                server.submit(np.zeros(4, np.float32)).result(timeout=10)
            assert server.is_alive
            op.arm = False
            server.submit(np.zeros(4, np.float32)).result(timeout=10)
            assert server.stats()["failed"] == 1
        finally:
            server.close(timeout=10)

    def test_healthy_server_reports_closed_breaker(self):
        _, server = _gated_server()
        try:
            server.submit(np.ones(4, np.float32)).result(timeout=10)
            stats = server.stats()
            assert stats["breaker_state"] == "closed"
            assert stats["breaker_opens"] == stats["degraded_rejected"] == 0
            assert stats["consecutive_failures"] == 0
        finally:
            server.close(timeout=10)

    def test_breaker_opens_and_recovers_via_half_open_probe(self):
        op, server = self._exploding_server(breaker_threshold=2, breaker_reset_s=0.2)
        try:
            for _ in range(2):
                with pytest.raises(ValueError, match="plan down"):
                    server.submit(np.zeros(4, np.float32)).result(timeout=10)
            deadline = time.perf_counter() + 5.0
            while server.breaker_state != "open" and time.perf_counter() < deadline:
                time.sleep(0.005)
            with pytest.raises(ServerDegraded):
                server.submit(np.zeros(4, np.float32))
            op.arm = False
            time.sleep(0.25)  # cooldown elapses -> half-open
            server.submit(np.zeros(4, np.float32)).result(timeout=10)
            assert server.breaker_state == "closed"
            assert server.stats()["breaker_opens"] == 1
        finally:
            server.close(timeout=10)

    def test_default_threshold_absorbs_isolated_failures(self):
        op, server = self._exploding_server()
        try:
            with pytest.raises(ValueError):
                server.submit(np.zeros(4, np.float32)).result(timeout=10)
            op.arm = False
            server.submit(np.zeros(4, np.float32)).result(timeout=10)
            assert server.breaker_state == "closed"
        finally:
            server.close(timeout=10)

    def test_close_racing_half_open_probe_resolves_server_closed(self):
        op, server = self._exploding_server(max_wait_ms=500.0, breaker_threshold=1,
                                            breaker_reset_s=0.05)
        try:
            with pytest.raises(ValueError, match="plan down"):
                server.submit(np.zeros(4, np.float32)).result(timeout=10)
            deadline = time.perf_counter() + 5.0
            while server.breaker_state == "closed" and time.perf_counter() < deadline:
                time.sleep(0.005)
            time.sleep(0.08)
            assert server.breaker_state == "half_open"
            probe = server.submit(np.zeros(4, np.float32))
            t0 = time.perf_counter()
            server.close(timeout=10.0)
            assert time.perf_counter() - t0 < 5.0
            with pytest.raises(ServerClosed):
                probe.result(timeout=2)
            assert not server.is_alive
        finally:
            server.close(timeout=10)

    def test_worker_death_never_hangs_submitters(self):
        _, server = _gated_server(max_wait_ms=100.0)
        server.submit(np.ones(4, np.float32)).result(timeout=10)
        server._execute = None  # loop-level failure, outside the guard
        fut = server.submit(np.ones(4, np.float32))
        with pytest.raises(ServerDegraded, match="worker thread died"):
            fut.result(timeout=10)
        with pytest.raises(ServerDegraded):
            server.submit(np.ones(4, np.float32))
        assert server.stats()["breaker_state"] == "dead"
        server.close(timeout=10)

    def test_injected_execute_fault_fails_one_batch(self):
        from keystone_tpu_torch.utils import faults

        _, server = _gated_server(max_wait_ms=0.0)
        plan = faults.FaultPlan([faults.FaultRule(faults.SITE_SERVING_EXECUTE, calls=[0])])
        try:
            with plan.active():
                with pytest.raises(faults.FaultError):
                    server.submit(np.ones(4, np.float32)).result(timeout=10)
                out = server.submit(np.ones(4, np.float32)).result(timeout=10)
            np.testing.assert_array_equal(np.asarray(out), np.ones(4) * 3.0)
            assert server.stats()["failed"] == 1
        finally:
            server.close(timeout=10)


class TestSLOAndOpenLoop:
    def test_server_feeds_its_slo_tracker(self):
        slo = obs.SLOTracker([obs.SLOObjective("availability", kind="availability",
                                               target=0.9)])
        op, server = _gated_server(max_batch=2, max_wait_ms=0.0, max_queue_depth=1, slo=slo)
        op.gate.clear()
        try:
            blocker = server.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            queued = server.submit(np.ones(4, np.float32))
            with pytest.raises(ServerOverloaded):
                server.submit(np.ones(4, np.float32), deadline_ms=1.0)
            op.gate.set()
            blocker.result(timeout=10)
            queued.result(timeout=10)
        finally:
            op.gate.set()
            server.close(timeout=10)
        ledger = slo.verdict()["objectives"]["availability"]
        assert ledger["good_total"] == 2 and ledger["bad_total"] == 1

    def test_open_loop_report_books_balance(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=16)
        pool = np.random.default_rng(5).normal(size=(64, TINY_D_IN)).astype(np.float32)
        server = MicroBatchServer(plan, max_batch=16, max_wait_ms=2.0)
        try:
            report = run_open_loop(server.submit, lambda i: pool[i % 64], rate_hz=300.0,
                                   duration_s=0.5, seed=7)
        finally:
            server.close(timeout=10)
        d = report.to_row_dict()
        assert d["num_offered"] == d["num_samples"] + d["rejected"] + d["failed"]
        assert d["failed"] == 0 and d["offered_rate_hz"] == 300.0
        assert report.p99_latency_s >= report.p50_latency_s > 0.0
