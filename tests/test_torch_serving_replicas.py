"""The port's replicated serving plane
(``keystone_tpu_torch/serving/replicas.py``) on the CPU: the reference's
contract cases (``tests/test_serving_replicas.py``, the replica chaos
drills and the elasticity primitives of ``tests/test_serving_autoscale.py``)
on the port, and one hot swap run through both packages.

  - routing: bit identity and attribution across replicas, least-loaded
    choice, failover and the aggregate reject, breaker rotation with the
    half-open probe, all replicas down;
  - two replicas sharing one plan hammering one bucket (the bucket
    program serialises its copy-in, run and copy-out; on the card that is
    a CUDA graph's static buffers, ``tests/test_torch_serving_cuda.py``);
  - watchdog restarts, spawn faults burning the budget to a loud
    eviction, a zero budget;
  - the hot swap: fingerprints and outputs (bit for bit against the new
    model's offline apply), draining, signature and count checks, and the
    same fingerprint split as the reference's swap on the same script;
  - add / remove replica with nothing dropped, the brownout ladder.

Every wait is bounded.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.serving import (
    BROWNOUT_STEPS,
    ReplicatedServer,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
    export_plan,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from keystone_tpu_torch.workflow import Transformer
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist, fitted_from_transformer


class GatedArmedScale(Transformer):
    """Host x -> 3x with an Event gate and a failure arm (one bad replica,
    which a global fault site cannot target)."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.arm = False

    def apply(self, x):
        return torch.as_tensor(x) * 3.0

    def batch_apply(self, ds):
        self.gate.wait(timeout=10.0)
        if self.arm:
            raise ValueError("replica plan down")
        return Dataset(torch.as_tensor(ds.array) * 3.0, n=ds.n)


def _gated_plans(n):
    ops = [GatedArmedScale() for _ in range(n)]
    plans = [export_plan(fitted_from_transformer(op), np.zeros(4, np.float32), max_batch=8)
             for op in ops]
    return ops, plans


def _plane(num_replicas=3, seed=0, **kw):
    fitted, X = fit_tiny_mnist(seed=seed)
    plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
    kw.setdefault("max_wait_ms", 0.5)
    kw.setdefault("watchdog_interval_s", 0.01)
    return fitted, plan, X, ReplicatedServer(plan, num_replicas=num_replicas, **kw)


def _offline(fitted, X):
    return fitted.apply(Dataset.of(torch.from_numpy(np.ascontiguousarray(X)))).array.numpy()


class TestRouting:
    def test_bit_identity_and_attribution_across_replicas(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        X = np.random.default_rng(3).normal(size=(41, TINY_D_IN)).astype(np.float32)
        offline = _offline(fitted, X)
        with ReplicatedServer(plan, num_replicas=3, max_wait_ms=1.0) as srv:
            futs = [srv.submit(X[i]) for i in range(len(X))]
            served = np.stack([f.result(timeout=30) for f in futs])
            used = {f.replica_index for f in futs}
            fps = {f.plan_fingerprint for f in futs}
            stats = srv.stats()
        np.testing.assert_array_equal(served, offline)
        assert len(used) >= 2 and fps == {plan.fingerprint}
        assert stats["completed"] == len(X) and stats["healthy_replicas"] == 3
        assert not stats["degraded"]

    def test_two_replicas_hammer_one_bucket(self):
        """Two replicas share one plan; many threads submit at once, all
        single requests (bucket 2): every response is its row's offline
        output."""
        fitted, _ = fit_tiny_mnist(seed=5)
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=2)
        X = np.random.default_rng(4).normal(size=(96, TINY_D_IN)).astype(np.float32)
        offline = _offline(fitted, X)
        out = [None] * len(X)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # switch threads often: races show
        try:
            with ReplicatedServer(plan, num_replicas=2, max_wait_ms=0.0) as srv:
                def client(rows):
                    for i in rows:
                        f = srv.submit(X[i])
                        out[i] = (f.replica_index, f.result(timeout=30))

                threads = [threading.Thread(target=client, args=(range(k, len(X), 6),))
                           for k in range(6)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert {o[0] for o in out} == {0, 1}
        np.testing.assert_array_equal(np.stack([o[1] for o in out]), offline)
        assert plan.trace_count == len(plan.buckets)

    def test_least_loaded_prefers_idle_replica(self):
        ops, plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0)
        try:
            ops[0].gate.clear()
            first = srv.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            futs = []
            for _ in range(4):
                f = srv.submit(np.ones(4, np.float32))
                f.result(timeout=10)
                futs.append(f)
            assert {f.replica_index for f in futs} == {1}
            ops[0].gate.set()
            first.result(timeout=10)
        finally:
            for op in ops:
                op.gate.set()
            srv.close()

    def test_failover_on_overload_then_aggregate_reject(self):
        ops, plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0, max_queue_depth=1)
        futs = []
        try:
            for op in ops:
                op.gate.clear()
            for _ in range(2):
                futs.append(srv.submit(np.ones(4, np.float32)))
            time.sleep(0.05)
            for _ in range(2):
                futs.append(srv.submit(np.ones(4, np.float32)))
            time.sleep(0.05)
            with pytest.raises(ServerOverloaded, match="every in-rotation"):
                srv.submit(np.ones(4, np.float32), deadline_ms=0.1)
            assert srv.stats()["rejected"] >= 1
        finally:
            for op in ops:
                op.gate.set()
            for f in futs:
                try:
                    f.result(timeout=10)
                except ServerOverloaded:
                    pass
            srv.close()

    def test_open_breaker_leaves_rotation_probe_readmits(self):
        ops, plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0, breaker_threshold=2,
                               breaker_reset_s=0.2)
        try:
            ops[0].arm = True
            failures = 0
            deadline = time.perf_counter() + 10.0
            while time.perf_counter() < deadline:
                try:
                    srv.submit(np.ones(4, np.float32)).result(timeout=10)
                except ValueError:
                    failures += 1
                if srv.stats()["per_replica"][0]["breaker_state"] in ("open", "half_open"):
                    break
            assert failures >= 2
            futs = [srv.submit(np.ones(4, np.float32)) for _ in range(6)]
            for f in futs:
                f.result(timeout=10)
            assert {f.replica_index for f in futs} == {1}
            ops[0].arm = False
            time.sleep(0.25)
            probe = srv.submit(np.ones(4, np.float32))
            np.testing.assert_array_equal(np.asarray(probe.result(timeout=10)), np.ones(4) * 3.0)
            assert probe.replica_index == 0
            assert srv.stats()["per_replica"][0]["breaker_state"] == "closed"
        finally:
            srv.close()

    def test_all_replicas_down_raises_degraded(self):
        ops, plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0, breaker_threshold=1,
                               breaker_reset_s=60.0)
        try:
            for op in ops:
                op.arm = True
            deadline = time.perf_counter() + 10.0
            while time.perf_counter() < deadline:
                try:
                    srv.submit(np.ones(4, np.float32)).result(timeout=10)
                except ValueError:
                    pass
                except ServerDegraded:
                    break
                if all(s["breaker_state"] == "open"
                       for s in srv.stats()["per_replica"].values()):
                    break
            with pytest.raises(ServerDegraded, match="no replica available"):
                srv.submit(np.ones(4, np.float32))
            assert srv.stats()["degraded_rejected"] >= 1
        finally:
            srv.close()


class TestRestartsAndEviction:
    def test_kill_restart_full_health(self):
        _, plan, X, srv = _plane(num_replicas=3)
        kill = FaultPlan([FaultRule("serving.replica.execute", "error", calls=[0])])
        named_errors = 0
        try:
            with kill:
                for i in range(30):
                    try:
                        srv.submit(X[i % len(X)]).result(timeout=30)
                    except (ServerDegraded, OSError):
                        named_errors += 1
                    time.sleep(0.01)
            stats = srv.stats()
            assert named_errors >= 1
            assert stats["restarts_total"] == 1 and stats["healthy_replicas"] == 3
            assert not stats["degraded"] and stats["evicted_replicas"] == []
            srv.submit(X[0]).result(timeout=30)
        finally:
            srv.close()

    def test_spawn_faults_exhaust_budget_to_loud_eviction(self):
        _, plan, X, srv = _plane(num_replicas=2, restart_budget=2)
        chaos = FaultPlan([
            FaultRule("serving.replica.execute", "error", calls=[0]),
            FaultRule("serving.replica.spawn", "error", p=1.0),
        ])
        try:
            with chaos:
                try:
                    srv.submit(X[0]).result(timeout=30)
                except (ServerDegraded, OSError):
                    pass
                deadline = time.perf_counter() + 10.0
                while not srv.stats()["evicted_replicas"] and time.perf_counter() < deadline:
                    time.sleep(0.02)
            stats = srv.stats()
            assert len(stats["evicted_replicas"]) == 1
            assert stats["degraded"] and stats["healthy_replicas"] == 1
            evicted = stats["evicted_replicas"][0]
            assert stats["per_replica"][evicted]["restarts"] == 2
            out = srv.submit(X[0])
            out.result(timeout=30)
            assert out.replica_index != evicted
        finally:
            srv.close()

    def test_zero_restart_budget_evicts_on_first_death(self):
        _, plan, X, srv = _plane(num_replicas=2, restart_budget=0)
        kill = FaultPlan([FaultRule("serving.replica.execute", "error", calls=[0])])
        try:
            with kill:
                try:
                    srv.submit(X[0]).result(timeout=30)
                except (ServerDegraded, OSError):
                    pass
                deadline = time.perf_counter() + 10.0
                while not srv.stats()["evicted_replicas"] and time.perf_counter() < deadline:
                    time.sleep(0.02)
            stats = srv.stats()
            assert len(stats["evicted_replicas"]) == 1 and stats["restarts_total"] == 0
        finally:
            srv.close()


class TestHotSwap:
    def test_swap_changes_fingerprint_and_outputs(self):
        fitted1, X = fit_tiny_mnist(seed=0)
        fitted2, _ = fit_tiny_mnist(seed=42)
        plan1 = export_plan(fitted1, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        with ReplicatedServer(plan1, num_replicas=2, max_wait_ms=0.0) as srv:
            f_old = srv.submit(X[0])
            old_out = np.asarray(f_old.result(timeout=30))
            report = srv.swap_plan(fitted2)  # the FittedPipeline form
            assert all(r["swapped"] for r in report["replicas"])
            assert all(r["old_fingerprint"] != r["new_fingerprint"] for r in report["replicas"])
            f_new = srv.submit(X[0])
            new_out = np.asarray(f_new.result(timeout=30))
            assert f_new.plan_fingerprint != f_old.plan_fingerprint
            np.testing.assert_array_equal(new_out, _offline(fitted2, X[:1])[0])
            assert not np.array_equal(new_out, old_out)
            assert srv.stats()["swaps_completed"] == 1

    def test_swap_under_load_zero_drop_bit_identical(self):
        fitted1, X = fit_tiny_mnist(seed=0)
        fitted2, _ = fit_tiny_mnist(seed=7)
        example = np.zeros(TINY_D_IN, np.float32)
        plan1 = export_plan(fitted1, example, max_batch=8)
        plan2 = export_plan(fitted2, example, max_batch=8)
        want = {plan1.fingerprint: _offline(fitted1, X), plan2.fingerprint: _offline(fitted2, X)}
        srv = ReplicatedServer(plan1, num_replicas=2, max_wait_ms=0.5)
        futures = []
        try:
            for i in range(120):
                futures.append((i, srv.submit(X[i % len(X)])))
                if i == 50:
                    threading.Thread(target=srv.swap_plan, args=(plan2,), daemon=True).start()
                time.sleep(0.001)
            results = [(i, f.plan_fingerprint, f.result(timeout=30)) for i, f in futures]
            deadline = time.perf_counter() + 10
            while srv.stats()["swaps_completed"] < 1 and time.perf_counter() < deadline:
                time.sleep(0.01)
        finally:
            srv.close()
        assert {fp for _, fp, _ in results} == set(want)
        for i, fp, y in results:
            np.testing.assert_array_equal(y, want[fp][i % len(X)])

    def test_swap_drains_inflight_work_first(self):
        ops, plans = _gated_plans(2)
        new_ops, new_plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0, drain_timeout_s=10.0)
        try:
            ops[0].gate.clear()
            stuck = srv.submit(np.ones(4, np.float32))
            time.sleep(0.05)
            done = threading.Event()

            def _swap():
                srv.swap_plan(new_plans)
                done.set()

            t = threading.Thread(target=_swap)
            t.start()
            try:
                time.sleep(0.1)
                assert not stuck.done()
                ops[0].gate.set()
                np.testing.assert_array_equal(np.asarray(stuck.result(timeout=10)),
                                              np.ones(4) * 3.0)
                assert done.wait(timeout=10)
            finally:
                t.join(timeout=10)
            out = srv.submit(np.ones(4, np.float32))
            out.result(timeout=10)
            assert out.plan_fingerprint in {p.fingerprint for p in new_plans}
        finally:
            for op in ops + new_ops:
                op.gate.set()
            srv.close()

    def test_swap_rejects_signature_mismatch(self):
        fitted, _ = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        _, other_plans = _gated_plans(1)
        with ReplicatedServer(plan, num_replicas=2, max_wait_ms=0.0) as srv:
            with pytest.raises(ValueError, match="signature"):
                srv.swap_plan(other_plans[0])

    def test_swap_wrong_plan_count_and_type_rejected(self):
        ops, plans = _gated_plans(2)
        with ReplicatedServer(plans, max_wait_ms=0.0) as srv:
            with pytest.raises(ValueError, match="2 replicas"):
                srv.swap_plan(plans[:1])
            with pytest.raises(TypeError, match="swap_plan takes"):
                srv.swap_plan(object())

    def test_swap_report_matches_the_reference(self):
        """The same sequential script through both packages' planes: the
        same swap report shape and per-fingerprint completion split."""
        from keystone_tpu.serving import ReplicatedServer as JServer
        from keystone_tpu.serving import export_plan as j_export
        from tests._serving_util import fit_tiny_mnist as j_fit

        example = np.zeros(TINY_D_IN, np.float32)

        def script(server_cls, plans, rows):
            srv = server_cls(plans[0], num_replicas=2, max_wait_ms=0.0)
            try:
                futs = [srv.submit(x) for x in rows[:5]]
                for f in futs:
                    f.result(timeout=30)
                report = srv.swap_plan(plans[1])
                futs += [srv.submit(x) for x in rows[5:12]]
                for f in futs:
                    f.result(timeout=30)
                stats = srv.stats()
            finally:
                srv.close()
            version = {p.fingerprint: k for k, p in enumerate(plans)}
            return (sorted(report["replicas"][0]), [r["swapped"] for r in report["replicas"]],
                    [version[f.plan_fingerprint] for f in futs],
                    stats["completed"], stats["swaps_completed"])

        t_plans = [export_plan(fit_tiny_mnist(seed=s)[0], example, max_batch=8) for s in (0, 1)]
        j_plans = [j_export(j_fit(seed=s)[0], example, max_batch=8) for s in (0, 1)]
        X = np.random.default_rng(2).normal(size=(12, TINY_D_IN)).astype(np.float32)
        assert script(ReplicatedServer, t_plans, X) == script(JServer, j_plans, X)


class TestElasticity:
    def test_add_replica_zero_drop_under_load(self):
        _, plan, X, srv = _plane(num_replicas=2)
        try:
            futures = []
            for i in range(60):
                futures.append(srv.submit(X[i % len(X)]))
                if i == 20:
                    assert srv.add_replica() == 2
                time.sleep(0.001)
            for f in futures:
                f.result(timeout=30)
            stats = srv.stats()
            assert stats["replicas_added"] == 1 and stats["num_replicas"] == 3
            assert stats["failed"] == 0 and stats["rejected"] == 0
            post = [srv.submit(X[i % len(X)]) for i in range(40)]
            for f in post:
                f.result(timeout=30)
            assert [f for f in futures + post if f.replica_index == 2]
        finally:
            srv.close()

    def test_remove_replica_drains_zero_drop(self):
        _, plan, X, srv = _plane(num_replicas=3)
        try:
            futures = [srv.submit(X[i % len(X)]) for i in range(40)]
            removed = srv.remove_replica()
            for f in futures:
                f.result(timeout=30)
            stats = srv.stats()
            assert stats["num_replicas"] == 2 and stats["replicas_removed"] == 1
            assert removed not in stats["per_replica"]
            assert stats["failed"] == 0 and stats["rejected"] == 0
            assert stats["completed"] == sum(1 for f in futures if f.done())
        finally:
            srv.close()

    def test_remove_refuses_last_replica(self):
        _, plan, X, srv = _plane(num_replicas=2)
        try:
            srv.remove_replica()
            with pytest.raises(ValueError, match="last live replica"):
                srv.remove_replica()
            srv.submit(X[0]).result(timeout=30)
        finally:
            srv.close()

    def test_scale_up_serves_swapped_plan(self):
        fitted2, _ = fit_tiny_mnist(seed=42)
        _, plan, X, srv = _plane(num_replicas=2)
        plan2 = export_plan(fitted2, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        try:
            srv.swap_plan(plan2)
            idx = srv.add_replica()
            rep = next(r for r in srv._replicas if r.index == idx)
            assert rep.plan.fingerprint == plan2.fingerprint
            futures = [srv.submit(X[i % len(X)]) for i in range(64)]
            for f in futures:
                f.result(timeout=30)
            assert all(f.plan_fingerprint == plan2.fingerprint for f in futures)
        finally:
            srv.close()

    def test_brownout_steps_apply_to_live_servers_and_revert(self):
        _, plan, X, srv = _plane(num_replicas=2, max_wait_ms=2.0, max_queue_depth=64)
        try:
            base_wait = srv._replicas[0].server.max_wait_s
            assert srv.enter_brownout_step() == "widen_deadlines"
            for rep in srv._replicas:
                assert rep.server.max_wait_s == pytest.approx(
                    base_wait * srv.brownout_wait_factor)
            assert srv.enter_brownout_step() == "aggressive_shed"
            for rep in srv._replicas:
                assert rep.server.max_queue_depth == 16
            assert srv.exit_brownout_step() == "aggressive_shed"
            assert srv._replicas[0].server.max_queue_depth == 64
            assert srv.exit_brownout_step() == "widen_deadlines"
            assert srv._replicas[0].server.max_wait_s == pytest.approx(base_wait)
            assert srv.exit_brownout_step() is None
        finally:
            srv.close()

    def test_reject_admissions_is_named_counted_and_bad_for_the_slo(self):
        slo = obs.SLOTracker([obs.SLOObjective("availability", kind="availability",
                                               target=0.99, min_events=1)])
        _, plan, X, srv = _plane(num_replicas=2, slo=slo)
        try:
            for _ in range(3):
                srv.enter_brownout_step()
            assert srv.brownout_steps == BROWNOUT_STEPS and srv.enter_brownout_step() is None
            with pytest.raises(ServerOverloaded, match="brownout"):
                srv.submit(X[0])
            stats = srv.stats()
            assert stats["rejected"] == 1 and stats["brownout_rejected"] == 1
            assert slo.verdict()["objectives"]["availability"]["bad_total"] == 1
            srv.exit_brownout_step()
            srv.submit(X[0]).result(timeout=30)
        finally:
            srv.close()


class TestExecWindow:
    def test_exec_p99_since_reads_only_the_window(self):
        """``exec_marks`` / ``exec_p99_since``: the p99 over what each
        replica's server generation served after the mark, an injected
        slow past left out; a replica swapped since has no entry."""
        from keystone_tpu_torch.utils.profiling import RequestSpan

        _, plan, X, srv = _plane(num_replicas=2)
        try:
            for rep in srv._replicas:
                rep.server.span_log.record(RequestSpan(
                    queue_wait_s=0.0, exec_s=5.0, batch_size=1, bucket=2, pad_fraction=0.5,
                    replica=rep.index))
            marks = srv.exec_marks()
            assert srv.exec_p99_since(marks) == {}
            for f in [srv.submit(X[i % len(X)]) for i in range(40)]:
                f.result(timeout=30)
            window = srv.exec_p99_since(marks)
            assert window and all(v < 5.0 for v in window.values())
            assert all(max(s.exec_s for s in rep.server.span_log.snapshot()) == 5.0
                       for rep in srv._replicas)  # the rings still hold the slow past
            srv.swap_replica_plan(0, plan)
            assert 0 not in srv.exec_p99_since(marks)
        finally:
            srv.close()


class TestLifecycle:
    def test_submit_after_close_raises_and_close_is_idempotent(self):
        _, plans = _gated_plans(2)
        srv = ReplicatedServer(plans, max_wait_ms=0.0)
        srv.close()
        srv.close()
        with pytest.raises(ServerClosed):
            srv.submit(np.zeros(4, np.float32))
        assert all(not r.server.is_alive for r in srv._replicas)

    def test_constructor_validation(self):
        _, plans = _gated_plans(1)
        with pytest.raises(ValueError, match="num_replicas"):
            ReplicatedServer(plans[0], num_replicas=0)
        with pytest.raises(ValueError, match="restart_budget"):
            ReplicatedServer(plans[0], num_replicas=1, restart_budget=-1)
        with pytest.raises(ValueError, match="empty"):
            ReplicatedServer([])
        fitted, _ = fit_tiny_mnist()
        other = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
        with pytest.raises(ValueError, match="signature"):
            ReplicatedServer([plans[0], other])

    def test_stats_aggregation_shape(self):
        _, plans = _gated_plans(2)
        with ReplicatedServer(plans, max_wait_ms=0.0) as srv:
            for f in [srv.submit(np.ones(4, np.float32)) for _ in range(6)]:
                f.result(timeout=10)
            stats = srv.stats()
        assert stats["completed"] == 6
        assert stats["p99_latency_s"] >= stats["p50_latency_s"] > 0.0
        assert set(stats["per_replica"]) == {0, 1}
        for s in stats["per_replica"].values():
            assert "p99_queue_wait_s" in s and "p99_exec_s" in s
            assert s["in_rotation"] and not s["evicted"] and s["plan_fingerprint"]
        assert set(stats["span_summary_by_replica"]) <= {0, 1}
        assert sum(v["num_spans"] for v in stats["span_summary_by_replica"].values()) == 6
