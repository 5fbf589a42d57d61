"""The autoscaler's chaos drills on the port (``tests/test_chaos_autoscale.py``'s
cases): a kill injected during a scale-up spawn
(``serving.autoscale.spawn``) is absorbed by the restart budget with zero
dropped requests; budget exhaustion fails the scale-up loudly while the
plane keeps serving at its size; the controller audits the failed
scale-up; and the closed loop (spike → WARN/BREACH → scale-up → recovery
→ quiesce → scale-down) keeps ``offered == completed + rejected +
failed`` on every leg. The closed-loop leg is marked ``slow`` as in the
reference.
"""

import time

import numpy as np
import pytest

from keystone_tpu_torch import obs
from keystone_tpu_torch.serving import (
    Autoscaler,
    ReplicatedServer,
    ServerDegraded,
    export_plan,
    run_open_loop,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist

pytestmark = pytest.mark.chaos


def _plane(num_replicas=2, **kw):
    fitted, X = fit_tiny_mnist()
    plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
    kw.setdefault("max_wait_ms", 0.5)
    kw.setdefault("watchdog_interval_s", 0.01)
    return plan, X, ReplicatedServer(plan, num_replicas=num_replicas, **kw)


class TestKillDuringScaleUp:
    def test_spawn_kill_absorbed_by_restart_budget(self):
        """The first scale-up spawn attempt dies at the injected fault
        site; the bounded retry absorbs it, the replica enters rotation
        warmed, and concurrent traffic sees ZERO drops."""
        plan, X, srv = _plane(num_replicas=2, restart_budget=3)
        kill = FaultPlan([FaultRule("serving.autoscale.spawn", "error",
                                    calls=[0])])
        try:
            futures = [srv.submit(X[i % len(X)]) for i in range(20)]
            with kill:
                idx = srv.add_replica()
            assert idx == 2
            assert kill.calls_seen("serving.autoscale.spawn") == 2
            for f in futures:
                f.result(timeout=30)  # traffic rode through the kill
            stats = srv.stats()
            assert stats["num_replicas"] == 3
            assert stats["replicas_added"] == 1
            assert stats["failed"] == 0 and stats["rejected"] == 0
            srv.submit(X[0]).result(timeout=30)
        finally:
            srv.close()

    def test_spawn_kills_past_budget_fail_loudly_plane_intact(self):
        """Every spawn attempt fails: add_replica raises the NAMED
        ServerDegraded after the budget, membership is unchanged, and
        the existing replicas keep serving."""
        plan, X, srv = _plane(num_replicas=2, restart_budget=2)
        storm = FaultPlan([FaultRule("serving.autoscale.spawn", "error",
                                     p=1.0)])
        try:
            with storm:
                with pytest.raises(ServerDegraded, match="spawn failed"):
                    srv.add_replica()
            stats = srv.stats()
            assert stats["num_replicas"] == 2
            assert stats["replicas_added"] == 0
            srv.submit(X[0]).result(timeout=30)  # still serving
        finally:
            srv.close()

    def test_controller_audits_the_failed_scale_up(self):
        """Driven through the CONTROLLER: a spawn storm past the budget
        surfaces as an ok=False autoscale.decision, not a dead control
        loop."""
        slo = obs.SLOTracker(
            [obs.SLOObjective(
                "latency", kind="latency", threshold_s=1e-6,
                target=0.9, fast_window_s=0.5, slow_window_s=1.0,
                min_events=1,
            )],
            clock=time.monotonic,
        )
        plan, X, srv = _plane(num_replicas=1, restart_budget=1, slo=slo)
        a = Autoscaler(
            srv, slo, min_replicas=1, max_replicas=3,
            scale_up_sustain_s=0.0, cooldown_s=0.0,
        )
        storm = FaultPlan([FaultRule("serving.autoscale.spawn", "error",
                                     p=1.0)])
        try:
            # Every completion misses the absurd 1µs bound: instant
            # sustained pressure.
            for i in range(12):
                srv.submit(X[i % len(X)]).result(timeout=30)
            with storm:
                rec = a.tick()
            assert rec is not None
            assert rec["action"] == "scale_up" and rec["ok"] is False
            assert a.failed_scale_ups == 1
            assert srv.num_replicas == 1
            srv.submit(X[0]).result(timeout=30)
        finally:
            a.close()
            srv.close()


class TestClosedLoopSpike:
    @pytest.mark.slow
    def test_spike_scaleup_recover_quiesce_zero_drop(self):
        """The acceptance drill, end to end with a REAL tracker and the
        control thread running: open-loop Poisson at a sustainable base
        rate, then a spike that drives the latency SLO into WARN/BREACH
        → the controller scales up; the spike ends, the verdict
        recovers, sustained idle drives scale-down — with
        offered == completed + rejected + failed on EVERY leg."""
        fitted, X = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32),
                           max_batch=8)
        single_s = plan.measure_single_request_s(reps=5)
        base_rate = 0.5 / single_s

        # Calibrate the latency bound off a short healthy storm (the
        # bench discipline): 3x healthy p99, so the base leg is OK and
        # the 8x spike's queue-wait blows through it.
        calib_srv = ReplicatedServer(plan, num_replicas=1,
                                     max_wait_ms=0.5,
                                     watchdog_interval_s=0.01)
        try:
            calib = run_open_loop(
                calib_srv.submit, lambda i: X[i % len(X)],
                rate_hz=base_rate, duration_s=1.0, seed=5,
            )
        finally:
            calib_srv.close()
        bound_s = max(3.0 * calib.p99_latency_s, 20.0 * single_s)

        slo = obs.SLOTracker([
            obs.SLOObjective(
                "latency", kind="latency", threshold_s=bound_s,
                target=0.9, fast_window_s=0.5, slow_window_s=2.0,
                breach_burn=4.0,
            ),
        ])
        srv = ReplicatedServer(plan, num_replicas=1, max_wait_ms=0.5,
                               max_queue_depth=512,
                               watchdog_interval_s=0.01, slo=slo)
        a = Autoscaler(
            srv, slo, min_replicas=1, max_replicas=3,
            tick_interval_s=0.02, scale_up_sustain_s=0.2,
            scale_down_sustain_s=0.5, cooldown_s=0.3,
            idle_queue_depth=2, idle_outstanding_per_replica=1.0,
        ).start()

        def leg(rate, duration, seed):
            report = run_open_loop(
                srv.submit, lambda i: X[i % len(X)],
                rate_hz=rate, duration_s=duration, seed=seed, slo=slo,
            )
            assert (report.completed + report.rejected + report.failed
                    == report.num_offered), "silent drop"
            return report

        try:
            base = leg(base_rate, 1.5, seed=31)
            spike = leg(8.0 * base_rate, 2.5, seed=32)
            assert a.scale_ups >= 1, (
                f"spike never scaled up (verdict {spike.slo['state']}, "
                f"decisions {a.decision_log()})"
            )
            # The SLO plane SAW the spike: some transition out of OK.
            transitions = [
                t for o in spike.slo["objectives"].values()
                for t in o["transitions"]
            ]
            assert any(t["to"] in ("WARN", "BREACH") for t in transitions)
            quiesce = leg(base_rate, 2.0, seed=33)
            # Post-scale recovery: the quiesce window's tail is back
            # under the calibrated bound.
            assert quiesce.p99_latency_s is not None
            # Sustained idle drives scale-down (poll past the sustain +
            # cooldown windows; the loadgen leg may end mid-window).
            deadline = time.perf_counter() + 10.0
            while a.scale_downs == 0 and time.perf_counter() < deadline:
                time.sleep(0.05)
            assert a.scale_downs >= 1, a.decision_log()
            st = a.stats()
            assert st["replicas_high"] >= 2
            assert st["num_decisions"] == len([
                d for d in (a.decision_log())
            ]) or st["num_decisions"] >= len(a.decision_log())
            # Every decision is in the audit log with its inputs.
            for d in a.decision_log():
                assert {"action", "reason", "inputs", "thresholds"} \
                    <= set(d)
        finally:
            a.close()
            srv.close()
