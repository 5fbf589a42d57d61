"""The port's SLO-closed-loop autoscaler
(``keystone_tpu_torch/serving/autoscale.py``) on the CPU: the reference's
cases (``tests/test_serving_autoscale.py``) on the port, less the seven
elasticity and brownout cases ``tests/test_torch_serving_replicas.py``
already carries (``TestElasticity``), then the port's controller held to
the reference's.

  - the controller state machine under a fake clock: scale-up on
    sustained WARN with a rising burn, no flapping inside a cooldown,
    scale-down only on sustained OK with idle budget, the brownout ladder
    entered past ``max_replicas`` and left LIFO on relief, the audit trail
    (trace events, decision log, stats, registry) and the thread;
  - the real plane: removal never picks the half-open probe replica,
    add / remove serialise against a hot swap, a plan sequence maps by
    rotation position, live admission knobs, a new generation under an
    active brownout;
  - against the reference: both controllers driven by the same scripted
    clock, SLO reads and plane signals give the same decision logs, every
    field included (inputs, thresholds, candidates and their prices,
    winner, reason, times), and the same stats;
  - ``run.py serve --autoscale`` on the CPU and the reference's refusals.
"""

import time

import numpy as np
import pytest

from keystone_tpu_torch import obs
from keystone_tpu_torch.serving import (
    BROWNOUT_STEPS,
    Autoscaler,
    MicroBatchServer,
    ReplicatedServer,
    ServerOverloaded,
    export_plan,
)
from tests._torch_serving_util import TINY_D_IN, fit_tiny_mnist


# ---------------------------------------------------------------------------
# Deterministic controller harness: fake clock, stub SLO, fake plane
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class StubSLO:
    """The two reads the controller makes, directly settable."""

    def __init__(self, state="OK", burn=0.0):
        self.state = state
        self.burn = burn

    def evaluate(self):
        return {"latency": self.state}

    def burn_rates(self):
        return {"latency": (self.burn, self.burn)}


class FakePlane:
    """The elasticity surface the controller drives, with an action log
    so ordering assertions are exact."""

    def __init__(self, replicas=2, registry=obs.MetricsRegistry, steps=BROWNOUT_STEPS):
        self.num_replicas = replicas
        self.queue_depth = 0
        self.outstanding = 0
        self._brownout = []
        self.log = []
        self.metrics = registry()
        self._steps = steps

    def autoscale_signals(self):
        return {
            "replicas": self.num_replicas,
            "in_rotation": self.num_replicas,
            "outstanding": self.outstanding,
            "queue_depth": self.queue_depth,
            "brownout_level": len(self._brownout),
            "brownout_steps": list(self._brownout),
        }

    def add_replica(self):
        self.num_replicas += 1
        self.log.append(("add", self.num_replicas))
        return self.num_replicas - 1

    def remove_replica(self):
        self.num_replicas -= 1
        self.log.append(("remove", self.num_replicas))
        return self.num_replicas

    @property
    def brownout_level(self):
        return len(self._brownout)

    @property
    def brownout_steps(self):
        return tuple(self._brownout)

    def enter_brownout_step(self):
        if len(self._brownout) >= len(self._steps):
            return None
        step = self._steps[len(self._brownout)]
        self._brownout.append(step)
        self.log.append(("enter", step))
        return step

    def exit_brownout_step(self):
        if not self._brownout:
            return None
        step = self._brownout.pop()
        self.log.append(("exit", step))
        return step


def make_controller(plane=None, slo=None, clock=None, **kw):
    plane = plane if plane is not None else FakePlane()
    slo = slo if slo is not None else StubSLO()
    clock = clock if clock is not None else FakeClock()
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("scale_up_sustain_s", 1.0)
    kw.setdefault("scale_down_sustain_s", 2.0)
    kw.setdefault("cooldown_s", 5.0)
    kw.setdefault("idle_queue_depth", 0)
    a = Autoscaler(plane, slo, clock=clock, **kw)
    return a, plane, slo, clock


def drive(a, clock, dt, n):
    """n ticks spaced dt apart on the fake clock; returns the actions."""
    out = []
    for _ in range(n):
        clock.advance(dt)
        rec = a.tick()
        if rec is not None:
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# The deterministic state-machine suite
# ---------------------------------------------------------------------------


class TestScaleUp:
    def test_sustained_warn_with_rising_burn_scales_up(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "WARN", 2.0
        a.tick()  # pressure starts; no sustain yet
        assert plane.log == []
        actions = drive(a, clock, 0.6, 2)  # t=1.2 > sustain 1.0
        assert [r["action"] for r in actions] == ["scale_up"]
        assert plane.num_replicas == 3
        assert a.scale_ups == 1
        assert actions[0]["inputs"]["state"] == "WARN"
        assert actions[0]["thresholds"]["max_replicas"] == 4

    def test_no_action_before_sustain_window(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "WARN", 2.0
        a.tick()
        assert drive(a, clock, 0.2, 4) == []  # t=0.8 < 1.0
        assert plane.num_replicas == 2

    def test_falling_burn_is_recovery_not_pressure(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "WARN", 5.0
        a.tick()
        for burn in (4.0, 3.0, 2.0, 1.5, 1.2, 1.1):
            slo.burn = burn
            clock.advance(0.5)
            assert a.tick() is None
        assert plane.num_replicas == 2  # the plane was healing itself

    def test_breach_counts_as_pressure_even_when_burn_falls(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "BREACH", 9.0
        a.tick()
        slo.burn = 8.0  # falling, but still a breach
        actions = drive(a, clock, 0.6, 2)
        assert [r["action"] for r in actions] == ["scale_up"]

    def test_intermittent_warn_never_sustains(self):
        """Alternating WARN/OK resets the sustain timer every other
        tick — the classic flap input produces ZERO actions."""
        a, plane, slo, clock = make_controller()
        for i in range(20):
            slo.state = "WARN" if i % 2 == 0 else "OK"
            slo.burn = 2.0 if i % 2 == 0 else 0.0
            clock.advance(0.6)
            assert a.tick() is None
        assert plane.log == []


class TestCooldown:
    def test_no_scale_action_inside_cooldown_window(self):
        """The acceptance pin: after one action, sustained pressure
        produces NOTHING until cooldown_s has elapsed — then exactly one
        more action."""
        a, plane, slo, clock = make_controller(cooldown_s=5.0)
        slo.state, slo.burn = "WARN", 3.0
        a.tick()
        actions = drive(a, clock, 0.6, 2)
        assert len(actions) == 1  # the first scale-up, at t=1.2
        t_action = actions[0]["t_s"]
        # Pressure stays sustained for the whole cooldown window: no
        # second action inside it.
        inside = drive(a, clock, 0.5, 9)  # t -> 5.7; 5.7-1.2=4.5 < 5.0
        assert inside == []
        # Past cooldown AND a fresh sustain window: exactly one more.
        after = drive(a, clock, 0.5, 4)  # t -> 7.7
        assert [r["action"] for r in after] == ["scale_up"]
        assert after[0]["t_s"] - t_action >= 5.0
        assert plane.num_replicas == 4

    def test_action_resets_sustain_timer(self):
        """Immediately after an action the pressure evidence is spent:
        even with cooldown 0 the next action needs a FULL new sustain
        window."""
        a, plane, slo, clock = make_controller(cooldown_s=0.0)
        slo.state, slo.burn = "WARN", 3.0
        a.tick()
        drive(a, clock, 1.2, 1)  # first scale-up
        assert plane.num_replicas == 3
        clock.advance(0.5)
        assert a.tick() is None  # sustain timer RESTARTS at this tick
        clock.advance(0.6)
        assert a.tick() is None  # 0.6 since the restart < 1.0
        clock.advance(0.5)
        assert a.tick() is not None  # 1.1 >= 1.0
        assert plane.num_replicas == 4


class TestScaleDown:
    def test_sustained_ok_idle_scales_down(self):
        a, plane, slo, clock = make_controller()
        plane.num_replicas = 3
        slo.state, slo.burn = "OK", 0.1
        a.tick()
        actions = drive(a, clock, 0.7, 3)  # t=2.1 >= sustain 2.0
        assert [r["action"] for r in actions] == ["scale_down"]
        assert plane.num_replicas == 2

    def test_ok_but_busy_never_scales_down(self):
        a, plane, slo, clock = make_controller()
        plane.num_replicas = 3
        plane.queue_depth = 10  # idle budget not met
        slo.state = "OK"
        assert drive(a, clock, 0.7, 10) == []
        assert plane.num_replicas == 3

    def test_outstanding_occupancy_blocks_scale_down(self):
        a, plane, slo, clock = make_controller(
            idle_outstanding_per_replica=0.5
        )
        plane.num_replicas = 3
        plane.outstanding = 2  # > 0.5 * 3
        slo.state = "OK"
        assert drive(a, clock, 0.7, 10) == []

    def test_never_below_min_replicas(self):
        a, plane, slo, clock = make_controller(min_replicas=2)
        plane.num_replicas = 2
        slo.state = "OK"
        assert drive(a, clock, 0.7, 10) == []
        assert plane.num_replicas == 2

    def test_warn_blocks_scale_down_even_when_idle(self):
        """A browned-out-free WARN plane with an empty queue must not
        shed capacity: scale-down is OK-gated."""
        a, plane, slo, clock = make_controller()
        plane.num_replicas = 3
        slo.state, slo.burn = "WARN", 5.0
        a.tick()
        for i in range(10):
            slo.burn = 5.0 - 0.2 * (i + 1)  # strictly falling: recovery
            clock.advance(0.7)
            assert a.tick() is None
        assert plane.num_replicas == 3


class TestBrownoutLadder:
    def test_ladder_climbs_past_max_replicas_and_exits_lifo(self):
        a, plane, slo, clock = make_controller(
            max_replicas=2, cooldown_s=1.0, scale_up_sustain_s=1.0,
            scale_down_sustain_s=1.0,
        )
        plane.num_replicas = 2  # already at the wall
        plane.queue_depth = 50  # real load pressure, not stale burn
        slo.state, slo.burn = "BREACH", 8.0
        a.tick()
        actions = drive(a, clock, 0.6, 12)
        entered = [r["step"] for r in actions
                   if r["action"] == "brownout_enter"]
        assert entered == list(BROWNOUT_STEPS)  # in ladder order
        assert plane.brownout_steps == BROWNOUT_STEPS
        # Relief: load subsides (queue drains). The stub SLO stays in
        # BREACH — rejections keep burning — and the exit must fire
        # anyway (the SLO-blind relief gate).
        plane.queue_depth = 0
        plane.outstanding = 0
        exits = [
            r["step"]
            for r in drive(a, clock, 0.6, 16)
            if r["action"] == "brownout_exit"
        ]
        assert exits == list(reversed(BROWNOUT_STEPS))  # strictly LIFO
        assert plane.brownout_level == 0

    def test_ladder_top_with_max_replicas_takes_no_further_action(self):
        a, plane, slo, clock = make_controller(
            max_replicas=2, cooldown_s=0.5,
        )
        plane.num_replicas = 2
        plane._brownout = list(BROWNOUT_STEPS)
        plane.queue_depth = 50  # no relief either
        slo.state, slo.burn = "BREACH", 9.0
        a.tick()
        assert drive(a, clock, 0.6, 10) == []

    def test_brownout_exit_precedes_scale_down(self):
        """Recovery unwinds the ladder BEFORE capacity leaves: with an
        active step and a scale-down-eligible plane, the exit fires
        first."""
        a, plane, slo, clock = make_controller(cooldown_s=1.0)
        plane.num_replicas = 3
        plane._brownout = ["widen_deadlines"]
        slo.state = "OK"
        a.tick()
        actions = drive(a, clock, 0.7, 8)
        kinds = [r["action"] for r in actions]
        assert kinds[0] == "brownout_exit"
        assert "scale_down" in kinds
        assert kinds.index("brownout_exit") < kinds.index("scale_down")


class TestDecisionAudit:
    def test_every_action_is_a_structured_traced_decision(self):
        with obs.tracing() as tracer:
            a, plane, slo, clock = make_controller()
            slo.state, slo.burn = "WARN", 2.0
            a.tick()
            drive(a, clock, 0.6, 2)
        events = [e for e in tracer.events
                  if e.get("name") == "autoscale.decision"]
        assert len(events) == 1
        args = events[0]["args"]
        assert args["action"] == "scale_up"
        assert args["ok"] is True
        # The cost.decision mirror: inputs + thresholds + action +
        # reason all ride the one event.
        assert args["inputs"]["state"] == "WARN"
        assert args["inputs"]["burn_fast"] == pytest.approx(2.0)
        assert args["thresholds"]["cooldown_s"] == 5.0
        assert "sustained WARN" in args["reason"]

    def test_decision_log_and_stats_block(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "WARN", 2.0
        a.tick()
        drive(a, clock, 0.6, 2)
        log = a.decision_log()
        assert len(log) == 1 and log[0]["action"] == "scale_up"
        st = a.stats()
        # The make_row audit contract: scale claims ride with the
        # decision count and the replica bounds in the SAME dict.
        assert st["scale_ups"] == 1
        assert st["num_decisions"] == 1
        assert st["min_replicas"] == 1 and st["max_replicas"] == 4
        assert st["replicas_high"] == 3 and st["replicas_low"] == 2
        assert st["decisions"][-1]["action"] == "scale_up"

    def test_failed_scale_up_is_an_audited_not_ok_decision(self):
        class FailingPlane(FakePlane):
            def add_replica(self):
                raise RuntimeError("spawn storm")

        plane = FailingPlane()
        a, plane, slo, clock = make_controller(plane=plane)
        slo.state, slo.burn = "WARN", 2.0
        a.tick()
        actions = drive(a, clock, 0.6, 2)
        assert len(actions) == 1
        assert actions[0]["action"] == "scale_up"
        assert actions[0]["ok"] is False
        assert a.failed_scale_ups == 1 and a.scale_ups == 0

    def test_registry_gauges_and_counters_publish(self):
        a, plane, slo, clock = make_controller()
        slo.state, slo.burn = "WARN", 2.0
        a.tick()
        drive(a, clock, 0.6, 2)
        snap = plane.metrics.snapshot()
        assert snap["autoscale.scale_ups"] == 1
        assert snap["autoscale.decisions"] == 1
        assert snap["autoscale.replicas"] == 3
        assert snap["autoscale.brownout_level"] == 0

    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="min_replicas"):
            Autoscaler(FakePlane(), StubSLO(), min_replicas=0)
        with pytest.raises(ValueError, match="max_replicas"):
            Autoscaler(FakePlane(), StubSLO(), min_replicas=3,
                       max_replicas=2)
        with pytest.raises(ValueError, match="SLOTracker"):
            Autoscaler(FakePlane(), None)

    def test_thread_lifecycle(self):
        """start()/close() run the same tick on a daemon thread and
        join it — the watchdog-style lifecycle run.py serve uses."""
        a, plane, slo, clock = make_controller(tick_interval_s=0.005)
        a.start()
        deadline = time.perf_counter() + 5.0
        while a.ticks == 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        a.close()
        assert a.ticks >= 1
        assert not a._thread.is_alive()


# ---------------------------------------------------------------------------
# The real plane: zero-drop elasticity primitives
# ---------------------------------------------------------------------------


def _plane(num_replicas=2, **kw):
    fitted, X = fit_tiny_mnist()
    plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32), max_batch=8)
    kw.setdefault("max_wait_ms", 0.5)
    kw.setdefault("watchdog_interval_s", 0.01)
    return plan, X, ReplicatedServer(plan, num_replicas=num_replicas, **kw)


class TestElasticityPrimitives:
    def test_remove_never_picks_half_open_probe_replica(self):
        """The probe replica's breaker is mid-recovery; evicting it
        would leave the probe outcome unobservable. Removal must pick
        another replica even when the probe one would win least-loaded
        selection."""
        plan, X, srv = _plane(num_replicas=3)
        try:
            # Force replica 2 (the tie-break winner: equal load, highest
            # index) into half_open: breaker open with the cooldown
            # already elapsed.
            probe_rep = srv._replicas[2]
            with probe_rep.server._lock:
                probe_rep.server._breaker_open = True
                probe_rep.server._breaker_opened_t = (
                    time.perf_counter() - 999.0
                )
            assert probe_rep.server.breaker_state == "half_open"
            removed = srv.remove_replica()
            assert removed != 2
            assert srv.num_replicas == 2
        finally:
            srv.close()

class TestElasticitySwapInteraction:
    def test_add_replica_serializes_against_swap_lock(self):
        """A replica added mid-swap would be invisible to the swap's
        membership snapshot and serve the OLD plan forever — add must
        block until the rollout releases the swap lock."""
        import threading

        plan, X, srv = _plane(num_replicas=2)
        added = []
        try:
            srv._swap_lock.acquire()
            t = threading.Thread(
                target=lambda: added.append(srv.add_replica())
            )
            t.start()
            t.join(timeout=0.3)
            assert t.is_alive() and not added  # blocked on the rollout
            srv._swap_lock.release()
            t.join(timeout=30)
            assert added == [2]
        finally:
            if srv._swap_lock.locked():  # pragma: no cover - guard
                srv._swap_lock.release()
            srv.close()

    def test_remove_replica_serializes_against_swap_lock(self):
        """A removal mid-rollout would hand the swap's ownership wait
        an already-retired replica (counters folded twice, a respawned
        worker no membership list tracks) — remove must block too."""
        import threading

        plan, X, srv = _plane(num_replicas=3)
        removed = []
        try:
            srv._swap_lock.acquire()
            t = threading.Thread(
                target=lambda: removed.append(srv.remove_replica())
            )
            t.start()
            t.join(timeout=0.3)
            assert t.is_alive() and not removed
            srv._swap_lock.release()
            t.join(timeout=30)
            assert removed and srv.num_replicas == 2
        finally:
            if srv._swap_lock.locked():  # pragma: no cover - guard
                srv._swap_lock.release()
            srv.close()

    def test_swap_sequence_maps_by_rotation_position(self):
        """With non-dense indices (remove + add), a per-replica plan
        sequence maps by position over the live membership — no plan
        silently dropped, none double-assigned."""
        plan, X, srv = _plane(num_replicas=3)
        plans = [
            export_plan(fit_tiny_mnist(seed=s)[0],
                        np.zeros(TINY_D_IN, np.float32), max_batch=8)
            for s in (10, 11, 12)
        ]
        try:
            srv.remove_replica()      # retires index 2
            idx = srv.add_replica()   # fresh index 3 -> members {0,1,3}
            assert idx == 3
            srv.swap_plan(plans)
            by_index = {r.index: r.plan.fingerprint
                        for r in srv._replicas}
            assert by_index == {
                0: plans[0].fingerprint,
                1: plans[1].fingerprint,
                3: plans[2].fingerprint,
            }
            with pytest.raises(ValueError, match="live membership"):
                srv.swap_plan(plans[:2])
        finally:
            srv.close()


class TestBrownoutMechanics:
    def test_set_admission_params_live(self):
        fitted, X = fit_tiny_mnist()
        plan = export_plan(fitted, np.zeros(TINY_D_IN, np.float32),
                           max_batch=8)
        srv = MicroBatchServer(plan, max_wait_ms=2.0, max_queue_depth=64)
        try:
            srv.set_admission_params(max_wait_ms=8.0, max_queue_depth=4)
            assert srv.max_wait_s == pytest.approx(8e-3)
            assert srv.max_queue_depth == 4
            with pytest.raises(ValueError):
                srv.set_admission_params(max_queue_depth=0)
            srv.submit(X[0]).result(timeout=30)  # still serves
        finally:
            srv.close()

    def test_new_generation_spawns_under_active_brownout(self):
        """A worker generation built while a step is active inherits the
        degraded admission knobs — a watchdog restart cannot silently
        undo a brownout."""
        plan, X, srv = _plane(num_replicas=2, max_wait_ms=2.0,
                              max_queue_depth=64)
        try:
            srv.enter_brownout_step()  # widen_deadlines
            srv.enter_brownout_step()  # aggressive_shed
            kw = srv._effective_server_kwargs()
            assert kw["max_wait_ms"] == pytest.approx(
                2.0 * srv.brownout_wait_factor
            )
            assert kw["max_queue_depth"] == 16
            idx = srv.add_replica()
            rep = next(r for r in srv._replicas if r.index == idx)
            assert rep.server.max_wait_s == pytest.approx(
                2.0 * srv.brownout_wait_factor / 1e3
            )
            assert rep.server.max_queue_depth == 16
        finally:
            srv.close()


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _script_ladder(a, plane, slo, clock):
    """Scale-up to the wall, the ladder climbed under load, unwound on
    relief while the SLO stays in breach, then scale-down once OK."""
    slo.state, slo.burn = "WARN", 2.0
    a.tick()
    for burn in (2.0, 2.5, 3.0, 3.0, 3.5, 4.0, 4.0, 4.5):
        slo.burn = burn
        clock.advance(0.6)
        a.tick()
    plane.queue_depth = 50
    slo.state, slo.burn = "BREACH", 8.0
    for _ in range(14):
        clock.advance(0.6)
        a.tick()
    plane.queue_depth = plane.outstanding = 0
    for _ in range(16):
        clock.advance(0.6)
        a.tick()
    slo.state, slo.burn = "OK", 0.1
    for _ in range(30):
        clock.advance(0.7)
        a.tick()


def _script_flaps(a, plane, slo, clock):
    """Flapping WARN/OK, a falling burn, a failed-free scale-up, busy OK."""
    for i in range(12):
        slo.state = "WARN" if i % 2 == 0 else "OK"
        slo.burn = 2.0 if i % 2 == 0 else 0.0
        clock.advance(0.6)
        a.tick()
    slo.state, slo.burn = "WARN", 5.0
    for burn in (4.0, 3.0, 2.0, 6.0, 6.5, 7.0, 7.0):
        slo.burn = burn
        clock.advance(0.5)
        a.tick()
    plane.queue_depth = 10
    slo.state, slo.burn = "OK", 0.0
    for _ in range(8):
        clock.advance(0.7)
        a.tick()
    plane.queue_depth, plane.outstanding = 0, 1
    for _ in range(12):
        clock.advance(0.7)
        a.tick()


class TestAgainstReference:
    @pytest.mark.parametrize("script,kw", [
        (_script_ladder, dict(max_replicas=3, cooldown_s=1.0, scale_down_sustain_s=1.0)),
        (_script_flaps, dict(cooldown_s=2.0, idle_outstanding_per_replica=0.5)),
    ])
    def test_decision_logs_are_the_references(self, script, kw, monkeypatch):
        from keystone_tpu import obs as j_obs
        from keystone_tpu.serving import BROWNOUT_STEPS as J_STEPS
        from keystone_tpu.serving import Autoscaler as JAutoscaler

        # The port prices with the EC2 family alone; the reference's is
        # chosen by the environment.
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        assert tuple(J_STEPS) == tuple(BROWNOUT_STEPS)
        out = []
        for cls, registry, steps in ((JAutoscaler, j_obs.MetricsRegistry, J_STEPS),
                                     (Autoscaler, obs.MetricsRegistry, BROWNOUT_STEPS)):
            plane = FakePlane(registry=registry, steps=steps)
            slo, clock = StubSLO(), FakeClock()
            a = cls(plane, slo, clock=clock, min_replicas=1, scale_up_sustain_s=1.0,
                    idle_queue_depth=0, **{"max_replicas": 4, "scale_down_sustain_s": 2.0,
                                           "cooldown_s": 5.0, **kw})
            script(a, plane, slo, clock)
            st = a.stats()
            out.append((a.decision_log(), plane.log, {k: v for k, v in st.items()}))
        (j_log, j_plane, j_st), (t_log, t_plane, t_st) = out
        assert t_log and t_log == j_log
        assert t_plane == j_plane
        assert t_st == j_st

    def test_ladder_script_reads_as_the_contract(self):
        a, plane, slo, clock = make_controller(max_replicas=3, cooldown_s=1.0,
                                               scale_down_sustain_s=1.0)
        _script_ladder(a, plane, slo, clock)
        kinds = [(r["action"], r.get("step")) for r in a.decision_log()]
        ups = [k for k in kinds if k[0] == "scale_up"]
        enters = [s for k, s in kinds if k == "brownout_enter"]
        exits = [s for k, s in kinds if k == "brownout_exit"]
        assert len(ups) == 1 and plane.log[0] == ("add", 3)
        assert enters == list(BROWNOUT_STEPS)
        assert exits == list(reversed(BROWNOUT_STEPS))
        assert plane.num_replicas == 1 and a.scale_downs == 2
        times = [r["t_s"] for r in a.decision_log()]
        assert all(b - a_ >= 1.0 - 1e-9 for a_, b in zip(times, times[1:]))


# ---------------------------------------------------------------------------
# run.py serve --autoscale
# ---------------------------------------------------------------------------

SERVE_TINY = ["serve", "--device", "cpu", "--input-dim", "32", "--numFFTs", "2",
              "--blockSize", "32", "--fit-n", "128", "--max-batch", "8", "--rate", "200",
              "--duration-s", "0.8"]


def _serve(capsys, *argv):
    import json

    from keystone_tpu_torch import run

    rc = run.main(list(SERVE_TINY) + list(argv))
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), out.err


class TestAutoscaleCLI:
    def test_autoscale_summary(self, capsys):
        rc, summary, err = _serve(capsys, "--autoscale", "--slo-p99-ms", "200",
                                  "--min-replicas", "2", "--max-replicas", "3",
                                  "--scale-cooldown-s", "0.5")
        assert rc == 0, err
        assert summary["num_offered"] == (summary["num_samples"] + summary["rejected"]
                                          + summary["failed"]) > 0
        assert summary["failed"] == 0
        # The plane starts inside the bounds (--replicas 1 is lifted to
        # the floor) and the audit companions ride beside the counters.
        assert summary["min_replicas"] == 2 and summary["max_replicas"] == 3
        assert 2 <= summary["replicas_low"] <= summary["replicas_high"] <= 3
        assert summary["replicas"] in (2, 3) and summary["healthy_replicas"] >= 2
        assert summary["num_decisions"] >= (summary["scale_ups"] + summary["scale_downs"]
                                            + summary["brownout_steps_entered"])
        assert summary["slo_state"] in ("OK", "WARN", "BREACH")
        assert summary["degraded"] is False and summary["evicted_replicas"] == []

    @pytest.mark.parametrize("argv,message", [
        (["--autoscale"], "needs a declared SLO"),
        (["--autoscale", "--slo-p99-ms", "0"], "needs a declared SLO"),
        (["--autoscale", "--slo-p99-ms", "100", "--min-replicas", "3", "--max-replicas", "2"],
         "--min-replicas (3) <= --max-replicas (2)"),
        (["--autoscale", "--slo-p99-ms", "100", "--min-replicas", "0"],
         "need 1 <= --min-replicas (0)"),
    ])
    def test_refusals(self, capsys, argv, message):
        rc, _, err = _serve(capsys, *argv)
        assert rc == 2 and message in err

    def test_bounds_without_autoscale_are_ignored(self, capsys):
        """The replica bounds only bind the controller: without
        --autoscale a plain single-server run ignores them, as the
        reference's does."""
        rc, summary, err = _serve(capsys, "--min-replicas", "3", "--max-replicas", "2")
        assert rc == 0, err
        assert "scale_ups" not in summary and summary["breaker_state"] == "closed"
