"""The port's LifecycleController (``keystone_tpu_torch/serving/lifecycle.py``),
held to the reference's own suite (``tests/test_serving_lifecycle.py``,
its 22 cases carried over on ``device="cpu"``) and to the reference where
both run: the validation gate (non-finite weights, bucket bit-identity
dry-run, held-out quality bound, fault-site failures fail closed), canary
rollout + rollback, the post-promotion attribution window, the rollback
ring, the staleness clock, and the ``lifecycle.decision`` audit trail.

The reference misses several of these cases on a multi-threaded CPU: its
gate rejects every good candidate with ``bucket_bit_identity``, since
XLA's CPU product sums by the padded row count. The port's plans take the
row-stable product (``cuda_ops.row_stable_matmul``'s plain version here),
so they pass. Tolerances against the reference: held-out scores within
1e-6 relative (float32 products summed in different orders).
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.serving import (
    LifecycleController,
    run_open_loop,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule
from keystone_tpu_torch.workflow import Transformer

from tests._torch_lifecycle_util import (
    D,
    K,
    export_small,
    fitted_linear,
    make_segments,
    make_w_true,
    small_plane,
    solve_ridge,
)


class FakeSLO:
    """worst_state() is the only surface the controller consumes."""

    def __init__(self):
        self.state = "OK"

    def worst_state(self):
        return self.state


@pytest.fixture
def w_true():
    return make_w_true()


@pytest.fixture
def holdout(w_true):
    segs = make_segments(1, w_true, n=256, seed=9)
    return segs[0]


def _controller(plane, plan0, holdout=None, **kw):
    kw.setdefault("canary_sustain_s", 0.0)  # unit tests: no canary
    kw.setdefault("attribution_window_s", 30.0)
    return LifecycleController(plane, plan0, holdout=holdout, **kw)


def _storm_thread(plane, duration_s=1.0, rate_hz=300.0, seed=0):
    """An UNSTARTED storm thread + its report holder — the caller
    starts and joins it in one scope (the thread-join lint contract)."""
    pool = np.random.default_rng(5).normal(size=(64, D)).astype(
        np.float32
    )
    holder = {}

    def _run():
        holder["report"] = run_open_loop(
            plane.submit, lambda i: pool[i % len(pool)],
            rate_hz=rate_hz, duration_s=duration_s, seed=seed,
        )

    return threading.Thread(target=_run), holder


class _FlakyHost(Transformer):
    """A transformer whose output depends on how many times it ran —
    the gate's bit-identity dry-run must catch it (no honest plan is
    nondeterministic)."""

    def __init__(self):
        self.calls = 0

    def apply(self, x):
        self.calls += 1
        return np.asarray(x) * float(self.calls)

    def batch_apply(self, ds):
        self.calls += 1
        c = float(self.calls)
        return ds.map_batch(lambda X: torch.as_tensor(X) * c)


class TestValidationGate:
    def test_nan_candidate_rejected_loudly(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            bad = fitted_linear(np.full((D, K), np.nan, np.float32))
            result = ctl.offer(bad)
            assert result["published"] is False
            assert result["reason"] == "non_finite_weights"
            assert ctl.rejected == 1
            assert ctl.incumbent_fingerprint == plan0.fingerprint
            # Zero requests ever served under the rejected fingerprint.
            assert result["fingerprint"] not in (
                plane.first_completion_times()
            )
            (dec,) = ctl.decision_log()
            assert dec["action"] == "reject"
            assert dec["reason"] == "non_finite_weights"
            assert "non_finite_at" in dec["inputs"]
        finally:
            plane.close()

    def test_inf_weights_also_rejected(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            W = np.array(w_true)
            W[0, 0] = np.inf
            result = ctl.offer(fitted_linear(W))
            assert result["reason"] == "non_finite_weights"
        finally:
            plane.close()

    def test_quality_regression_rejected(self, w_true, holdout):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0, holdout=holdout,
                              quality_bound=0.05)
            bad = fitted_linear(w_true + 1.0)  # badly perturbed model
            result = ctl.offer(bad)
            assert result["published"] is False
            assert result["reason"] == "quality_regression"
            (dec,) = ctl.decision_log()
            assert dec["inputs"]["candidate_score"] < (
                dec["inputs"]["incumbent_score"] - 0.05
            )
        finally:
            plane.close()

    def test_equal_quality_candidate_promotes(self, w_true, holdout):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0, holdout=holdout,
                              quality_bound=0.05)
            X, y = holdout
            cand = fitted_linear(solve_ridge(X, y))
            result = ctl.offer(cand)
            assert result["published"] is True
            assert ctl.published == 1
            assert ctl.incumbent_fingerprint == result["fingerprint"]
            # Every in-rotation replica now serves the new version.
            stats = plane.stats()
            assert {
                r["plan_fingerprint"]
                for r in stats["per_replica"].values()
            } == {result["fingerprint"]}
        finally:
            plane.close()

    def test_nondeterministic_plan_dies_at_the_dry_run(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            flaky = _FlakyHost()
            from tests._torch_serving_util import fitted_from_transformer

            result = ctl.offer(fitted_from_transformer(flaky))
            assert result["published"] is False
            assert result["reason"] == "bucket_bit_identity"
        finally:
            plane.close()

    def test_signature_mismatch_fails_closed(self, w_true):
        """A candidate with the wrong request signature is a
        validate_error rejection (ok=False), never a crash."""
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            from keystone_tpu_torch.serving import export_plan

            wide = np.zeros((D + 1, K), np.float32)
            from keystone_tpu_torch.ops.learning.linear import LinearMapper
            from keystone_tpu_torch.workflow.pipeline import (
                FittedPipeline,
                TransformerGraph,
            )

            pipe = LinearMapper(wide).to_pipeline()
            other = export_plan(
                FittedPipeline(
                    TransformerGraph.from_graph(pipe.executor.graph),
                    pipe.source, pipe.sink,
                ),
                np.zeros(D + 1, np.float32), max_batch=8, device="cpu",
            )
            result = ctl.offer(other)
            assert result["published"] is False
            assert result["reason"].startswith("validate_error")
            (dec,) = ctl.decision_log()
            assert dec["ok"] is False
        finally:
            plane.close()

    def test_validate_fault_site_fails_closed(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            plan = FaultPlan([
                FaultRule("lifecycle.validate", calls=[0])
            ])
            with plan.active():
                result = ctl.offer(fitted_linear(w_true))
            assert result["published"] is False
            assert result["reason"].startswith("validate_error")
            assert ctl.rejected == 1
            assert ctl.incumbent_fingerprint == plan0.fingerprint
        finally:
            plane.close()

    def test_publish_fault_site_leaves_incumbent_serving(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            cand = fitted_linear(w_true * 0.5)
            plan = FaultPlan([
                FaultRule("lifecycle.publish", calls=[0])
            ])
            with plan.active():
                result = ctl.offer(cand)
            assert result["published"] is False
            assert result["reason"].startswith("publish_error")
            assert ctl.incumbent_fingerprint == plan0.fingerprint
            (dec,) = ctl.decision_log()
            assert dec["action"] == "publish" and dec["ok"] is False
            # The same candidate publishes once the fault clears.
            result2 = ctl.offer(cand)
            assert result2["published"] is True
        finally:
            plane.close()

    def test_republishing_the_incumbent_is_a_noop(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            swaps_before = plane.swaps_completed
            result = ctl.offer(fitted_linear(w_true))
            assert result["published"] is True
            assert result["reason"] == "already_incumbent"
            assert plane.swaps_completed == swaps_before  # no rollout
        finally:
            plane.close()

    def test_rejection_metrics_and_counters(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            ctl.offer(fitted_linear(np.full((D, K), np.nan,
                                            np.float32)))
            snap = plane.metrics.snapshot()
            assert snap["lifecycle.rejected"] == 1
            assert snap["lifecycle.published"] == 0
        finally:
            plane.close()


class TestCanary:
    def test_good_candidate_promotes_through_the_canary(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(
                plane, plan0, canary_sustain_s=0.4,
                canary_min_samples=5,
            )
            t, holder = _storm_thread(plane, duration_s=1.5)
            t.start()
            time.sleep(0.3)
            result = ctl.offer(fitted_linear(w_true * 0.9))
            t.join()
            assert result["published"] is True
            assert result["canary"] is not None
            assert result["canary"]["regressed"] is False
            assert ctl.canary_promotions == 1
            report = holder["report"]
            assert report.num_offered == (
                report.completed + report.rejected + report.failed
            )
        finally:
            plane.close()

    def test_single_replica_plane_skips_the_canary(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0, num_replicas=1)
        try:
            ctl = LifecycleController(
                plane, plan0, canary_sustain_s=0.4,
            )
            result = ctl.offer(fitted_linear(w_true * 0.9))
            assert result["published"] is True
            assert result["canary"] is None
            assert ctl.canary_promotions == 0
            assert ctl.published == 1
        finally:
            plane.close()

    def test_ring_keeps_prior_plans_bounded(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0, rollback_ring=2)
            fps = [plan0.fingerprint]
            for scale in (0.9, 0.8, 0.7):
                r = ctl.offer(fitted_linear(w_true * scale))
                assert r["published"]
                fps.append(r["fingerprint"])
            # Ring holds the last TWO superseded versions, oldest out.
            assert ctl.ring_fingerprints() == fps[1:3]
        finally:
            plane.close()


class TestAttributionRollback:
    def _promoted(self, plane, plan0, slo, clock):
        ctl = _controller(plane, plan0, slo=slo, clock=clock,
                          attribution_window_s=10.0)
        result = ctl.offer(fitted_linear(make_w_true() * 0.5))
        assert result["published"]
        return ctl, result["fingerprint"]

    def test_slo_breach_in_window_rolls_back(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        t = {"now": 0.0}
        slo = FakeSLO()
        try:
            ctl, fp = self._promoted(plane, plan0, slo,
                                     lambda: t["now"])
            slo.state = "BREACH"
            t["now"] = 2.0
            rec = ctl.poll()
            assert rec is not None
            assert rec["action"] == "rollback"
            assert rec["fingerprint"] == fp
            assert ctl.rollbacks == 1
            assert ctl.incumbent_fingerprint == plan0.fingerprint
            # The plane is actually serving the prior plan again.
            stats = plane.stats()
            assert {
                r["plan_fingerprint"]
                for r in stats["per_replica"].values()
            } == {plan0.fingerprint}
        finally:
            plane.close()

    def test_degradation_after_window_is_not_attributed(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        t = {"now": 0.0}
        slo = FakeSLO()
        try:
            ctl, fp = self._promoted(plane, plan0, slo,
                                     lambda: t["now"])
            t["now"] = 11.0  # past the 10s window — probation served
            slo.state = "BREACH"
            assert ctl.poll() is None
            assert ctl.rollbacks == 0
            assert ctl.incumbent_fingerprint == fp
        finally:
            plane.close()

    def test_preexisting_degradation_is_not_blamed(self, w_true):
        """A candidate promoted into an already-WARN plane is never
        blamed for the pre-existing WARN — only a state WORSE than the
        promotion baseline attributes."""
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        t = {"now": 0.0}
        slo = FakeSLO()
        slo.state = "WARN"
        try:
            ctl, fp = self._promoted(plane, plan0, slo,
                                     lambda: t["now"])
            t["now"] = 2.0
            assert ctl.poll() is None  # still WARN: baseline, not new
            slo.state = "BREACH"
            rec = ctl.poll()
            assert rec is not None and rec["action"] == "rollback"
        finally:
            plane.close()

    def test_canary_pollution_grace_stands_down(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        t = {"now": 0.0}
        slo = FakeSLO()
        try:
            ctl, fp = self._promoted(plane, plan0, slo,
                                     lambda: t["now"])
            ctl._attribution_hold_until = 5.0  # a canary just rolled back
            slo.state = "BREACH"
            t["now"] = 2.0
            assert ctl.poll() is None  # pollution grace: stand down
            t["now"] = 6.0
            rec = ctl.poll()  # grace over, degradation persists: real
            assert rec is not None and rec["action"] == "rollback"
        finally:
            plane.close()

    def test_ok_state_never_rolls_back(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        t = {"now": 0.0}
        slo = FakeSLO()
        try:
            ctl, fp = self._promoted(plane, plan0, slo,
                                     lambda: t["now"])
            t["now"] = 2.0
            assert ctl.poll() is None
            assert ctl.incumbent_fingerprint == fp
        finally:
            plane.close()


class TestStaleness:
    def test_staleness_measured_from_data_time_to_first_serve(
        self, w_true
    ):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            data_time = time.monotonic()
            result = ctl.offer(fitted_linear(w_true * 0.5),
                               data_time=data_time)
            assert result["published"]
            # Serve a few requests so the new fingerprint completes.
            x = np.zeros(D, np.float32)
            for _ in range(4):
                plane.submit(x).result(timeout=10.0)
            ctl.poll()
            samples = ctl.staleness_samples()
            assert len(samples) == 1
            assert 0.0 <= samples[0] < 30.0
            stats = ctl.stats()
            assert stats["staleness_s"] == round(samples[0], 6)
            assert stats["staleness_num_samples"] == 1
            assert stats["pending_staleness"] == 0
            snap = plane.metrics.snapshot()
            assert snap["lifecycle.staleness_s"] == pytest.approx(
                samples[0]
            )
        finally:
            plane.close()

    def test_stats_block_shape(self, w_true):
        """The block the bench/learn summary embeds: num_published
        rides beside every staleness/rollback claim (the make_row
        lifecycle audit rule's contract)."""
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = _controller(plane, plan0)
            stats = ctl.stats()
            for key in ("published", "num_published", "rejected",
                        "rollbacks", "canary_promotions",
                        "staleness_s", "staleness_median_s",
                        "incumbent_fingerprint", "decisions",
                        "thresholds"):
                assert key in stats
        finally:
            plane.close()


class TestDecisionAudit:
    def test_decisions_land_on_the_tracer(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            with obs.tracing() as tracer:
                ctl = _controller(plane, plan0)
                ctl.offer(fitted_linear(np.full((D, K), np.nan,
                                                np.float32)))
                ctl.offer(fitted_linear(w_true * 0.5))
                events = [
                    e for e in tracer.events
                    if e.get("name") == "lifecycle.decision"
                ]
            assert [e["args"]["action"] for e in events] == [
                "reject", "publish"
            ]
            assert events[0]["args"]["reason"] == "non_finite_weights"
            assert events[1]["args"]["reason"] == "promoted"
            # Thresholds ride with every decision — the evidence shape.
            assert "quality_bound" in events[1]["args"]["thresholds"]
        finally:
            plane.close()

    def test_monitor_thread_lifecycle(self, w_true):
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(
                plane, plan0, canary_sustain_s=0.0,
                poll_interval_s=0.01,
            ).start()
            ctl.start()  # idempotent
            time.sleep(0.05)
            ctl.close()
            ctl.close()  # idempotent
        finally:
            plane.close()


class TestAgainstReference:
    """The port's gate against the reference's on the same weights and
    holdout (both packages on the CPU)."""

    @staticmethod
    def _reference_plan(W):
        from keystone_tpu.serving import export_plan as j_export

        from tests._lifecycle_util import fitted_linear as j_fitted_linear

        return j_export(j_fitted_linear(W), np.zeros(D, np.float32), max_batch=32)

    def test_default_score_matches(self, w_true, holdout):
        from keystone_tpu.serving.lifecycle import _default_score as j_score
        from keystone_tpu_torch.serving.lifecycle import _default_score

        X, y = holdout
        for W in (w_true, w_true + 0.1, solve_ridge(X, y)):
            got = _default_score(export_small(fitted_linear(W)), X, y)
            want = j_score(self._reference_plan(W), X, y)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-9)

    def test_non_finite_site_names_match(self, w_true):
        from keystone_tpu.serving.lifecycle import _non_finite_site as j_site
        from keystone_tpu_torch.serving.lifecycle import _non_finite_site

        W = np.array(w_true)
        W[1, 2] = np.nan
        assert _non_finite_site(export_small(fitted_linear(W)).graph) == (
            j_site(self._reference_plan(W).graph)) == "LinearMapper.x"
        assert _non_finite_site(export_small(fitted_linear(w_true)).graph) is None
        assert j_site(self._reference_plan(w_true).graph) is None

    def test_decision_records_have_the_reference_shape(self, w_true):
        from keystone_tpu.serving.lifecycle import LifecycleDecision as JDecision
        from keystone_tpu_torch.serving.lifecycle import LifecycleDecision

        kw = dict(action="reject", reason="non_finite_weights", fingerprint="abc",
                  t_s=1.5, ok=True, inputs={"non_finite_at": "LinearMapper.x"},
                  thresholds={"quality_bound": 0.05}, weights_family="ec2")
        assert LifecycleDecision(**kw).to_args() == JDecision(**kw).to_args()

    def test_same_thresholds_and_stats_keys(self, w_true):
        from keystone_tpu.serving import LifecycleController as JController
        from keystone_tpu.serving import ReplicatedServer as JServer

        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        j_plan0 = self._reference_plan(w_true)
        j_plane = JServer(j_plan0, num_replicas=2, max_batch=32, max_wait_ms=1.0)
        try:
            kw = dict(quality_bound=0.07, canary_sustain_s=0.0,
                      attribution_window_s=12.0, canary_pollution_grace_s=3.0)
            ctl = LifecycleController(plane, plan0, **kw)
            j_ctl = JController(j_plane, j_plan0, **kw)
            bad = np.full((D, K), np.nan, np.float32)
            r = ctl.offer(fitted_linear(bad))
            from tests._lifecycle_util import fitted_linear as j_fitted_linear

            j_r = j_ctl.offer(j_fitted_linear(bad))
            assert r["reason"] == j_r["reason"] == "non_finite_weights"
            stats, j_stats = ctl.stats(), j_ctl.stats()
            assert set(stats) == set(j_stats)
            assert stats["thresholds"] == j_stats["thresholds"]
            for key in ("published", "rejected", "rollbacks", "canary_promotions",
                        "num_decisions", "staleness_s", "pending_staleness"):
                assert stats[key] == j_stats[key], key
            (dec,), (j_dec,) = ctl.decision_log(), j_ctl.decision_log()
            # Fingerprints differ between the packages (module names are
            # part of a plan's identity); the rest of the record does not.
            assert {k: dec[k] for k in ("action", "reason", "ok", "thresholds")} == {
                k: j_dec[k] for k in ("action", "reason", "ok", "thresholds")}
            assert dec["winner"] == dec["fingerprint"] and j_dec["winner"] == j_dec["fingerprint"]
            assert dec["inputs"]["non_finite_at"] == j_dec["inputs"]["non_finite_at"]
        finally:
            plane.close()
            j_plane.close()
