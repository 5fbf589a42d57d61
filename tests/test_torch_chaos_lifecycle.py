"""Continuous-learning chaos suite of the port (its twin of
``tests/test_chaos_lifecycle.py``, the 4 cases carried over on
``device="cpu"``): a trainer killed mid-fit (``trainer.fit``) resumes
BIT-IDENTICALLY from its checkpoint and still publishes the same plan
fingerprint; an injected NaN candidate dies at the validation gate with a
``lifecycle.decision`` audit and ZERO requests served under its
fingerprint; an injected exec-latency regression passes the gate, is
caught by the canary under sustained Poisson load, and rolls back with
zero silent drops (offered == completed + rejected + failed throughout);
and the ``lifecycle.validate`` / ``lifecycle.publish`` fault sites fail
closed with the incumbent plan serving untouched.

The reference marks its sustained-Poisson canary leg ``slow``; here it
runs in the default tier (about 4 s).
"""

import threading
import time

import numpy as np
import pytest

import torch

from keystone_tpu_torch.data.durable import CheckpointSpec
from keystone_tpu_torch.learning import ContinuousTrainer, TimedSegmentFeed
from keystone_tpu_torch.ops.cuda_ops import row_stable_matmul
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
)

pytestmark = pytest.mark.chaos


def _accounting_ok(report):
    return report.num_offered == (
        report.completed + report.rejected + report.failed
    )


def _storm_thread(plane, duration_s, rate_hz=300.0, seed=0):
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


class _SlowSameModel(Transformer):
    """Quality-identical to a LinearMapper on the same weights (the same
    row-stable product), with a deliberate host sleep per batch — the
    injected canary latency regression."""

    def __init__(self, W, delay_s=0.03):
        self.W = np.asarray(W, np.float32)
        self.delay_s = float(delay_s)

    def apply(self, x):
        time.sleep(self.delay_s)
        return np.asarray(x) @ self.W

    def batch_apply(self, ds):
        time.sleep(self.delay_s)
        W = torch.from_numpy(self.W)
        return ds.map_batch(lambda X: row_stable_matmul(torch.as_tensor(X), W))


class TestKillTrainerMidFit:
    def test_killed_trainer_resumes_and_republishes_same_fingerprint(
        self, tmp_path
    ):
        """The full composition: the killed trainer's restart resumes
        the carry bit-identically, so the plan it finally publishes
        through the gate carries the SAME fingerprint an uninterrupted
        trainer's would — proven against a no-checkpoint reference
        run."""
        w_true = make_w_true()
        segs = make_segments(8, w_true)

        # Reference: uninterrupted trainer, final candidate exported at
        # the same signature -> the expected fingerprint.
        ref = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=4
        )
        ref.run()
        ref_fp = export_small(ref.candidates[-1]).fingerprint

        plan0 = export_small(fitted_linear(w_true * 0.0))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(plane, plan0,
                                      canary_sustain_s=0.0)
            spec = CheckpointSpec(str(tmp_path), every_segments=2)
            fault = FaultPlan([
                FaultRule("trainer.fit", calls=[5],
                          exc="RuntimeError")
            ])
            killed = ContinuousTrainer(
                TimedSegmentFeed(segs), ctl, publish_every_k=4,
                checkpoint=spec,
            )
            with fault.active():
                killed.start()
                killed.join(timeout=60.0)
            assert isinstance(killed.error, RuntimeError)
            assert spec.has_snapshot()
            # One publication (segment 4) landed before the kill.
            assert killed.stats()["published"] == 1

            resumed = ContinuousTrainer(
                TimedSegmentFeed(segs), ctl, publish_every_k=4,
                checkpoint=spec,
            )
            resumed.start()
            resumed.join(timeout=60.0)
            assert resumed.error is None
            assert resumed.resumes == 1
            assert resumed.stats()["published"] >= 1
            # The resumed trainer's final published plan IS the
            # uninterrupted run's — same fingerprint, same bits.
            assert ctl.incumbent_fingerprint == ref_fp
        finally:
            plane.close()


class TestGateUnderLoad:
    def test_nan_candidate_rejected_with_zero_served_under_it(self):
        """The NaN candidate dies at the gate while live traffic flows
        — a structured reject decision, zero requests ever served
        under its fingerprint, zero silent drops in the storm."""
        w_true = make_w_true()
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(plane, plan0,
                                      canary_sustain_s=0.0)
            t, holder = _storm_thread(plane, duration_s=1.2)
            t.start()
            time.sleep(0.3)
            result = ctl.offer(
                fitted_linear(np.full((D, K), np.nan, np.float32))
            )
            t.join()
            report = holder["report"]
            assert result["published"] is False
            assert result["reason"] == "non_finite_weights"
            bad_fp = result["fingerprint"]
            assert bad_fp not in plane.first_completion_times()
            assert bad_fp not in report.per_fingerprint_completed
            assert _accounting_ok(report)
            (dec,) = ctl.decision_log()
            assert dec["action"] == "reject"
        finally:
            plane.close()

    def test_validate_and_publish_faults_fail_closed_under_load(self):
        w_true = make_w_true()
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(plane, plan0,
                                      canary_sustain_s=0.0)
            cand = fitted_linear(w_true * 0.5)
            fault = FaultPlan([
                FaultRule("lifecycle.validate", calls=[0]),
                FaultRule("lifecycle.publish", calls=[0]),
            ])
            t, holder = _storm_thread(plane, duration_s=1.2)
            t.start()
            with fault.active():
                time.sleep(0.2)
                r1 = ctl.offer(cand)  # validate blows up -> reject
                r2 = ctl.offer(cand)  # publish blows up -> loud fail
            t.join()
            assert r1["reason"].startswith("validate_error")
            assert r2["reason"].startswith("publish_error")
            assert ctl.incumbent_fingerprint == plan0.fingerprint
            report = holder["report"]
            assert _accounting_ok(report)
            # The plane is intact: the incumbent kept serving through
            # both failures.
            assert report.completed > 0
            assert set(report.per_fingerprint_completed) == {
                plan0.fingerprint
            }
        finally:
            plane.close()


class TestCanaryRegressionUnderLoad:
    def test_latency_regression_caught_and_rolled_back(self):
        """The injected regression: same weights + a host sleep. It
        passes the gate (finite, bit-identical, quality-equal), the
        canary catches the exec-latency blowup under sustained Poisson
        load, and the plane rolls back — the full plane NEVER serves
        it, and nothing is silently dropped."""
        from tests._torch_serving_util import fitted_from_transformer

        w_true = make_w_true()
        segs = make_segments(1, w_true, n=256, seed=9)
        holdout = segs[0]
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            ctl = LifecycleController(
                plane, plan0, holdout=holdout, quality_bound=0.05,
                canary_sustain_s=0.6, canary_min_samples=5,
            )
            slow = fitted_from_transformer(
                _SlowSameModel(w_true, delay_s=0.03)
            )
            t, holder = _storm_thread(plane, duration_s=3.0)
            t.start()
            time.sleep(0.5)
            incumbent_before = ctl.incumbent_fingerprint
            result = ctl.offer(slow)
            t.join()
            report = holder["report"]
            assert result["published"] is False
            assert result["reason"] == "canary_latency_regression"
            canary = result["canary"]
            assert canary["regressed"] is True
            assert canary["canary_p99_exec_s"] > (
                ctl.canary_latency_factor
                * canary["incumbent_p99_exec_s"]
            )
            assert ctl.rollbacks == 1
            assert ctl.incumbent_fingerprint == incumbent_before
            # Rotation fully back on the incumbent.
            stats = plane.stats()
            assert {
                r["plan_fingerprint"]
                for r in stats["per_replica"].values()
                if r["in_rotation"]
            } == {incumbent_before}
            # Zero silent drops through swap-in, canary, and swap-back.
            assert _accounting_ok(report)
        finally:
            plane.close()

    def test_slow_canary_caught_after_a_slow_past(self):
        """The incumbents' span rings carry an old slow period (a second a
        batch): judged against the rings, a 30 ms canary would read as
        fast and promote. The port judges it against what the incumbents
        served in the same window, and rolls it back."""
        from keystone_tpu_torch.utils.profiling import RequestSpan
        from tests._torch_serving_util import fitted_from_transformer

        w_true = make_w_true()
        plan0 = export_small(fitted_linear(w_true))
        plane = small_plane(plan0)
        try:
            for rep in plane._replicas:
                for _ in range(200):
                    rep.server.span_log.record(RequestSpan(
                        queue_wait_s=0.0, exec_s=1.0, batch_size=1, bucket=2,
                        pad_fraction=0.5, replica=rep.index))
            ring = [r["p99_exec_s"] for r in plane.stats()["per_replica"].values()]
            assert min(ring) >= 1.0
            ctl = LifecycleController(plane, plan0, canary_sustain_s=0.6,
                                      canary_min_samples=5)
            t, holder = _storm_thread(plane, duration_s=2.5)
            t.start()
            time.sleep(0.4)
            result = ctl.offer(fitted_from_transformer(_SlowSameModel(w_true, delay_s=0.03)))
            t.join()
            assert result["reason"] == "canary_latency_regression"
            canary = result["canary"]
            assert canary["canary_p99_exec_s"] >= 0.03
            assert canary["incumbent_p99_exec_s"] < 1.0
            assert ctl.rollbacks == 1 and _accounting_ok(holder["report"])
        finally:
            plane.close()
