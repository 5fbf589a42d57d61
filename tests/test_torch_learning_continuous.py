"""The port's continuous trainer (``keystone_tpu_torch/learning``), held to
the reference's own suite (``tests/test_learning_continuous.py``, its 18
cases carried over) and to the reference where both run: the
deterministic arriving-segment feed, the incremental normal-equations
fold, the publish-every-K cadence, and checkpoint/resume bit-identity.

Against the reference: the fold is host numpy float64 in both packages,
so the carry (G, C, n), the candidate weights and the checkpoint files
are compared bit for bit; the feed's arrival stamps exactly.
"""

import json
import threading
import time

import numpy as np
import pytest

from keystone_tpu_torch.data.durable import CheckpointSpec
from keystone_tpu_torch.learning import ContinuousTrainer, TimedSegmentFeed
from keystone_tpu_torch.obs.metrics import MetricsRegistry
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule

from tests._torch_lifecycle_util import (
    D,
    K,
    make_segments,
    make_w_true,
)


def _final_W(trainer):
    cand = trainer.candidates[-1]
    graph = cand.transformer_graph
    node = sorted(graph.nodes, key=repr)[0]
    return graph.get_operator(node).x.numpy()


class TestTimedSegmentFeed:
    def test_empty_feed_rejected(self):
        with pytest.raises(ValueError, match=">= 1 segment"):
            TimedSegmentFeed([])

    def test_offset_count_mismatch_rejected(self):
        segs = make_segments(3, make_w_true())
        with pytest.raises(ValueError, match="arrival offsets"):
            TimedSegmentFeed(segs, arrival_offsets=[0.0])

    def test_decreasing_offsets_rejected(self):
        segs = make_segments(3, make_w_true())
        with pytest.raises(ValueError, match="non-decreasing"):
            TimedSegmentFeed(segs, arrival_offsets=[0.0, 2.0, 1.0])

    def test_availability_follows_the_clock(self):
        segs = make_segments(3, make_w_true())
        t = {"now": 0.0}
        feed = TimedSegmentFeed(
            segs, arrival_offsets=[0.0, 1.0, 2.0],
            clock=lambda: t["now"],
        )
        assert feed.available() == 0  # not started
        feed.start()
        assert feed.available() == 1
        t["now"] = 1.5
        assert feed.available() == 2
        t["now"] = 5.0
        assert feed.available() == 3

    def test_start_is_idempotent_epoch(self):
        """Offsets are relative to the FIRST start — a resumed trainer
        sees the original arrival stamps."""
        segs = make_segments(2, make_w_true())
        t = {"now": 10.0}
        feed = TimedSegmentFeed(
            segs, arrival_offsets=[0.0, 1.0], clock=lambda: t["now"]
        )
        feed.start()
        t0 = feed.arrival_time(1)
        t["now"] = 50.0
        feed.start()
        assert feed.arrival_time(1) == t0 == 11.0

    def test_arrival_time_before_start_raises(self):
        feed = TimedSegmentFeed(make_segments(1, make_w_true()))
        with pytest.raises(RuntimeError, match="not started"):
            feed.arrival_time(0)

    def test_wait_for_respects_stop(self):
        segs = make_segments(2, make_w_true())
        feed = TimedSegmentFeed(segs, arrival_offsets=[0.0, 60.0])
        stop = threading.Event()
        stop.set()
        assert feed.wait_for(1, stop) is False


class TestTrainerFold:
    def test_final_candidate_matches_direct_ridge_solve(self):
        """The incremental fold over all segments equals the one-shot
        normal-equations solve over the concatenated data — exactly
        (the fold IS that solve, accumulated per segment)."""
        w_true = make_w_true()
        segs = make_segments(6, w_true)
        trainer = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=3, lam=1e-3
        )
        trainer.run()
        # Per-segment accumulation in the same order the trainer folds.
        G = np.zeros((D, D), np.float64)
        C = np.zeros((D, K), np.float64)
        for X, y in segs:
            X64 = X.astype(np.float64)
            G += X64.T @ X64
            C += X64.T @ y.astype(np.float64)
        W_direct = np.linalg.solve(
            G + 1e-3 * np.eye(D), C
        ).astype(np.float32)
        assert np.array_equal(_final_W(trainer), W_direct)

    def test_publish_cadence_includes_final_segment(self):
        """K=4 over 6 segments -> boundaries at segment 4 and at the
        final segment (a tail shorter than K is never unfitted)."""
        segs = make_segments(6, make_w_true())
        trainer = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=4
        )
        trainer.run()
        assert trainer.publishes == 2
        assert len(trainer.candidates) == 2
        assert trainer.segments_fit == 6

    def test_publish_every_segment(self):
        segs = make_segments(3, make_w_true())
        trainer = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=1
        )
        trainer.run()
        assert trainer.publishes == 3

    def test_invalid_publish_cadence_rejected(self):
        with pytest.raises(ValueError, match="publish_every_k"):
            ContinuousTrainer(
                TimedSegmentFeed(make_segments(1, make_w_true())),
                None, publish_every_k=0,
            )

    def test_metrics_counters(self):
        reg = MetricsRegistry()
        segs = make_segments(4, make_w_true())
        ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=2,
            metrics=reg,
        ).run()
        snap = reg.snapshot()
        assert snap["trainer.segments_fit"] == 4
        assert snap["trainer.resumes"] == 0


class TestCheckpointResume:
    def test_kill_mid_fit_resumes_bit_identically(self, tmp_path):
        """The headline contract: a trainer killed mid-fit (the
        ``trainer.fit`` fault site) restores the carry + cursor from
        its snapshot and the candidate it finally publishes is
        BIT-IDENTICAL to the uninterrupted run's."""
        w_true = make_w_true()
        segs = make_segments(9, w_true)
        ref = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=4
        )
        ref.run()
        W_ref = _final_W(ref)

        spec = CheckpointSpec(str(tmp_path), every_segments=2)
        plan = FaultPlan([
            FaultRule("trainer.fit", calls=[6], exc="RuntimeError")
        ])
        killed = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=4,
            checkpoint=spec,
        )
        with plan.active():
            with pytest.raises(RuntimeError, match="injected fault"):
                killed.run()
        assert killed.segments_fit == 6
        assert spec.has_snapshot()

        resumed = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=4,
            checkpoint=spec,
        )
        resumed.run()
        assert resumed.resumes == 1
        assert resumed.segments_fit == 3  # only the unfolded tail
        assert np.array_equal(_final_W(resumed), W_ref)
        # Completion spends the snapshot — a fresh identical fit starts
        # clean (the streamed-solver contract).
        assert not spec.has_snapshot()

    def test_thread_crash_is_recorded_loudly(self, tmp_path):
        segs = make_segments(4, make_w_true())
        plan = FaultPlan([
            FaultRule("trainer.fit", calls=[1], exc="RuntimeError")
        ])
        trainer = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=2,
            checkpoint=str(tmp_path),
        )
        with plan.active():
            trainer.start()
            trainer.join(timeout=30.0)
        assert isinstance(trainer.error, RuntimeError)
        assert trainer.stats()["error"] is not None

    def test_resume_metric_counter(self, tmp_path):
        reg = MetricsRegistry()
        segs = make_segments(5, make_w_true())
        spec = CheckpointSpec(str(tmp_path), every_segments=2)
        plan = FaultPlan([
            FaultRule("trainer.fit", calls=[3], exc="RuntimeError")
        ])
        with plan.active():
            with pytest.raises(RuntimeError):
                ContinuousTrainer(
                    TimedSegmentFeed(segs), None, publish_every_k=2,
                    checkpoint=spec, metrics=reg,
                ).run()
        ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=2,
            checkpoint=spec, metrics=reg,
        ).run()
        assert reg.snapshot()["trainer.resumes"] == 1

    def test_stale_fingerprint_does_not_seed(self, tmp_path):
        """A snapshot from a different λ must not seed this fit — the
        CheckpointSpec fingerprint guard, exercised through the
        trainer's fingerprint."""
        segs = make_segments(5, make_w_true())
        spec = CheckpointSpec(str(tmp_path), every_segments=2)
        plan = FaultPlan([
            FaultRule("trainer.fit", calls=[3], exc="RuntimeError")
        ])
        with plan.active():
            with pytest.raises(RuntimeError):
                ContinuousTrainer(
                    TimedSegmentFeed(segs), None, publish_every_k=2,
                    checkpoint=spec, lam=1e-3,
                ).run()
        other = ContinuousTrainer(
            TimedSegmentFeed(segs), None, publish_every_k=2,
            checkpoint=spec, lam=1e-2,  # different fit identity
        )
        other.run()
        assert other.resumes == 0
        assert other.segments_fit == 5  # folded everything itself


class TestArrivingSegments:
    def test_trainer_blocks_for_arrivals(self):
        """Segments arriving over real time: the trainer folds them as
        they land, and the run wall covers the arrival spread."""
        segs = make_segments(4, make_w_true(), n=32)
        feed = TimedSegmentFeed(
            segs, arrival_offsets=[0.0, 0.05, 0.1, 0.15]
        )
        trainer = ContinuousTrainer(feed, None, publish_every_k=2)
        t0 = time.perf_counter()
        trainer.run()
        assert time.perf_counter() - t0 >= 0.15
        assert trainer.segments_fit == 4

    def test_stop_interrupts_a_waiting_trainer(self):
        segs = make_segments(2, make_w_true(), n=32)
        feed = TimedSegmentFeed(segs, arrival_offsets=[0.0, 60.0])
        trainer = ContinuousTrainer(feed, None, publish_every_k=1)
        trainer.start()
        time.sleep(0.2)
        trainer.stop()
        trainer.join(timeout=10.0)
        assert trainer.error is None
        assert trainer.segments_fit == 1  # folded what had arrived


def _reference_final_W(trainer):
    cand = trainer.candidates[-1]
    graph = cand.transformer_graph
    node = sorted(graph.nodes, key=repr)[0]
    return np.asarray(graph.get_operator(node).x)


class TestAgainstReference:
    """The same segments through both packages' trainers."""

    def test_candidates_bit_equal(self):
        from keystone_tpu.learning import ContinuousTrainer as JTrainer
        from keystone_tpu.learning import TimedSegmentFeed as JFeed

        segs = make_segments(7, make_w_true(), seed=3)
        port = ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=3, lam=2e-3)
        ref = JTrainer(JFeed(segs), None, publish_every_k=3, lam=2e-3)
        assert port.run() == ref.run()
        assert len(port.candidates) == len(ref.candidates) == 3
        for c, jc in zip(port.candidates, ref.candidates):
            (node,), (jnode,) = c.transformer_graph.nodes, jc.transformer_graph.nodes
            got = c.transformer_graph.get_operator(node).x.numpy()
            want = np.asarray(jc.transformer_graph.get_operator(jnode).x)
            assert got.dtype == want.dtype and np.array_equal(got, want)

    def test_checkpointed_carry_bit_equal(self, tmp_path):
        """Both trainers killed at the same fold snapshot the same carry
        (G, C, n) under the same fit directory, and either package's
        snapshot resumes the other's trainer to the same weights."""
        from keystone_tpu.data.durable import CheckpointSpec as JSpec
        from keystone_tpu.learning import ContinuousTrainer as JTrainer
        from keystone_tpu.learning import TimedSegmentFeed as JFeed
        from keystone_tpu.utils.faults import FaultPlan as JPlan
        from keystone_tpu.utils.faults import FaultRule as JRule

        segs = make_segments(6, make_w_true(), seed=4)
        spec = CheckpointSpec(str(tmp_path / "port"), every_segments=2, runtime=False)
        j_spec = JSpec(str(tmp_path / "ref"), every_segments=2, runtime=False)
        with FaultPlan([FaultRule("trainer.fit", calls=[5], exc="RuntimeError")]).active():
            with pytest.raises(RuntimeError):
                ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=2,
                                  checkpoint=spec).run()
        with JPlan([JRule("trainer.fit", calls=[5], exc="RuntimeError")]).active():
            with pytest.raises(RuntimeError):
                JTrainer(JFeed(segs), None, publish_every_k=2, checkpoint=j_spec).run()
        fp = ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=2)._fingerprint(D, K)
        assert fp == JTrainer(JFeed(segs), None, publish_every_k=2)._fingerprint(D, K)
        assert spec._fit_dir(fp).rsplit("/", 1)[1] == j_spec._fit_dir(fp).rsplit("/", 1)[1]
        (carry, cursor), (j_carry, j_cursor) = spec.load(fp), j_spec.load(fp)
        assert cursor == j_cursor == 4
        for a, b in zip(carry, j_carry):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # Cross-resume: the port's trainer from the reference's snapshot.
        resumed = ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=2,
                                    checkpoint=CheckpointSpec(str(tmp_path / "ref"),
                                                              every_segments=2, runtime=False))
        resumed.run()
        full = ContinuousTrainer(TimedSegmentFeed(segs), None, publish_every_k=2)
        full.run()
        assert resumed.resumes == 1 and np.array_equal(_final_W(resumed), _final_W(full))

    def test_arrival_stamps_match(self):
        from keystone_tpu.learning import TimedSegmentFeed as JFeed

        segs = make_segments(4, make_w_true())
        t = {"now": 100.0}
        offsets = [0.0, 0.5, 0.5, 2.25]
        feed = TimedSegmentFeed(segs, arrival_offsets=offsets, clock=lambda: t["now"])
        j_feed = JFeed(segs, arrival_offsets=offsets, clock=lambda: t["now"])
        feed.start(), j_feed.start()
        for now in (100.0, 100.5, 101.0, 102.25, 200.0):
            t["now"] = now
            assert feed.available() == j_feed.available()
        assert [feed.arrival_time(i) for i in range(4)] == [
            j_feed.arrival_time(i) for i in range(4)]


class TestLearnCLI:
    """``python -m keystone_tpu_torch.run learn --device cpu``: one summary
    line with the reference's keys, the books balanced, every good
    candidate published; a killed trainer resumed through
    ``--checkpoint-dir``."""

    @staticmethod
    def _learn(capsys, *argv):
        import sys

        from keystone_tpu_torch import run

        # Each candidate's canary is judged on its exec-latency p99 over a
        # 1 s window (about its slowest batch) against the incumbents'
        # over their whole span ring. At Python's default 5 ms GIL switch
        # interval a replica thread on a loaded host (a parallel test run's
        # workers) now and then waits whole intervals mid-batch, and a good
        # candidate reads as a 3x regression and rolls back, as in
        # tests/test_torch_lifecycle.py's canary case. The interval is the
        # host's, not the gate's; the assertions stay.
        previous = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            rc = run.main(["learn", "--device", "cpu", "--duration-s", "3", *argv])
        finally:
            sys.setswitchinterval(previous)
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 else None), out.err

    def test_summary_line(self, capsys):
        rc, summary, _ = self._learn(capsys)
        assert rc == 0
        assert summary["accounting_ok"] is True
        # 24 segments, a candidate every 4: each passes the gate and is
        # promoted, or (a latency tail on a loaded host) its canary rolls
        # back; none is rejected at the gate.
        assert summary["gate_rejected"] == 0 and summary["num_published"] >= 3
        assert summary["num_published"] + summary["rollbacks"] == 6
        assert summary["trainer_segments_fit"] == 24 and summary["trainer_resumes"] == 0
        assert summary["staleness_s"] is not None and summary["replicas"] == 2
        for key in ("published", "rollbacks", "canary_promotions", "staleness_median_s",
                    "incumbent_fingerprint", "healthy_replicas", "p99_latency_ms",
                    "offered_rate_hz", "per_fingerprint_completed"):
            assert key in summary, key

    def test_timit_width(self, capsys):
        rc, summary, _ = self._learn(capsys, "--input-dim", "440", "--out-dim", "147",
                                     "--segments", "8")
        assert rc == 0 and summary["accounting_ok"] and summary["gate_rejected"] == 0
        assert summary["num_published"] >= 1
        assert summary["num_published"] + summary["rollbacks"] == 2

    def test_metrics_flags_are_refused(self, capsys, tmp_path):
        """The name is kept from when the live plane's flags were refused:
        ``learn --metrics-dir`` now writes a snapshot with the lifecycle and
        trainer sections."""
        d = tmp_path / "m"
        rc, summary, _ = self._learn(capsys, "--segments", "8", "--metrics-dir", str(d),
                                     "--metrics-interval-s", "0.2")
        assert rc == 0 and summary["accounting_ok"]
        with open(d / "live_metrics.json") as f:
            doc = json.load(f)
        assert doc["exporter"]["exporter.publishes"] >= 1
        assert doc["trainer"]["segments_fit"] == 8
        assert doc["lifecycle"]["published"] == summary["published"]
        assert doc["serving"]["completed"] == summary["num_samples"]

    def test_killed_trainer_resumes_through_checkpoint_dir(self, capsys, tmp_path,
                                                            monkeypatch):
        import os

        from keystone_tpu_torch.utils import faults

        # Set (empty) through monkeypatch, so the values the flags write
        # are undone after the test.
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_DIR", "")
        monkeypatch.setenv("KEYSTONE_FAULT_PLAN", "")
        monkeypatch.setenv("KEYSTONE_CHECKPOINT_EVERY", "2")
        plan = json.dumps({"rules": [{"site": "trainer.fit", "calls": [5],
                                      "exc": "RuntimeError"}]})
        # The flag installs its plan ambiently on the first fault-site
        # call after the variable is read; forget it around the run.
        faults._reset_env_cache()
        try:
            rc, _, err = self._learn(capsys, f"--checkpoint-dir={tmp_path}",
                                     f"--fault-plan={plan}", "--segments", "8")
        finally:
            faults.uninstall()
            monkeypatch.setenv("KEYSTONE_FAULT_PLAN", "")
            faults._reset_env_cache()
        assert rc == 1 and "trainer died mid-fit" in err
        assert any(name.startswith("fit-") for name in os.listdir(tmp_path))
        rc, summary, _ = self._learn(capsys, f"--checkpoint-dir={tmp_path}", "--segments", "8")
        assert rc == 0 and summary["trainer_resumes"] == 1
        assert summary["trainer_segments_fit"] == 4 and summary["accounting_ok"]
