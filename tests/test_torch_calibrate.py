"""The port's cost-model calibration plane against the JAX package, on the CPU.

Twins of ``tests/test_calibrate.py``'s nine classes. The reference's golden
trace (``tests/data/calibration_trace``: a small disk-streamed fold plus four
recorded sweep rows, priced under the reference's TPU family) goes through
both packages' ``join_decisions``, ``calibration_report``, ``refit``,
``drift_gate`` and calibration CLI, with ``KEYSTONE_COST_WEIGHTS=tpu`` on
both sides (the family the fixture was priced under; the port's default is
``ec2``). What is held, and to what: the joins equal field for field; the
reports equal as dicts (the same mis-route row, regret 6.098 s); refit
weights within 1e-9 relative; the same drift verdicts and CLI exit codes.
The port's own parts (its stamped fits, the family switch, the queued-span
timing) are checked on their own.
"""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.obs import calibrate as cal
from keystone_tpu_torch.obs import flight
from keystone_tpu_torch.obs import tracer as tracer_mod
from keystone_tpu_torch.obs.metrics import MetricsRegistry
from keystone_tpu_torch.ops.learning import cost as cost_mod
from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator, candidate_label
from keystone_tpu_torch.tools import calibrate as cal_cli

from keystone_tpu.obs import calibrate as jcal
from keystone_tpu.obs import tracer as jtracer_mod
from keystone_tpu.tools import calibrate as jcal_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "calibration_trace")

BLOCK_MEASURED = 0.327
STREAM_MEASURED = 4.107
GRAM_MEASURED = 1.805
GATHER_MEASURED = 7.903


@pytest.fixture(autouse=True)
def _tpu_family(monkeypatch):
    """Both packages price under the fixture's family; no tracer leaks."""
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")
    yield
    tracer_mod._ACTIVE = None
    jtracer_mod._ACTIVE = None


@pytest.fixture(scope="module")
def events():
    return obs.load_events(FIXTURE)


@pytest.fixture(scope="module")
def outcomes(events):
    return cal.join_decisions(events)


def _asdict(o):
    return dataclasses.asdict(o)


def _perturbed(module):
    w = dict(module.family_weights("tpu"))
    w["cpu"] *= 25.0
    w["mem"] *= 25.0
    w["name"] = "perturbed"
    return w


class TestJoin:
    def test_joins_equal_the_reference(self, events, outcomes):
        want = jcal.join_decisions(events)
        assert [_asdict(o) for o in outcomes] == [_asdict(o) for o in want]
        assert sorted(o.joined_via for o in outcomes) == ["outcome"] * 6 + ["spans"]

    def test_recorded_sweep_values_joined_exactly(self, outcomes):
        sweeps = {o.winner: o for o in outcomes if o.decision == "calibration_sweep"}
        assert sweeps["BlockLeastSquaresEstimator"].measured_s == BLOCK_MEASURED
        assert sweeps["StreamingLeastSquaresChoice"].measured_s == STREAM_MEASURED
        assert sweeps["SparseLBFGSwithL2[gram]"].measured_s == GRAM_MEASURED
        assert sweeps["SparseLBFGSwithL2[gather]"].measured_s == GATHER_MEASURED
        assert all(o.weights.get("family") == "tpu" for o in sweeps.values())

    def test_span_window_join_sums_fold_chunks(self, events, outcomes):
        (o,) = [o for o in outcomes if o.joined_via == "spans"]
        decisions = sorted((e for e in events if e.get("type") == "event"
                            and e["name"] == "cost.decision"), key=lambda e: e["ts_us"])
        t0, t1 = decisions[0]["ts_us"], decisions[1]["ts_us"]
        expected = sum(s["dur_us"] for s in events if s.get("type") == "span"
                       and s["name"] == "fold.segment" and t0 <= s["ts_us"] < t1) / 1e6
        assert expected > 0 and o.measured_s == pytest.approx(expected, abs=1e-9)
        assert o.timing == "spans"
        assert o.span_counts["fold.segment"] > 0 and o.span_counts["prefetch.read"] > 0

    def test_queued_fold_spans_are_marked_and_left_out_of_the_refit(self, events):
        """The port's difference: fold spans that closed at enqueue (on the
        card) carry ``queued=True``; a decision joined through them is timed
        ``spans_queued``, counted in the report's mix, and not refit from."""
        marked = [dict(e, args={**e.get("args", {}), "queued": True})
                  if e.get("type") == "span" and e["name"] == "fold.segment" else e
                  for e in events]
        (o,) = [o for o in cal.join_decisions(marked) if o.joined_via == "spans"]
        assert o.timing == cal.QUEUED_TIMING
        assert cal.calibration_report(marked)["timings"][cal.QUEUED_TIMING] == 1
        plain = cal.fit_weights(cal.join_decisions(events))
        queued = cal.fit_weights(cal.join_decisions(marked))
        assert queued["num_rows"]["sequential"] == plain["num_rows"]["sequential"] - 1

    def test_back_annotated_decision_links_its_fit_span(self, events, outcomes):
        (o,) = [o for o in outcomes if o.decision == "least_squares_solver"
                and o.joined_via == "outcome" and o.winner == "StreamingLeastSquaresChoice"]
        (fit,) = [s for s in events if s.get("type") == "span"
                  and s["name"] == "estimator.fit" and s["span_id"] == o.span_id]
        assert o.measured_s >= fit["dur_us"] / 1e6 - 1e-3


class TestErrorMath:
    def test_log_error_definition(self):
        o = cal.DecisionOutcome(run_id="r", decision="d", winner="w", reason="argmin",
                                predicted_s=2.0, measured_s=4.0)
        assert o.log_error() == pytest.approx(math.log(2.0))
        assert o.log_error(predicted=8.0) == pytest.approx(-math.log(2.0))

    @pytest.mark.parametrize("kinds", [cal.CALIBRATED_DECISIONS, ("calibration_sweep",)])
    def test_reports_equal_the_reference(self, events, kinds):
        assert cal.calibration_report(events, kinds=kinds) == \
            jcal.calibration_report(events, kinds=kinds)

    @pytest.mark.parametrize("family", ["tpu", "ec2", "perturbed"])
    def test_repredicted_reports_equal_the_reference(self, events, family):
        if family == "perturbed":
            w, jw = _perturbed(cal), _perturbed(jcal)
        else:
            w, jw = cal.family_weights(family), jcal.family_weights(family)
        assert w == jw
        got = cal.calibration_report(events, weights=w)
        want = jcal.calibration_report(events, weights=jw)
        assert got["per_engine"].keys() == want["per_engine"].keys()
        for label, eng in want["per_engine"].items():
            for key, v in eng.items():
                assert got["per_engine"][label][key] == pytest.approx(v, rel=1e-12), key
        for key in ("median_abs_log_error", "median_log_error", "total_regret_s"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        assert got["misroutes"] == want["misroutes"]

    def test_reprediction_under_recorded_family_matches(self, outcomes):
        tpu = cal.family_weights("tpu")
        for o in outcomes:
            if o.decision == "calibration_sweep":
                assert cal.predict_seconds(o.winner, o.context, tpu) == \
                    pytest.approx(o.predicted_s, rel=1e-9)

    def test_registry_metrics_equal_the_reference(self, outcomes, events):
        from keystone_tpu.obs.metrics import MetricsRegistry as JRegistry

        reg, jreg = MetricsRegistry(), JRegistry()
        cal.calibration_report(list(outcomes), registry=reg)
        jcal.calibration_report(jcal.join_decisions(events), registry=jreg)
        assert reg.snapshot() == jreg.snapshot()
        assert reg.snapshot()["calibration.regret_s"] == pytest.approx(
            GATHER_MEASURED - GRAM_MEASURED, abs=1e-6)


class TestMisroute:
    def test_worked_misroute_measured_evidence(self, outcomes, events):
        report = cal.calibration_report(list(outcomes))
        (m,) = report["misroutes"]
        assert m == jcal.calibration_report(events)["misroutes"][0]
        assert (m["winner"], m["faster_candidate"], m["evidence"]) == (
            "SparseLBFGSwithL2[gather]", "SparseLBFGSwithL2[gram]", "measured")
        assert m["regret_s"] == pytest.approx(6.098, abs=1e-6)

    @staticmethod
    def _decision(winner, candidates, ctx, measured, ts=0):
        return {"type": "event", "name": "cost.decision", "run_id": "r1", "ts_us": ts,
                "args": {"decision": "least_squares_solver", "winner": winner,
                         "reason": "argmin", "candidates": candidates,
                         "outcome": {"measured_s": measured}, **ctx}}

    CTX_A = {"n": 1000, "d": 64, "k": 2, "sparsity": 1.0, "machines": 1}
    CTX_B = {"n": 2000, "d": 64, "k": 2, "sparsity": 1.0, "machines": 1}

    @pytest.mark.parametrize("case", ["no_evidence", "calibrated", "infeasible"])
    def test_claims_equal_the_reference(self, case):
        block = "BlockLeastSquaresEstimator"
        dense = "DenseLBFGSwithL2"
        if case == "no_evidence":
            recs = [self._decision(dense, [
                {"label": dense, "cost_s": 0.5, "feasible": True},
                {"label": block, "cost_s": 0.001, "feasible": True}], self.CTX_A, 10.0)]
            want_n = 0
        else:
            recs = [
                self._decision(block, [{"label": block, "cost_s": 0.5, "feasible": True}],
                               self.CTX_A, 2.0, ts=0),
                self._decision(dense, [
                    {"label": dense, "cost_s": 9.0, "feasible": True},
                    {"label": block, "cost_s": 1.0, "feasible": case == "calibrated"}],
                    self.CTX_B if case == "calibrated" else self.CTX_A, 10.0, ts=10),
            ]
            want_n = 1 if case == "calibrated" else 0
        got = cal.calibration_report(recs)["misroutes"]
        assert got == jcal.calibration_report(recs)["misroutes"]
        assert len(got) == want_n
        if want_n:
            assert got[0]["evidence"] == "calibrated"
            assert got[0]["faster_estimate_s"] == pytest.approx(4.0)
            assert got[0]["regret_s"] == pytest.approx(6.0)


class TestRefitRoundTrip:
    @pytest.fixture(scope="class")
    def refits(self, events, tmp_path_factory):
        os.environ["KEYSTONE_COST_WEIGHTS"] = "tpu"
        try:
            out = str(tmp_path_factory.mktemp("cal") / "calibration.json")
            got = cal.refit(events, out_path=out, kinds=("calibration_sweep",))
            want = jcal.refit(events, kinds=("calibration_sweep",))
        finally:
            del os.environ["KEYSTONE_COST_WEIGHTS"]
        return got, want

    def test_refit_weights_equal_the_reference(self, refits):
        got, want = refits
        for key in ("cpu", "mem", "network", "sparse_gather_overhead",
                    "srht_sketch_overhead", "countsketch_overhead", "zoo_page_overhead"):
            assert got["weights"][key] == pytest.approx(want["weights"][key], rel=1e-9), key
        assert got["weights"]["fitted"] == want["weights"]["fitted"]
        assert got["weights"]["num_rows"] == want["weights"]["num_rows"]
        for side in ("before", "after"):
            assert got[side]["median_abs_log_error"] == pytest.approx(
                want[side]["median_abs_log_error"], rel=1e-9)

    def test_refit_improves_on_perturbed_family(self, events, refits):
        got, _ = refits
        rep = cal.calibration_report(events, weights=_perturbed(cal),
                                     kinds=("calibration_sweep",))
        assert cal.drift_gate(rep)["drifted"]
        assert got["after"]["median_abs_log_error"] < rep["median_abs_log_error"]
        assert got["after"]["median_abs_log_error"] <= got["before"]["median_abs_log_error"]
        assert got["weights"]["network"] == cost_mod.TPU_NETWORK_WEIGHT  # pinned

    def test_artifact_provenance(self, refits):
        doc = cal.load_calibration_artifact(refits[0]["artifact_path"])
        assert (doc["format"], doc["version"]) == (cal.ARTIFACT_FORMAT, cal.ARTIFACT_VERSION)
        prov = doc["provenance"]
        assert prov["run_ids"] == ["calfixture0001"]
        assert prov["num_decisions"] == prov["num_measured"] == 4
        assert set(prov["fitted"]) == {"cpu", "mem", "sparse_gather_overhead"}
        # Either package reads the other's artifact.
        assert jcal.load_calibration_artifact(refits[0]["artifact_path"])["weights"] == \
            doc["weights"]

    def test_calibrated_family_prices_like_the_reference(self, refits, monkeypatch):
        """Under the refit artifact both packages' selectors price the
        reference's replay geometries alike (the decision tables themselves
        are held in tests/test_torch_cost_audit.py)."""
        from keystone_tpu.ops.learning import cost as jcost

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{refits[0]['artifact_path']}")
        w = refits[0]["weights"]
        assert cost_mod.active_weights() == jcost.active_weights() == (
            w["cpu"], w["mem"], w["network"])
        assert cost_mod.weights_family_name() == jcost.weights_family_name() == "calibrated"
        est = LeastSquaresEstimator(lam=1e-4, hbm_bytes=48 << 30)
        by_label = {candidate_label(o[0]): o[0] for o in est.options}
        n, d, k = 262_144, 16_384, 147
        c = {label: e.cost(n, d, k, 1.0, 1, est.cpu_weight, est.mem_weight,
                           est.network_weight) for label, e in by_label.items()}
        assert c["BlockLeastSquaresEstimator"] < c["StreamingLeastSquaresChoice"]
        assert c["BlockLeastSquaresEstimator"] < c["DenseLBFGSwithL2"]


class TestArtifact:
    @staticmethod
    def _weights(**over):
        w = {"cpu": 1e-14, "mem": 1e-11, "network": 1e-11, "sparse_gather_overhead": 400.0,
             "fitted": ["cpu"], "num_rows": {}}
        w.update(over)
        return w

    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "a.json")
        cal.write_calibration_artifact(path, self._weights(), {"run_ids": ["r"]})
        doc = cal.load_calibration_artifact(path)
        assert doc["weights"]["cpu"] == 1e-14 and doc["provenance"]["run_ids"] == ["r"]

    @pytest.mark.parametrize("content", [
        "not json at all",
        json.dumps({"format": "something-else", "version": 1}),
        json.dumps({"format": cal.ARTIFACT_FORMAT, "version": 99, "weights": {}}),
        json.dumps({"format": cal.ARTIFACT_FORMAT, "version": 1}),
        json.dumps({"format": cal.ARTIFACT_FORMAT, "version": 1,
                    "weights": {"cpu": -1, "mem": 1, "network": 1}}),
        json.dumps({"format": cal.ARTIFACT_FORMAT, "version": 1,
                    "weights": {"cpu": 1, "mem": 1, "network": 1,
                                "sparse_gather_overhead": "x"}}),
    ])
    def test_malformed_artifacts_raise_naming_path(self, tmp_path, content):
        p = tmp_path / "bad.json"
        p.write_text(content)
        with pytest.raises(ValueError, match="bad.json"):
            cal.load_calibration_artifact(str(p))
        with pytest.raises(ValueError, match="bad.json"):
            jcal.load_calibration_artifact(str(p))

    def test_env_with_missing_artifact_raises_naming_variable(self, monkeypatch, tmp_path):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{tmp_path}/nope.json")
        with pytest.raises(ValueError, match="KEYSTONE_COST_WEIGHTS"):
            cost_mod.active_weights()

    def test_refreshed_artifact_is_picked_up(self, monkeypatch, tmp_path):
        path = str(tmp_path / "w.json")
        cal.write_calibration_artifact(path, self._weights(cpu=1e-14), {})
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{path}")
        assert cost_mod.active_weights()[0] == 1e-14
        cal.write_calibration_artifact(path, self._weights(cpu=2e-14), {})
        os.utime(path, ns=(1, 1))
        assert cost_mod.active_weights()[0] == 2e-14

    def test_null_overheads_fall_back_to_ec2(self, monkeypatch, tmp_path):
        """The port's default family stands in for an artifact's null
        overhead (the reference's stands in with its TPU constant)."""
        path = str(tmp_path / "w.json")
        cal.write_calibration_artifact(path, self._weights(sparse_gather_overhead=None), {})
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{path}")
        assert cost_mod.sparse_gather_overhead() == cost_mod.EC2_SPARSE_GATHER_OVERHEAD
        assert cost_mod.srht_sketch_overhead() == cost_mod.EC2_SRHT_SKETCH_OVERHEAD
        assert cost_mod.zoo_page_overhead() == cost_mod.EC2_ZOO_PAGE_OVERHEAD

    @pytest.mark.parametrize("bad", ["calibratd:/x.json", "gpu", "tpu2"])
    def test_unknown_family_raises_naming_variable(self, monkeypatch, bad):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", bad)
        with pytest.raises(ValueError, match="KEYSTONE_COST_WEIGHTS"):
            cost_mod.active_weights()

    def test_calibrated_prefix_case_insensitive(self, monkeypatch, tmp_path):
        path = str(tmp_path / "Case.json")
        cal.write_calibration_artifact(path, self._weights(cpu=5e-15), {})
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"Calibrated:{path}")
        assert cost_mod.active_weights()[0] == 5e-15
        assert cost_mod.weights_family_name() == "calibrated"

    def test_family_names(self, monkeypatch, tmp_path):
        monkeypatch.delenv("KEYSTONE_COST_WEIGHTS", raising=False)
        assert cost_mod.weights_family_name() == "ec2"  # the port's default
        assert cost_mod.active_weights() == (
            cost_mod.EC2_CPU_WEIGHT, cost_mod.EC2_MEM_WEIGHT, cost_mod.EC2_NETWORK_WEIGHT)
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")
        assert cost_mod.weights_family_name() == "tpu"
        path = str(tmp_path / "w.json")
        cal.write_calibration_artifact(path, self._weights(), {})
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{path}")
        assert cost_mod.weights_family_name() == "calibrated"
        w = cal.family_weights(f"calibrated:{path}")
        assert w["name"] == "calibrated" and w["cpu"] == 1e-14


class _StampingProblem:
    @staticmethod
    def problem(n=512, d=32, k=3):
        rng = np.random.default_rng(7)
        X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        Y = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
        s = Dataset.of(X[:24])
        s.total_n = n
        return Dataset.of(X), Dataset.of(Y), s, Dataset.of(Y[:24])


class TestOutcomeStamping(_StampingProblem):
    def test_executor_stamps_measured_outcome(self):
        data, labels, s, ls = self.problem()
        est = LeastSquaresEstimator(lam=1e-3, hbm_bytes=48 << 30)
        with obs.tracing() as t:
            chosen = est.optimize(s, ls)
            chosen.fit_datasets([data, labels])
        (decision,) = [e for e in t.events if e.get("type") == "event"
                       and e["name"] == "cost.decision"]
        outcome = decision["args"]["outcome"]
        (fit,) = t.spans("estimator.fit")
        assert outcome["measured_s"] > 0 and outcome["span_id"] == fit["span_id"]
        assert outcome["timing"] == "single_run_cold"
        (o,) = cal.join_decisions(t.events)
        assert o.joined_via == "outcome" and o.measured_s == outcome["measured_s"]

    def test_ref_consumed_once(self):
        data, labels, s, ls = self.problem()
        est = LeastSquaresEstimator(lam=1e-3, hbm_bytes=48 << 30)
        with obs.tracing() as t:
            chosen = est.optimize(s, ls)
            chosen.fit_datasets([data, labels])
            chosen.fit_datasets([data, labels])
        assert len(t.spans("estimator.fit")) == 1
        assert getattr(chosen, "_pending_cost_outcome", None) is None

    def test_no_tracer_no_stamp(self):
        data, labels, s, ls = self.problem()
        chosen = LeastSquaresEstimator(lam=1e-3, hbm_bytes=48 << 30).optimize(s, ls)
        assert getattr(chosen, "_pending_cost_outcome", None) is None
        assert chosen.fit_datasets([data, labels]) is not None

    def test_pickled_ref_drops_annotation(self):
        _, _, s, ls = self.problem()
        with obs.tracing():
            chosen = LeastSquaresEstimator(lam=1e-3, hbm_bytes=48 << 30).optimize(s, ls)
            ref = chosen._pending_cost_outcome
            assert ref is not None
            revived = pickle.loads(pickle.dumps(ref))
        revived.stamp(1.0)  # a no-op, not a crash

    def test_fused_streamed_fit_inherits_ref(self):
        from keystone_tpu_torch.ops.learning.streaming_ls import StreamingLeastSquaresChoice

        choice = StreamingLeastSquaresChoice(num_iter=1, lam=1e-3)
        ref = object()
        choice._pending_cost_outcome = ref
        fused = choice.fuse_with_members([])
        assert fused._pending_cost_outcome is ref
        assert choice._pending_cost_outcome is None


class TestDriftGate:
    def test_perturbed_family_flagged_with_flight_note(self, events):
        flight.default_flight_recorder().clear()
        reg = MetricsRegistry()
        report = cal.calibration_report(events, weights=_perturbed(cal),
                                         kinds=("calibration_sweep",))
        verdict = cal.drift_gate(report, registry=reg)
        jverdict = jcal.drift_gate(jcal.calibration_report(
            events, weights=_perturbed(jcal), kinds=("calibration_sweep",)))
        assert verdict == jverdict and verdict["drifted"]
        assert reg.snapshot()["calibration.drift"] == 1.0
        notes = [n for n in flight.flight_snapshot()
                 if n["name"] == "calibration.drift" and n["kind"] == "warn"]
        assert notes and notes[-1]["attrs"]["weights_family"] == "perturbed"

    @pytest.mark.parametrize("family", ["tpu", "ec2"])
    def test_verdicts_equal_the_reference(self, events, family):
        got = cal.drift_gate(cal.calibration_report(
            events, weights=cal.family_weights(family), kinds=("calibration_sweep",)))
        want = jcal.drift_gate(jcal.calibration_report(
            events, weights=jcal.family_weights(family), kinds=("calibration_sweep",)))
        assert got["drifted"] == want["drifted"] == (family == "ec2")
        assert got["median_abs_log_error"] == pytest.approx(want["median_abs_log_error"],
                                                            rel=1e-12)

    def test_no_data_verdict(self):
        verdict = cal.drift_gate(cal.calibration_report([]))
        assert verdict == jcal.drift_gate(jcal.calibration_report([]))
        assert not verdict["drifted"] and verdict["num_scored"] == 0


def _trace_dir_with(tmp_path, text):
    d = tmp_path / "tr"
    d.mkdir()
    (d / "events.jsonl").write_text(text)
    return str(d)


class TestCalibrateCLI:
    @pytest.mark.parametrize("case", ["fixture", "ec2", "json", "missing", "no_data",
                                      "corrupt", "perturbed"])
    def test_exit_codes_equal_the_reference(self, case, tmp_path, capsys):
        argv = [FIXTURE]
        if case == "ec2":
            argv += ["--weights", "ec2"]
        elif case == "json":
            argv += ["--json"]
        elif case == "missing":
            argv = [str(tmp_path / "nope")]
        elif case == "no_data":
            argv = [_trace_dir_with(tmp_path, json.dumps({
                "type": "span", "name": "fold.segment", "run_id": "r", "ts_us": 1,
                "dur_us": 5, "span_id": 1, "parent_id": None, "tid": 1, "thread": "t",
                "args": {}}) + "\n")]
        elif case == "corrupt":
            argv = [_trace_dir_with(tmp_path, '{"type": "event", "na')]
        elif case == "perturbed":
            path = str(tmp_path / "perturbed.json")
            cal.write_calibration_artifact(path, _perturbed(cal), {"note": "seeded"})
            argv += ["--weights", f"calibrated:{path}"]
        rc = cal_cli.main(argv)
        out = capsys.readouterr()
        want = jcal_cli.main(argv)
        jout = capsys.readouterr()
        assert rc == want == {"fixture": 0, "ec2": 2, "json": 0, "missing": 1, "no_data": 3,
                              "corrupt": 1, "perturbed": 2}[case]
        if case in ("fixture", "ec2", "perturbed", "no_data"):
            assert out.out == jout.out
        if case == "json":
            assert json.loads(out.out) == json.loads(jout.out)

    def test_refit_writes_artifact(self, tmp_path, capsys):
        out_path = str(tmp_path / "refit.json")
        assert cal_cli.main([FIXTURE, "--refit", out_path]) == 0
        out = capsys.readouterr().out
        assert "trace-driven refit" in out and "KEYSTONE_COST_WEIGHTS=calibrated:" in out
        jpath = str(tmp_path / "jrefit.json")
        assert jcal_cli.main([FIXTURE, "--refit", jpath]) == 0
        got = cal.load_calibration_artifact(out_path)["weights"]
        want = jcal.load_calibration_artifact(jpath)["weights"]
        assert got.keys() == want.keys()
        for key, v in want.items():
            assert got[key] == pytest.approx(v, rel=1e-9), key

    @pytest.mark.parametrize("family", ["ec2", "tpu"])
    def test_refit_pins_the_network_weight(self, tmp_path, capsys, family):
        """On the EC2 family's base the refit pins one card's network
        weight; on another family it keeps that family's."""
        out_path = str(tmp_path / "refit.json")
        rc = cal_cli.main([FIXTURE, "--weights", family, "--refit", out_path])
        assert rc == (2 if family == "ec2" else 0)  # ec2 drifts on the fixture
        capsys.readouterr()
        want = cal.ONE_CARD_NETWORK_PIN if family == "ec2" else \
            cal.family_weights(family)["network"]
        assert cal.load_calibration_artifact(out_path)["weights"]["network"] == want

    def test_no_data_refit_refused(self, tmp_path, capsys):
        d = _trace_dir_with(tmp_path, json.dumps({
            "type": "span", "name": "fold.segment", "run_id": "r", "ts_us": 1, "dur_us": 5,
            "span_id": 1, "parent_id": None, "tid": 1, "thread": "t", "args": {}}) + "\n")
        art = str(tmp_path / "cal.json")
        assert cal_cli.main([d, "--refit", art]) == 3
        assert "refusing --refit" in capsys.readouterr().err
        assert not os.path.exists(art)

    def test_module_runs_as_a_program(self):
        proc = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch.tools.calibrate", FIXTURE],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, KEYSTONE_COST_WEIGHTS="tpu"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "drift verdict: OK" in proc.stdout

    def test_trace_cli_prints_predicted_vs_measured(self, capsys):
        from keystone_tpu.tools.trace import main as jmain
        from keystone_tpu_torch.tools.trace import main

        assert main([FIXTURE]) == 0
        out = capsys.readouterr().out
        assert "predicted=" in out and "measured=" in out and "log_err=" in out
        assert jmain([FIXTURE]) == 0
        assert capsys.readouterr().out == out


class TestSketchedFamilyRefit:
    GEOMETRIES = (
        {"n": 500_000, "d": 16_384, "k": 2, "sparsity": 82 / 16_384, "machines": 1},
        {"n": 250_000, "d": 16_384, "k": 2, "sparsity": 82 / 16_384, "machines": 1},
    )
    SRHT_TRUE = cost_mod.TPU_SRHT_SKETCH_OVERHEAD * 1.5
    CS_TRUE = cost_mod.TPU_COUNTSKETCH_OVERHEAD * 1.5

    @pytest.fixture(scope="class")
    def trace_dir(self, tmp_path_factory):
        work = str(tmp_path_factory.mktemp("sketch_sweep"))
        base = {"cpu": cost_mod.TPU_CPU_WEIGHT, "mem": cost_mod.TPU_MEM_WEIGHT,
                "network": 0.0,
                "sparse_gather_overhead": cost_mod.TPU_SPARSE_GATHER_OVERHEAD}
        # A class fixture runs before the function-scoped family fixture.
        os.environ["KEYSTONE_COST_WEIGHTS"] = "tpu"
        try:
            self._record(work, base)
        finally:
            del os.environ["KEYSTONE_COST_WEIGHTS"]
        return work

    def _record(self, work, base):
        with obs.tracing(work, run_id="sketchsweep01"):
            for label, family, true_ov in (
                    ("SketchedLeastSquares", "srht_sketch_overhead", self.SRHT_TRUE),
                    ("IterativeHessianSketch", "countsketch_overhead", self.CS_TRUE)):
                for ctx in self.GEOMETRIES:
                    predicted = cal.predict_seconds(label, ctx, base)
                    measured = cal.predict_seconds(label, ctx, {**base, family: true_ov})
                    assert predicted == jcal.predict_seconds(label, ctx, base)
                    ref = obs.record_cost_decision(obs.CostDecision(
                        decision="calibration_sweep", winner=label,
                        candidates=[{"label": label, "cost_s": predicted, "feasible": True}],
                        reason="sweep", context=dict(ctx)))
                    ref.stamp(measured, timing="min_of_N_warm")

    def test_refit_names_sketched_families_as_the_reference(self, trace_dir, tmp_path,
                                                             capsys):
        out_path, jpath = str(tmp_path / "cal.json"), str(tmp_path / "jcal.json")
        assert cal_cli.main([trace_dir, "--refit", out_path]) == 0
        assert jcal_cli.main([trace_dir, "--refit", jpath]) == 0
        capsys.readouterr()
        doc = cal.load_calibration_artifact(out_path)
        assert set(doc["provenance"]["fitted"]) == {"srht_sketch_overhead",
                                                    "countsketch_overhead"}
        w = doc["weights"]
        assert w["srht_sketch_overhead"] == pytest.approx(self.SRHT_TRUE, rel=1e-3)
        assert w["countsketch_overhead"] == pytest.approx(self.CS_TRUE, rel=1e-3)
        want = jcal.load_calibration_artifact(jpath)["weights"]
        for key, v in want.items():
            assert w[key] == pytest.approx(v, rel=1e-9), key

    def test_refit_reduces_error_on_its_own_rows(self, trace_dir):
        result = cal.refit(obs.load_events(trace_dir), kinds=("calibration_sweep",))
        assert result["after"]["median_abs_log_error"] < 1e-6


def _sweep_module():
    import importlib.util

    path = os.path.join(ROOT, "scripts", "torch_fit_cost_weights.py")
    spec = importlib.util.spec_from_file_location("torch_fit_cost_weights", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestSweepHarness:
    """``scripts/torch_fit_cost_weights.py`` at small shapes on the CPU:
    every point is a stamped decision that the refit joins; the selector's
    own gram engine (float32 slabs) and the bf16 one are labelled apart, and
    each label prices back to its engine."""

    @pytest.fixture()
    def sweep(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        with obs.tracing(str(tmp_path)) as tracer:
            points = _sweep_module().run_sweep(
                "cpu", dense_shapes=((256, 32, 3),), sparse_shapes=((512, 64, 4, 2),),
                log=lambda *_: None)
            records = list(tracer.events)
        return points, records

    def test_points_are_stamped_and_joined(self, sweep):
        points, records = sweep
        assert [p["engine"] for p in points] == [
            "exact", "lbfgs", "block", "sparse-gather", "sparse-gram", "sparse-gram-bf16"]
        assert [p["label"] for p in points[3:]] == [
            "SparseLBFGSwithL2[gather]", "SparseLBFGSwithL2[gram]",
            "SparseLBFGSwithL2[gram,bf16]"]
        assert all(p["measured_s"] > 0 for p in points)
        assert all(p["iterations"] >= 1 for p in points if p["engine"].startswith("sparse"))
        result = cal.refit(records)
        assert result["after"]["num_decisions"] == result["after"]["num_measured"] == len(points)
        assert set(result["after"]["per_engine"]) >= {p["label"] for p in points}
        assert result["weights"]["network"] == cal.ONE_CARD_NETWORK_PIN

    def test_the_selectors_gram_candidate_is_the_f32_point(self, sweep):
        points, _ = sweep
        est = LeastSquaresEstimator()
        labels = {candidate_label(o[0]) for o in est.options}
        assert "SparseLBFGSwithL2[gram]" in labels
        assert "SparseLBFGSwithL2[gram,bf16]" not in labels
        (gram,) = [o[0] for o in est.options if candidate_label(o[0]) == "SparseLBFGSwithL2[gram]"]
        assert gram.gram_dtype is None and gram.solver == "gram"
        for p in points[4:]:
            rebuilt = cal.estimator_for_label(p["label"])
            assert candidate_label(rebuilt) == p["label"]
