"""The port's capacity planner against the JAX package, on the CPU.

One recorded trace (written by the reference's tracer, as its own golden
planner test records it: a solver decision, a mesh-layout decision, a
stamped zoo page-in, an autoscale storm's occupancy snapshots and 100
``serving.batch`` spans) goes through both packages' ``CapacityPlanner``:
the 1x replay and the four what-ifs (``traffic=2x``, ``hbm=0.5x``,
``tenants=+1``, ``mesh=8x1``) give equal plan dicts. A trace the port
records from its own decision sites replays the same in both packages. The
CLI (``tools.plan``: ``--json``, ``--apply``, the refused gate) gives the
reference's exit codes and artifact, and ``serve --from-plan --device cpu``
takes its defaults from the artifact.
"""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs as tobs
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.placement.planner import CapacityPlanner, decision_rows, parse_whatif
from keystone_tpu_torch.tools import plan as plan_cli
from keystone_tpu_torch.tools import trace as trace_cli

import jax.numpy as jnp

from keystone_tpu import obs as jobs
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.placement.planner import CapacityPlanner as JCapacityPlanner
from keystone_tpu.placement.planner import decision_rows as jdecision_rows
from keystone_tpu.tools import plan as jplan_cli
from keystone_tpu.tools import trace as jtrace_cli

WHATIFS = ["traffic=2x", "hbm=0.5x", "tenants=+1", "mesh=8x1"]


@pytest.fixture(autouse=True)
def _tpu_family(monkeypatch):
    """The golden trace is priced under the reference's default family; the
    tenants what-if prices a page-in under the active one."""
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")


def _storm(tracer, obs_mod, engine_mod):
    """The storm part of the trace: a stamped zoo page-in, occupancy
    snapshots ramping to 4 replicas, batch latencies (p50 10 ms, a 35 ms
    tail)."""
    eng = engine_mod.PlacementEngine()
    priced = eng.price_page_in(1 << 28)
    ref = eng.audit(engine_mod.KIND_ZOO_PAGE_IN, "tenant-a",
                    [{"label": "tenant-a", "cost_s": priced, "feasible": True,
                      "resident_bytes": float(1 << 28)}],
                    reason="page_fault", context={})
    ref.stamp(priced * 1.05, timing="single_run_cold")
    for replicas, queue, outstanding in ((1, 2.0, 2.0), (2, 4.0, 4.0), (4, 6.0, 6.0)):
        obs_mod.event("autoscale.decision", action="scale_up", reason="queue_pressure",
                      ok=True, winner=f"replicas={replicas}", candidates=[],
                      weights_family="tpu",
                      inputs={"replicas": replicas, "queue_depth": queue,
                              "outstanding": outstanding})
    t0 = time.perf_counter()
    for i in range(100):
        start = t0 + i * 0.05
        tracer.add_span("serving.batch", start, start + (0.010 if i < 98 else 0.035))


def _dense_sample(Dataset, conv):
    rng = np.random.default_rng(0)
    s = Dataset.of(conv(rng.normal(size=(24, 16_384)).astype(np.float32)))
    s.total_n = 262_144
    s.source_row_bytes = 4.0 * 440
    return s, Dataset.of(conv(rng.normal(size=(24, 147)).astype(np.float32)))


@pytest.fixture()
def golden_dir(tmp_path, monkeypatch):
    """Recorded by the reference's tracer and decision sites."""
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")
    from keystone_tpu.ops.learning import cost as jcost
    from keystone_tpu.placement import engine as jengine

    td = str(tmp_path / "golden")
    s, ls = _dense_sample(JDataset, jnp.asarray)
    with jobs.tracing(td) as tracer:
        jcost.LeastSquaresEstimator(lam=1e-4, hbm_bytes=48 << 30, num_machines=1).optimize(
            s, ls)
        jcost.choose_mesh_layout(65_000_000, 16_385, 2, nnz_per_row=83, num_devices=8)
        _storm(tracer, jobs, jengine)
    return td


@pytest.fixture()
def port_dir(tmp_path):
    """Recorded by the port's tracer and decision sites."""
    from keystone_tpu_torch.ops.learning import cost as tcost
    from keystone_tpu_torch.placement import engine as tengine

    td = str(tmp_path / "port")
    s, ls = _dense_sample(TDataset, torch.from_numpy)
    with tobs.tracing(td) as tracer:
        tcost.LeastSquaresEstimator(lam=1e-4, hbm_bytes=48 << 30).optimize(s, ls)
        tcost.choose_image_tier(50_000, 3072, 10, host_budget_bytes=6e8)
        tcost.choose_mesh_layout(65_000_000, 16_385, 2, nnz_per_row=83, num_devices=8)
        _storm(tracer, tobs, tengine)
    return td


def _plans(directory):
    whatifs = [parse_whatif(w) for w in WHATIFS]
    got = CapacityPlanner(tobs.load_events(directory)).plan(whatifs)
    want = JCapacityPlanner(jobs.load_events(directory)).plan(whatifs)
    return got, want


class TestReplay:
    def test_golden_plan_equals_the_reference(self, golden_dir):
        got, want = _plans(golden_dir)
        assert got == want
        fid = got["fidelity"]
        assert fid["num_replayed"] >= 4 and fid["num_reproduced"] == fid["num_replayed"]
        assert fid["num_outcomes"] >= 1 and fid["max_abs_log_error"] < 0.7

    def test_port_recorded_plan_equals_the_reference(self, port_dir):
        got, want = _plans(port_dir)
        assert got == want
        fid = got["fidelity"]
        # The solver, image-tier and mesh-layout decisions on both streams.
        assert fid["num_replayed"] == 6 and fid["num_reproduced"] == 6
        assert got["baseline"]["replicas_peak"] == 4

    @pytest.mark.parametrize("whatif", WHATIFS)
    def test_each_whatif(self, golden_dir, whatif):
        key, value = parse_whatif(whatif)
        row = CapacityPlanner(tobs.load_events(golden_dir)).whatif(key, value)
        assert row["num_decisions"] > 0 and row["assumptions"]
        if key == "traffic":
            assert row["predicted_p99_s"] > row["predicted_p99_1x_s"]
        elif key == "hbm":
            assert {c["kind"] for c in row["changed"]} >= {"least_squares_solver",
                                                          "placement.solver"}
        elif key == "tenants":
            assert row["measured_page_in_p50_s"] == pytest.approx(
                row["predicted_page_in_s"] * 1.05)
        else:
            assert row["recorded_winner"] == "mesh[data=8,model=1]"

    def test_decision_rows_and_parse_equal_the_reference(self, golden_dir):
        from keystone_tpu.placement.planner import parse_whatif as jparse

        assert decision_rows(tobs.load_events(golden_dir)) == \
            jdecision_rows(jobs.load_events(golden_dir))
        for spec in WHATIFS + ["traffic=3"]:
            assert parse_whatif(spec) == jparse(spec)
        for bad in ("traffic", "disk=2x", "mesh=8"):
            with pytest.raises(ValueError):
                parse_whatif(bad)


class TestPlanCLI:
    @pytest.mark.parametrize("case", ["whatifs", "json", "refused", "missing"])
    def test_exit_codes_and_output_equal_the_reference(self, golden_dir, tmp_path, capsys,
                                                        case):
        argv = [golden_dir] + [a for w in WHATIFS for a in ("--whatif", w)]
        if case == "json":
            argv.append("--json")
        elif case == "refused":
            argv += ["--apply", str(tmp_path / "p.json"), "--drift-threshold", "1e-12"]
        elif case == "missing":
            argv = [str(tmp_path / "nope")]
        rc = plan_cli.main(argv)
        out = capsys.readouterr()
        want = jplan_cli.main(argv)
        jout = capsys.readouterr()
        assert rc == want == {"whatifs": 0, "json": 0, "refused": 2, "missing": 1}[case]
        if case in ("whatifs", "json"):
            assert out.out == jout.out
        if case == "refused":
            assert "REFUSED" in out.err and not os.path.exists(tmp_path / "p.json")

    def test_apply_artifact_equals_the_reference(self, golden_dir, tmp_path, capsys):
        got_path, want_path = str(tmp_path / "p.json"), str(tmp_path / "jp.json")
        assert plan_cli.main([golden_dir, "--apply", got_path]) == 0
        assert jplan_cli.main([golden_dir, "--apply", want_path]) == 0
        capsys.readouterr()
        with open(got_path) as f:
            got = json.load(f)
        with open(want_path) as f:
            want = json.load(f)
        for doc in (got, want):
            doc.pop("written_at_unix_s")
        assert got == want
        assert got["artifact"] == plan_cli.PLAN_ARTIFACT_KIND
        assert got["serve_defaults"]["replicas"] == 4

    def test_trace_decisions_view_equals_the_reference(self, golden_dir, capsys):
        assert trace_cli.main([golden_dir, "--decisions"]) == 0
        out = capsys.readouterr().out
        assert jtrace_cli.main([golden_dir, "--decisions"]) == 0
        assert capsys.readouterr().out == out
        assert "cost.decision" in out and "autoscale.decision" in out

    def test_trace_perfetto_form(self, golden_dir, tmp_path, capsys):
        out_path = str(tmp_path / "t.json")
        assert trace_cli.main([golden_dir, "--perfetto", out_path]) == 0
        with open(out_path) as f:
            assert tobs.validate_chrome_trace(json.load(f)) == []


class TestServeFromPlan:
    def test_apply_then_serve_from_plan(self, golden_dir, tmp_path, capsys):
        from keystone_tpu_torch import run

        path = str(tmp_path / "defaults.json")
        assert plan_cli.main([golden_dir, "--apply", path]) == 0
        capsys.readouterr()
        rc = run.main(["serve", "--device", "cpu", "--input-dim", "32", "--numFFTs", "2",
                       "--blockSize", "32", "--fit-n", "128", "--max-batch", "8",
                       "--rate", "200", "--duration-s", "0.3", "--from-plan", path,
                       "--replicas", "2"])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0
        stamp = summary["plan_artifact"]
        assert stamp["path"] == path and stamp["source_traces"]
        # The explicit --replicas outranks the plan's 4; the rest fill in.
        assert summary["replicas"] == 2 and "replicas" not in stamp["applied"]
        assert stamp["applied"]["slo_p99_ms"] > 0 and "slo_state" in summary

    def test_fills_only_untouched_flags(self, golden_dir, tmp_path, capsys):
        from keystone_tpu_torch.run import _serve_apply_plan_defaults

        path = str(tmp_path / "defaults.json")
        assert plan_cli.main([golden_dir, "--apply", path]) == 0
        capsys.readouterr()
        parser = argparse.ArgumentParser()
        parser.add_argument("--replicas", type=int, default=1)
        parser.add_argument("--queue-depth", type=int, default=1024)
        parser.add_argument("--slo-p99-ms", type=float, default=0.0)
        parser.add_argument("--from-plan", default="")
        args = parser.parse_args(["--from-plan", path, "--replicas", "7"])
        stamp = _serve_apply_plan_defaults(args, parser)
        assert args.replicas == 7 and "replicas" not in stamp["applied"]
        assert stamp["applied"]["slo_p99_ms"] == args.slo_p99_ms > 0
        assert stamp["applied"]["queue_depth"] == args.queue_depth

    def test_rejects_foreign_json(self, tmp_path, capsys):
        from keystone_tpu_torch import run

        bogus = tmp_path / "notaplan.json"
        bogus.write_text(json.dumps({"hello": "world"}))
        assert run.main(["serve", "--device", "cpu", "--from-plan", str(bogus)]) == 2
        assert "not a tools.plan --apply artifact" in capsys.readouterr().err
