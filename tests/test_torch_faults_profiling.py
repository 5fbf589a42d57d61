"""The port's fault injection (``keystone_tpu_torch/utils/faults.py``),
profiling helpers (``utils/profiling.py``) and ``run.py serve`` on the
CPU, against the reference where the logic is shared (exactly).

  - faults: the same ``FaultPlan`` over the same call script fires the
    same (site, call, kind) sequence in both packages, probability rules
    included; ``corrupt_array`` flips the same byte; ``RetryPolicy``
    computes the same delays; env knobs fail with the variable's name;
  - profiling: ``latency_percentiles``, ``summarize_spans`` and the
    overlap / retry helpers give the reference's numbers and errors;
    ``PhaseTimer`` on the host clock; ``trace`` writes a Chrome trace;
  - the CLI: ``python -m keystone_tpu_torch.run serve --device cpu`` at a
    tiny size prints one summary line with the reference's keys (and
    ``export_s``), its books balance, ``--trace=DIR`` and
    ``--fault-plan=`` apply, the unported flags are refused, and without
    a card the default device raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.utils import faults, profiling

ROOT = Path(__file__).resolve().parent.parent

PLAN_SPEC = {
    "seed": 7,
    "rules": [
        {"site": "serving.execute", "kind": "error", "calls": [1, 4]},
        {"site": "serving.replica.spawn", "kind": "error", "p": 0.3},
        {"site": "serving.replica.execute", "kind": "latency", "p": 0.5,
         "latency_s": 0.0, "count": 3},
        {"site": "shard.load", "kind": "corrupt", "calls": [2]},
    ],
}
SCRIPT = (["serving.execute"] * 6 + ["serving.replica.spawn"] * 20
          + ["serving.replica.execute"] * 12)


def _run_plan(mod):
    plan = mod.FaultPlan.from_dict(json.loads(json.dumps(PLAN_SPEC)))
    outcomes = []
    with plan:
        for site in SCRIPT:
            try:
                mod.maybe_fail(site)
                outcomes.append("ok")
            except mod.FaultError:
                outcomes.append("error")
        arrs = [mod.corrupt_array("shard.load", np.arange(4, dtype=np.int32))
                for _ in range(4)]
    return plan.log, outcomes, [a.tobytes() for a in arrs], plan.to_dict()


class TestFaultsAgainstReference:
    def test_same_firing_sequence(self):
        from keystone_tpu.utils import faults as j_faults

        t = _run_plan(faults)
        j = _run_plan(j_faults)
        assert t == j
        assert t[1].count("error") > 2  # the script exercised the rules

    @pytest.mark.parametrize("seed", [0, 1, 123])
    def test_same_retry_delays(self, seed):
        from keystone_tpu.utils import faults as j_faults

        t = faults.RetryPolicy(attempts=5, base_delay_s=0.01, max_delay_s=0.05, seed=seed)
        j = j_faults.RetryPolicy(attempts=5, base_delay_s=0.01, max_delay_s=0.05, seed=seed)
        for key in ("", "shard-3", "x"):
            assert [t.delay_s(a, key) for a in range(1, 6)] == \
                [j.delay_s(a, key) for a in range(1, 6)]

    def test_same_site_names(self):
        from keystone_tpu.utils import faults as j_faults

        names = {k: v for k, v in vars(faults).items() if k.startswith("SITE_")}
        assert names == {k: v for k, v in vars(j_faults).items() if k.startswith("SITE_")}
        assert faults.__all__ == j_faults.__all__


class TestFaults:
    def test_retry_policy_retries_transients_then_raises(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise faults.FaultError("flaky")
            return "ok"

        retries = []
        policy = faults.RetryPolicy(attempts=3, base_delay_s=0.0, max_delay_s=0.0)
        assert policy.call(flaky, on_retry=lambda a, d, e: retries.append(a)) == "ok"
        assert retries == [1, 2]
        with pytest.raises(faults.FaultError):
            faults.RetryPolicy(attempts=2, base_delay_s=0.0).call(
                lambda: (_ for _ in ()).throw(faults.FaultError("always")))

    def test_env_plan_installs_ambiently(self, monkeypatch):
        spec = {"rules": [{"site": "serving.execute", "kind": "error", "calls": [0]}]}
        monkeypatch.setenv("KEYSTONE_FAULT_PLAN", json.dumps(spec))
        faults._reset_env_cache()
        try:
            with pytest.raises(faults.FaultError):
                faults.maybe_fail("serving.execute")
            faults.maybe_fail("serving.execute")
        finally:
            faults.uninstall()
            monkeypatch.delenv("KEYSTONE_FAULT_PLAN")
            faults._reset_env_cache()
        assert faults.active_plan() is None

    def test_env_number_names_the_variable(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_X", "abc")
        with pytest.raises(ValueError, match="KEYSTONE_X"):
            faults._env_number("KEYSTONE_X", "1", float, 0.0)
        monkeypatch.setenv("KEYSTONE_X", "-1")
        with pytest.raises(ValueError, match="KEYSTONE_X"):
            faults._env_number("KEYSTONE_X", "1", float, 0.0)

    def test_rule_validation(self):
        with pytest.raises(ValueError):
            faults.FaultRule("serving.execute", "explode", calls=[0])


def _spans(seed=0, n=30):
    rng = np.random.default_rng(seed)
    return [profiling.RequestSpan(float(rng.uniform(0, 0.01)), float(rng.uniform(0, 0.005)),
                                  int(rng.integers(1, 9)), 8, float(rng.uniform(0, 0.9)))
            for _ in range(n)]


class TestProfilingAgainstReference:
    @pytest.mark.parametrize("qs", [(50.0, 99.0), (0.0, 25.0, 99.9, 100.0)])
    def test_same_latency_percentiles(self, qs):
        from keystone_tpu.utils import profiling as j_prof

        lat = list(np.random.default_rng(1).lognormal(-5, 1, size=101))
        assert profiling.latency_percentiles(lat, qs) == j_prof.latency_percentiles(lat, qs)
        assert profiling.latency_percentiles([0.25]) == j_prof.latency_percentiles([0.25])
        assert profiling.latency_percentiles([]) is None

    @pytest.mark.parametrize("bad", [[float("nan")], [1.0, float("inf")]])
    def test_same_percentile_errors(self, bad):
        from keystone_tpu.utils import profiling as j_prof

        for fn in (profiling.latency_percentiles, j_prof.latency_percentiles):
            with pytest.raises(ValueError, match="non-finite"):
                fn(bad)
            with pytest.raises(ValueError, match="outside"):
                fn([1.0], (101.0,))
            with pytest.raises(ValueError, match="empty"):
                fn([1.0], ())

    def test_same_span_summary(self):
        from keystone_tpu.utils import profiling as j_prof

        spans = _spans()
        j_spans = [j_prof.RequestSpan(**s.__dict__) for s in spans]
        assert profiling.summarize_spans(spans) == j_prof.summarize_spans(j_spans)
        assert profiling.summarize_spans([]) == {}
        log = profiling.SpanLog(maxlen=5)
        for s in spans:
            log.record(s)
        assert len(log) == 5 and log.summary() == profiling.summarize_spans(spans[-5:])

    def test_same_overlap_and_retry_helpers(self):
        from keystone_tpu.utils import profiling as j_prof

        class Stats:
            load_s, wait_s, prefetched = 2.0, 0.5, True
            site_busy_s = {"read": 2.0, "verify": 0.5}
            site_wait_s = {"read": 0.5}
            retries, backoff_s = 3, 0.25

        s = Stats()
        assert profiling.prefetch_overlap_fraction(s) == j_prof.prefetch_overlap_fraction(s)
        with pytest.warns(DeprecationWarning):
            t = profiling.overlap_report(s)
        with pytest.warns(DeprecationWarning):
            j = j_prof.overlap_report(s)
        assert t == j
        with pytest.warns(DeprecationWarning):
            assert profiling.prefetch_retry_counters(s) == {"retries": 3, "backoff_s": 0.25}


class TestProfiling:
    def test_phase_timer_on_the_host(self):
        timer = profiling.PhaseTimer("t")
        for _ in range(2):
            with timer.phase("a"):
                pass
        assert timer.counts == {"a": 2} and timer.total("a") >= 0.0
        assert timer.summary().startswith("t: a=")
        assert profiling.PhaseTimer("t", device="cpu").summary() == "t: (no phases)"

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "p")):
            torch.ones(16).cumsum(0)
        doc = json.loads((tmp_path / "p" / "trace.json").read_text())
        assert doc["traceEvents"]


SERVE_TINY = ["serve", "--device", "cpu", "--input-dim", "32", "--numFFTs", "2",
              "--blockSize", "32", "--fit-n", "128", "--max-batch", "8", "--rate", "200",
              "--duration-s", "0.3"]


def _serve(argv, env=None):
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.run"] + argv, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})),
    )
    return proc


class TestServeCLI:
    def test_summary_has_the_reference_keys(self, tmp_path):
        proc = _serve(SERVE_TINY + [f"--trace={tmp_path / 'tr'}", "--slo-p99-ms", "100"])
        assert proc.returncode == 0, proc.stderr[-2000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        want = {"offered_rate_hz", "duration_s", "num_samples", "num_offered", "rejected",
                "failed", "p50_latency_ms", "p99_latency_ms", "achieved_qps",
                "single_request_s", "buckets", "plan_compiled", "max_wait_ms",
                "plan_fingerprint", "mean_pad_fraction", "breaker_state", "slo_state",
                "slo_budget_spent_fraction", "export_s"}
        assert want <= set(summary)
        assert summary["num_offered"] == (summary["num_samples"] + summary["rejected"]
                                          + summary["failed"])
        assert summary["failed"] == 0 and summary["plan_compiled"]
        assert summary["buckets"] == [2, 4, 8]
        assert {"trace.json", "events.jsonl", "meta.json"} <= set(os.listdir(tmp_path / "tr"))

    def test_replicas_summary(self):
        proc = _serve(SERVE_TINY + ["--replicas", "2"])
        assert proc.returncode == 0, proc.stderr[-2000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["replicas"] == 2 and summary["healthy_replicas"] == 2
        assert summary["evicted_replicas"] == [] and summary["degraded"] is False
        assert sum(summary["per_replica_completed"].values()) == summary["num_samples"]

    def test_fault_plan_flag_fails_requests_loudly(self):
        spec = {"rules": [{"site": "serving.execute", "kind": "error", "p": 1.0}]}
        proc = _serve(SERVE_TINY + ["--fault-plan=" + json.dumps(spec)])
        assert proc.returncode == 0, proc.stderr[-2000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["num_samples"] == 0
        assert summary["failed"] + summary["rejected"] == summary["num_offered"] > 0

    @pytest.mark.parametrize("flag", ["--fleet", "--from-plan", "--metrics-port",
                                      "--metrics-dir"])
    def test_unported_flags_are_refused(self, flag, tmp_path, capsys):
        """The name is kept from when all four flags were refused. All four
        are ported now: ``--fleet 2`` serves through two CPU plane
        processes with balanced fleet books, and refuses ``--fleet 0`` and
        ``--fleet 2 --autoscale`` as the reference does; the live plane's
        flags and ``--from-plan`` work."""
        from keystone_tpu_torch import run

        if flag == "--fleet":
            rc = run.main(SERVE_TINY + [flag, "2"])
            summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert rc == 0 and summary["fleet_accounting_ok"] is True
            assert summary["num_planes"] == 2 and summary["healthy_planes"] == 2
            assert summary["aggregate_offered"] == summary["num_offered"] > 0
            assert summary["fleet_completed"] + summary["fleet_rejected"] + \
                summary["fleet_failed"] == summary["aggregate_offered"]
            assert summary["export_s"] > 0
            assert run.main(SERVE_TINY + [flag, "0"]) == 2
            assert "need --fleet >= 1" in capsys.readouterr().err
            assert run.main(SERVE_TINY + [flag, "2", "--autoscale",
                                          "--slo-p99-ms", "50"]) == 2
            assert "--fleet and --autoscale are mutually exclusive" in capsys.readouterr().err
            return
        if flag == "--from-plan":
            from keystone_tpu_torch.placement.planner import CapacityPlanner
            from keystone_tpu_torch.tools.plan import write_apply_artifact

            value = str(tmp_path / "plan.json")
            write_apply_artifact(value, CapacityPlanner([]).plan(), [str(tmp_path)], 0.7)
        else:
            value = "0" if flag == "--metrics-port" else str(tmp_path / "m")
        rc = run.main(SERVE_TINY + [flag, value])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and summary["num_offered"] > 0
        if flag == "--from-plan":
            assert summary["plan_artifact"]["path"] == value
        elif flag == "--metrics-port":
            assert summary["metrics_port"] > 0
        else:
            assert os.path.exists(os.path.join(value, "live_metrics.json"))

    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        from keystone_tpu_torch import run

        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["serve", "--input-dim", "8"])

    def test_learn_is_not_a_command(self):
        """``learn`` is a mode of the CLI, not a pipeline name: ``resolve``
        refuses it, and ``main`` routes it to the continuous-learning loop,
        which (like serve) raises without a CUDA device unless given
        ``--device cpu``."""
        from keystone_tpu_torch import run

        with pytest.raises(SystemExit, match="Unknown pipeline"):
            run.resolve("learn")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run.main(["learn"])


class TestCompiledCost:
    """``compiled_cost``: twins of tests/test_profiling.py's TestCompiledCost,
    held to exact counts (the reference's XLA count where it gives one)."""

    def test_matmul_flops_and_bytes(self):
        from keystone_tpu.utils import profiling as j_prof
        import jax.numpy as jnp

        m, k, n = 64, 32, 16
        cost = profiling.compiled_cost(lambda x, y: x @ y, torch.ones(m, k), torch.ones(k, n))
        assert cost["flops"] == 2 * m * n * k
        assert cost["bytes accessed"] == 4 * (m * k + k * n + m * n)
        ref = j_prof.compiled_cost(lambda x, y: x @ y, jnp.ones((m, k)), jnp.ones((k, n)))
        if ref is not None:
            assert ref["flops"] == cost["flops"]

    def test_bad_function_returns_none(self):
        assert profiling.compiled_cost(lambda x, y: x @ y, torch.ones(4, 4),
                                       torch.ones(3, 3)) is None

    def test_views_move_no_bytes_and_kwargs_pass(self):
        x = torch.ones(8, 4)
        # x.T is a view: only the product's operands and output count.
        cost = profiling.compiled_cost(lambda a, b=None: a.T @ b, x, b=x)
        assert cost["flops"] == 2 * 4 * 4 * 8
        assert cost["bytes accessed"] == 4 * (8 * 4 * 2 + 4 * 4)
