"""The port's discipline linter (``keystone_tpu_torch/tools/lint.py``): the
twin of tests/test_lint.py. The port lints clean, the registries it parses
match the port's modules, and every rule has a fixture that fires on a
violating snippet and stays silent on a clean one. The three rules named
for JAX in the reference are held on torch snippets: ``device-off-thread``,
``torch-clean-module``, and ``explicit-seed``'s ``manual_seed`` forms. The
reference's linter runs on the same snippets where the rule is shared, and
finds the same rules."""

from pathlib import Path

import pytest

from keystone_tpu.tools import lint as jlint
from keystone_tpu_torch.tools.lint import (
    RULES,
    default_paths,
    fault_site_registry,
    lint_file,
    lint_paths,
    mesh_axis_registry,
    metric_name_registry,
)

REPO = Path(__file__).resolve().parents[1]


def _lint_snippet(tmp_path: Path, source: str, rules=None, name="snippet.py"):
    f = tmp_path / name
    f.write_text(source)
    return lint_file(f, rules=rules)


def _codes(findings):
    return [f.rule for f in findings]


class TestPortIsClean:
    def test_port_lints_clean(self):
        findings = lint_paths(default_paths())
        assert not findings, "\n".join(str(f) for f in findings)

    def test_default_paths_are_the_ports(self):
        paths = default_paths()
        assert paths[0] == REPO / "keystone_tpu_torch"
        assert REPO / "chip_smoke.py" in paths
        assert REPO / "tests" / "test_torch_lint.py" in paths
        assert not any(p.name.startswith("test_") and not p.name.startswith("test_torch_")
                       for p in paths)
        assert all(p.name.startswith("torch_") for p in paths if p.parent.name == "scripts")

    def test_registry_matches_faults_module(self):
        from keystone_tpu_torch.utils import faults

        registry = fault_site_registry()
        assert registry and all(getattr(faults, attr) == site
                                for attr, site in registry.items())
        assert registry == {attr: getattr(faults, attr) for attr in dir(faults)
                            if attr.startswith("SITE_") and isinstance(getattr(faults, attr),
                                                                       str)}

    def test_registry_matches_obs_metrics_module(self):
        from keystone_tpu_torch.obs import metrics

        registry = metric_name_registry()
        assert registry == {attr: getattr(metrics, attr) for attr in dir(metrics)
                            if attr.startswith("METRIC_")
                            and isinstance(getattr(metrics, attr), str)}

    def test_registry_matches_mesh_module(self):
        from keystone_tpu_torch.parallel import mesh as mesh_lib

        assert mesh_axis_registry() == {"DATA_AXIS": mesh_lib.DATA_AXIS,
                                        "MODEL_AXIS": mesh_lib.MODEL_AXIS}

    def test_the_rules_are_the_references_ten_renamed(self):
        renamed = {"jax-off-thread": "device-off-thread",
                   "jax-clean-module": "torch-clean-module"}
        assert list(RULES) == [renamed.get(r, r) for r in jlint.RULES]


class TestDeviceOffThreadRule:
    VIOLATION = """
import threading

import torch


class Reader:
    def __init__(self):
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        return self._stage(torch.zeros(4))

    def _stage(self, x):
        return x.to("cuda:0")

    def close(self):
        self._thread.join()
"""

    def test_fires_on_device_work_in_thread_target(self, tmp_path):
        findings = _lint_snippet(tmp_path, self.VIOLATION)
        assert _codes(findings) == ["device-off-thread"]
        assert "'_stage'" in findings[0].message

    @pytest.mark.parametrize("body", [
        "torch.cuda.synchronize()",
        "x.cuda()",
        "cuda_ops.gram_sym_acc(x, x)",
        "torch.empty(4, device=dev)",
        "x.to(torch.device('cuda', 0))",
        "x.to(self.device)",
    ])
    def test_each_form_of_cuda_work_fires(self, tmp_path, body):
        src = f"""
import threading


class Worker:
    def start(self, x, dev):
        self._t = threading.Thread(target=self._run, args=(x, dev))
        self._t.start()

    def _run(self, x, dev):
        return {body}

    def close(self):
        self._t.join()
"""
        assert _codes(_lint_snippet(tmp_path, src)) == ["device-off-thread"]

    def test_host_only_reader_is_clean(self, tmp_path):
        src = self.VIOLATION.replace('x.to("cuda:0")', "x.numpy()")
        assert not _lint_snippet(tmp_path, src)
        cpu = self.VIOLATION.replace('x.to("cuda:0")', 'torch.zeros(4, device="cpu")')
        assert not _lint_snippet(tmp_path, cpu)

    def test_owner_marker_opts_out(self, tmp_path):
        src = self.VIOLATION.replace(
            "    def _read(self):",
            "    # lint: device-owner-thread: the reader stages onto the card on purpose\n"
            "    def _read(self):")
        assert not _lint_snippet(tmp_path, src)

    def test_fires_on_runtime_submitted_task_and_lambda(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
import torch


class Loader:
    def go(self, rt, s):
        rt.submit("read", self._load, s)
        rt.submit(runtime.LANE_READ, lambda: torch.cuda.current_stream())

    def _load(self, s):
        return torch.ones(s).pin_memory().cuda()
""")
        assert _codes(findings) == ["device-off-thread", "device-off-thread"]

    def test_data_submit_without_a_lane_is_not_a_task(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
def serve(server, x):
    return server.submit(x.cuda(), 5.0)
""")


class TestThreadJoinRule:
    def test_fires_when_started_thread_never_joins(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
import threading


class Server:
    def __init__(self):
        self._thread = threading.Thread(target=self._loop)
        self._thread.start()

    def _loop(self):
        pass

    def close(self):
        ", ".join(["a"])
""")
        assert _codes(findings) == ["thread-join"]

    def test_clean_when_close_joins(self, tmp_path):
        assert not _lint_snippet(tmp_path, TestDeviceOffThreadRule.VIOLATION,
                                 rules=["thread-join"])


class TestRetryTransientRule:
    def test_fires_on_shardcorrupted_in_transient_tuple(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
from keystone_tpu_torch.data.durable import RetryPolicy, ShardCorrupted

P = RetryPolicy(transient=(OSError, ShardCorrupted))
""")
        assert _codes(findings) == ["retry-transient"]

    def test_oserror_only_is_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
from keystone_tpu_torch.data.durable import RetryPolicy

P = RetryPolicy(transient=(OSError,))
""")


class TestFaultSiteRule:
    def test_fires_on_unregistered_sites(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
from keystone_tpu_torch.utils import faults


def read():
    faults.maybe_fail("shard.lod")
    faults.maybe_fail(faults.SITE_NOPE)
    return faults.FaultRule(site="prefetch.raed")
""")
        assert _codes(findings) == ["fault-site"] * 3

    def test_registered_sites_and_disable_pragma(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
from keystone_tpu_torch.utils import faults


def read():
    faults.maybe_fail(faults.SITE_SHARD_LOAD)
    faults.maybe_fail("prefetch.read")
""")
        assert not _lint_snippet(tmp_path, """# lint: disable=fault-site
from keystone_tpu_torch.utils import faults
faults.maybe_fail("made.up")
""")


class TestMetricNameRule:
    def test_fires_on_invented_names(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
def track(reg, metrics):
    reg.counter("serving.made_up").inc()
    reg.bucketed_histogram(metrics.METRIC_NOT_THERE)
""")
        assert _codes(findings) == ["metric-name", "metric-name"]

    def test_catalogue_and_dynamic_names_are_clean(self, tmp_path):
        name = next(iter(metric_name_registry().values()))
        attr = next(iter(metric_name_registry()))
        assert not _lint_snippet(tmp_path, f"""
def track(reg, metrics, site):
    reg.counter("{name}").inc()
    reg.gauge(metrics.{attr})
    reg.histogram(f"site.{{site}}")
    counter(3)
""")


class TestBenchRowRule:
    def test_fires_on_raw_row_dict(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
def my_metric():
    return {"metric": "x", "value": 1.0, "detail": {}}
""")
        assert _codes(findings) == ["bench-row"]

    def test_make_row_and_partial_dicts_are_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
def make_row(metric, value, detail):
    return {"metric": metric, "value": value, "detail": detail}


def partial():
    return {"metric": "x", "value": 1.0}
""")


class TestMeshAxisNameRule:
    VIOLATION = """
from keystone_tpu_torch.parallel import mesh as mesh_lib


def fold(mesh, x, body):
    mesh_lib.shard_map(body, mesh, in_specs="rows", out_specs=None, axis="rows")
    i = mesh_lib.axis_index("date")
    mesh_lib.shard_rows(x, mesh, axis="modle")
    mesh_lib.make_mesh((8,), ("dta",))
    mesh_lib.make_hybrid_mesh((4,), (2,), ("dta",))
    return mesh.axis_devices("rows"), i
"""

    def test_fires_on_literal_axis_names(self, tmp_path):
        findings = _lint_snippet(tmp_path, self.VIOLATION)
        assert _codes(findings) == ["mesh-axis-name"] * 6
        assert {"'rows'", "'date'", "'modle'", "'dta'"} <= {
            f.message.split()[3] for f in findings}

    def test_registry_constants_and_valid_literals_are_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS


def fold(mesh, x, body, axis):
    mesh_lib.shard_map(body, mesh, in_specs=DATA_AXIS, out_specs=None, axis=DATA_AXIS)
    mesh_lib.shard_rows(x, mesh, (DATA_AXIS, MODEL_AXIS))
    mesh_lib.make_mesh((2, 4), ("data", "model"))
    mesh_lib.axis_size(mesh, axis)
    return mesh.axis_devices(mesh_lib.MODEL_AXIS), "data".join(["a"])
""")

    def test_fires_on_unknown_axis_constant(self, tmp_path):
        findings = _lint_snippet(tmp_path, """
from keystone_tpu_torch.parallel.mesh import ROWS_AXIS, axis_index


def fold():
    return axis_index(ROWS_AXIS)
""")
        assert _codes(findings) == ["mesh-axis-name"]
        assert "ROWS_AXIS" in findings[0].message


class TestExplicitSeedRule:
    VIOLATION = """
import torch


def draw():
    g = torch.Generator().manual_seed(7)
    return torch.randn(3, generator=g)


def pinned():
    torch.manual_seed(0)


def defaulted(seed=None):
    return seed


def kwonly(*, seed=None):
    return seed
"""

    def test_fires_on_each_violation_form(self, tmp_path):
        findings = _lint_snippet(tmp_path, self.VIOLATION)
        assert _codes(findings) == ["explicit-seed"] * 4

    def test_explicit_integer_seeds_are_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
import torch


def draw(seed: int = 0, *, other_seed: int = 3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    torch.manual_seed(int(other_seed))
    return torch.randn(3, generator=g)


def later(gen, seed: int = 1):
    return gen.manual_seed(5)
""")

    def test_tests_scripts_and_the_smoke_script_are_exempt(self, tmp_path):
        for rel in ("scripts/torch_sweep.py", "tests/helper.py", "test_torch_demo.py",
                    "chip_smoke.py", "conftest.py"):
            f = tmp_path / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(self.VIOLATION)
            assert not lint_file(f), rel


class TestDecisionEventRule:
    def test_bare_decision_event_is_flagged(self, tmp_path):
        src = """
def emit(tracer):
    tracer.event("zoo.decision", action="evict", tenant="t1")
"""
        findings = _lint_snippet(tmp_path, src, rules=["decision-event"])
        assert _codes(findings) == ["decision-event"]
        # The reference's linter reads the snippet the same way.
        f = tmp_path / "ref.py"
        f.write_text(src)
        assert _codes(jlint.lint_file(f, rules=["decision-event"])) == ["decision-event"]

    def test_schema_and_to_args_spread_are_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, """
class Decision:
    def to_args(self):
        return {"candidates": [], "winner": "a", "reason": "r"}


def emit(tracer, d, ctx):
    tracer.event("cost.decision", candidates=[], winner="a", reason="r")
    tracer.event("placement.decision", **d.to_args())
    tracer.event("zoo.decision", **ctx)
    tracer.event("zoo.evict", tenant="t")
""", rules=["decision-event"])


class TestTorchCleanModuleRule:
    def test_fires_on_torch_imports_at_any_scope(self, tmp_path):
        findings = _lint_snippet(tmp_path, """# lint: torch-clean-module
import socket
import torch.distributed


def late():
    from torch import nn
    return nn
""")
        assert _codes(findings) == ["torch-clean-module", "torch-clean-module"]

    def test_unmarked_and_stdlib_modules_are_clean(self, tmp_path):
        assert not _lint_snippet(tmp_path, "import torch\n", name="a.py")
        assert not _lint_snippet(tmp_path, "# lint: torch-clean-module\nimport socket\n",
                                 name="b.py")

    def test_fleet_router_modules_are_marked(self):
        for rel in ("serving/fleet.py", "serving/fleet_rpc.py"):
            src = (REPO / "keystone_tpu_torch" / rel).read_text()
            assert "# lint: torch-clean-module" in "\n".join(src.splitlines()[:40]), rel


class TestDriver:
    def test_unparseable_file_is_a_finding(self, tmp_path):
        assert _codes(_lint_snippet(tmp_path, "def broken(:\n")) == ["parse"]

    def test_rule_selection(self, tmp_path):
        assert not _lint_snippet(tmp_path, TestDeviceOffThreadRule.VIOLATION,
                                 rules=["thread-join"])

    def test_cli_exit_codes(self, tmp_path, capsys):
        from keystone_tpu_torch.tools import lint

        bad = tmp_path / "bad.py"
        bad.write_text("from keystone_tpu_torch.utils import faults\n"
                       'faults.maybe_fail("nope")\n')
        assert lint.main([str(bad)]) == 1
        good = tmp_path / "good.py"
        good.write_text("x = 1\n")
        assert lint.main([str(good)]) == 0
        assert "lint clean" in capsys.readouterr().out

    def test_all_rules_have_fixture_coverage(self):
        source = Path(__file__).read_text()
        for rule in RULES:
            assert f'"{rule}"' in source, rule
