"""ROADMAP C.14: the processes that own their heap serve their storms with
it frozen (``serving.batcher.frozen_heap()``): ``run.py learn``, whose two
replicas serve while its trainer refits beside them, and
``tools/fleet_chaos.py``'s router process. A full (generation 2)
collection walks every tracked object of the process and stops every
serving thread while it runs; inside the frozen block a collection walks
only what was made since. After the pattern of
``tests/test_torch_serving_zoo.py::TestCollectorIsolation``."""

import gc
import json

import pytest


class _StormProbe:
    """Wraps a storm function: records, at the storm's start, whether the
    heap is frozen and whether an object made before the storm is still
    walked, and, through the storm, every generation-2 collection that
    ran with the pre-storm heap in reach (nothing frozen)."""

    def __init__(self, storm):
        self.storm = storm
        self.before = {"state made before the storm": [1, 2, 3]}
        self.freeze_count = None
        self.before_walked = None
        self.full_walks = []

    def _on_gc(self, phase, info):
        if phase == "start" and info["generation"] == 2 and gc.get_freeze_count() == 0:
            self.full_walks.append(info)

    def __call__(self, *args, **kwargs):
        self.freeze_count = gc.get_freeze_count()
        self.before_walked = any(o is self.before for o in gc.get_objects())
        gc.callbacks.append(self._on_gc)
        try:
            out = self.storm(*args, **kwargs)
            gc.collect()  # a full collection inside the storm: it must skip the heap
            return out
        finally:
            gc.callbacks.remove(self._on_gc)

    def check(self):
        assert self.freeze_count is not None, "the storm never ran"
        assert self.freeze_count > 0
        assert not self.before_walked
        assert self.full_walks == []
        assert gc.get_freeze_count() == 0  # the heap is handed back
        assert any(o is self.before for o in gc.get_objects())


class TestLearnStorm:
    def test_learn_serves_and_refits_with_the_heap_frozen(self, capsys, monkeypatch):
        from keystone_tpu_torch import run, serving

        probe = _StormProbe(serving.run_open_loop)
        monkeypatch.setattr(serving, "run_open_loop", probe)
        rc = run.main(["learn", "--device", "cpu", "--duration-s", "2",
                       "--segments", "8", "--canary-sustain-s", "0.3"])
        out = capsys.readouterr()
        assert rc == 0, out.err
        summary = json.loads(out.out.strip().splitlines()[-1])
        assert summary["accounting_ok"] is True
        assert summary["trainer_segments_fit"] == 8
        probe.check()


class TestFleetChaosRouter:
    def test_router_routes_the_storm_with_the_heap_frozen(self, capsys, monkeypatch):
        from keystone_tpu_torch.serving import loadgen
        from keystone_tpu_torch.tools import fleet_chaos

        probe = _StormProbe(loadgen.run_multi_tenant_open_loop)
        monkeypatch.setattr(loadgen, "run_multi_tenant_open_loop", probe)
        rc = fleet_chaos.main(["--device", "cpu", "--duration-s", "1.5", "--tenants", "2"])
        out = capsys.readouterr()
        assert rc == 0, out.err
        verdict = json.loads(out.out[out.out.index("{"):])
        assert verdict["books_balance"] is True and verdict["respawn_fired"] is True
        probe.check()


@pytest.fixture(autouse=True)
def _no_frozen_heap_leaks():
    yield
    assert gc.get_freeze_count() == 0
