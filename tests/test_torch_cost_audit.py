"""The port's cost-decision audit against the JAX package, on the CPU.

``cost.LeastSquaresEstimator.optimize`` emits a ``cost.decision`` event
(``decision="least_squares_solver"``) and its ``placement.decision``
mirror, as the reference's does. On the geometries of
``tests/test_cost_replay.py`` (TIMIT resident, TIMIT at full n, Amazon
sparse, the compressed-resident tier, and a budget nothing fits), both run
under ``KEYSTONE_COST_WEIGHTS=ec2``, the two packages' events hold the same
candidate tables (labels, feasibility, host verdicts and resident bytes
exactly, costs within 1e-12 relative), winners, reasons and contexts. The
image-tier and streaming-tier decisions are held the same way. Also: the
weight-family switch's parse and errors, the overheads each estimator takes
from the family at construction, the stamped fit (once, never for a failed
fit), and the workflow spans of ``Pipeline.fit``.
"""

import math

import numpy as np
import pytest
import torch

from keystone_tpu_torch import obs as tobs
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops.learning import cost as tcost
from keystone_tpu_torch.ops.learning import lbfgs as tlbfgs
from keystone_tpu_torch.ops.learning import sketch as tsketch
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator as TLinearMapEstimator
from keystone_tpu_torch.placement import engine as tengine
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow import pipeline as tpipeline

import jax.numpy as jnp

from keystone_tpu import obs as jobs
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import cost as jcost
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

REL = 1e-12


@pytest.fixture(autouse=True)
def ec2_weights(monkeypatch):
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
    monkeypatch.delenv("KEYSTONE_HOST_BUDGET_BYTES", raising=False)
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _dense_sample(n_total, d, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(24, d)).astype(np.float32)
    Y = rng.normal(size=(24, k)).astype(np.float32)
    pair = []
    for Dataset, conv in ((TDataset, torch.from_numpy), (JDataset, jnp.asarray)):
        s, ls = Dataset.of(conv(X)), Dataset.of(conv(Y))
        s.total_n, s.source_row_bytes = n_total, 4.0 * 440
        pair.append((s, ls))
    return pair


def _sparse_sample(n_total, d, nnz, k, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(24, nnz)).astype(np.int32)
    idx[0, 0] = d - 1
    vals = rng.normal(size=(24, nnz)).astype(np.float32)
    Y = rng.normal(size=(24, k)).astype(np.float32)
    pair = []
    for Dataset, conv in ((TDataset, torch.from_numpy), (JDataset, jnp.asarray)):
        s = Dataset({"indices": conv(idx), "values": conv(vals)}, n=24)
        s.total_n, s.source_row_bytes = n_total, nnz * 4.0
        pair.append((s, Dataset.of(conv(Y))))
    return pair


# The geometries of tests/test_cost_replay.py: name -> (samples, selector kwargs).
GEOMETRIES = {
    "timit resident": (lambda: _dense_sample(262_144, 16_384, 147, 0),
                       dict(lam=1e-4, hbm_bytes=48 << 30)),
    "timit full n": (lambda: _dense_sample(2_200_000, 16_384, 147, 0),
                     dict(lam=1e-4, hbm_bytes=16 << 30)),
    "amazon sparse": (lambda: _sparse_sample(500_000, 16_384, 82, 2, 4),
                      dict(lam=1e-3, hbm_bytes=16 << 30)),
    "compressed resident": (lambda: _sparse_sample(30_000_000, 16_384, 82, 2, 8),
                            dict(lam=1e-3, hbm_bytes=16 << 30)),
    "all infeasible": (lambda: _dense_sample(2_200_000, 16_384, 147, 1),
                       dict(lam=1e-4, hbm_bytes=1 << 30)),
    "allow approximate": (lambda: _sparse_sample(500_000, 16_384, 82, 2, 4),
                          dict(lam=1e-3, hbm_bytes=16 << 30, allow_approximate=True)),
}


def _events(trace, name):
    return [e["args"] for e in trace.events if e["type"] == "event" and e["name"] == name]


def _same_candidates(got, want):
    assert [c["label"] for c in got] == [c["label"] for c in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for key, v in w.items():
            if key == "cost_s" and v is not None:
                assert abs(g[key] - v) <= REL * abs(v), (g["label"], g[key], v)
            else:
                assert g[key] == v, (g["label"], key, g[key], v)


def _decide_both(name):
    make, kw = GEOMETRIES[name]
    (ts, tls), (js, jls) = make()
    port = tcost.LeastSquaresEstimator(host_budget_bytes=64 << 30, **kw)
    ref = jcost.LeastSquaresEstimator(num_machines=1, host_budget_bytes=64 << 30, **kw)
    with tobs.tracing() as t_trace:
        t_chosen = port.optimize(ts, tls)
    with jobs.tracing() as j_trace:
        j_chosen = ref.optimize(js, jls)
    return port, t_chosen, t_trace, j_chosen, j_trace


class TestDecisionTables:
    @pytest.mark.parametrize("name", sorted(GEOMETRIES))
    def test_cost_decision_equals_the_reference(self, name):
        port, t_chosen, t_trace, j_chosen, j_trace = _decide_both(name)
        (got,) = _events(t_trace, "cost.decision")
        (want,) = _events(j_trace, "cost.decision")
        assert got["decision"] == want["decision"] == "least_squares_solver"
        assert (got["winner"], got["reason"]) == (want["winner"], want["reason"])
        _same_candidates(got["candidates"], want["candidates"])
        for key in ("n", "d", "k", "machines", "shard_backed", "weights_family"):
            assert got[key] == want[key], key
        for key in ("sparsity", "hbm_budget_bytes", "host_budget_bytes"):
            assert math.isclose(got[key], want[key], rel_tol=REL), key
        assert got["weights"] == want["weights"] == {
            "cpu": 3.8e-4, "mem": 2.9e-1, "network": 1.32, "family": "ec2"}
        # The estimator keeps the same decision as last_decision.
        last = port.last_decision
        assert last["winner"] == got["winner"] and last["candidates"] == got["candidates"]
        assert type(t_chosen).__name__ == type(j_chosen).__name__
        assert t_chosen._pending_cost_outcome is not None

    @pytest.mark.parametrize("name", sorted(GEOMETRIES))
    def test_placement_mirror_equals_the_reference(self, name):
        _, _, t_trace, _, j_trace = _decide_both(name)
        (got,) = _events(t_trace, "placement.decision")
        (want,) = _events(j_trace, "placement.decision")
        assert got["decision"] == want["decision"] == "placement.solver"
        assert (got["winner"], got["reason"], got["weights_family"]) == (
            want["winner"], want["reason"], want["weights_family"])
        _same_candidates(got["candidates"], want["candidates"])

    def test_no_tracer_no_event_and_no_pending_outcome(self):
        make, kw = GEOMETRIES["timit resident"]
        (ts, tls), _ = make()
        chosen = tcost.LeastSquaresEstimator(host_budget_bytes=64 << 30, **kw).optimize(ts, tls)
        assert chosen._pending_cost_outcome is None

    @pytest.mark.parametrize("args", [
        (50_000, 3072, 10, 256, None),
        (50_000, 3072, 10, 256, 2e8),
        (50_000, 3072, 10, 256, 6e8),
    ])
    def test_image_tier_event_equals_the_reference(self, args):
        n, d, k, ips, budget = args
        with tobs.tracing() as t_trace:
            tier, decision = tcost.choose_image_tier(n, d, k, images_per_segment=ips,
                                                     host_budget_bytes=budget)
        with jobs.tracing() as j_trace:
            jtier, _ = jcost.choose_image_tier(n, d, k, images_per_segment=ips,
                                               host_budget_bytes=budget)
        (got,) = _events(t_trace, "cost.decision")
        (want,) = _events(j_trace, "cost.decision")
        assert tier == jtier == got["winner"] == want["winner"] == decision["winner"]
        _same_candidates(got["candidates"], want["candidates"])
        assert got["weights"] == want["weights"]
        (mirror,) = _events(t_trace, "placement.decision")
        assert mirror["decision"] == "placement.image_tier" and mirror["winner"] == tier

    @pytest.mark.parametrize("budget", [16 << 30, 1 << 20])
    def test_streaming_tier_event_equals_the_reference(self, budget):
        d_feat = 4096  # the gram tier under 16 GiB, the block tier under 1 MiB
        rng = np.random.default_rng(0)
        W = rng.normal(size=(d_feat, 16)).astype(np.float32)
        b = rng.normal(size=(d_feat,)).astype(np.float32)
        t_bank = tsls.CosineBankFeaturize(torch.from_numpy(W), torch.from_numpy(b))
        j_bank = jsls.CosineBankFeaturize(jnp.asarray(W), jnp.asarray(b))
        events = []
        for mod, bank, o in ((tsls, t_bank, tobs), (jsls, j_bank, jobs)):
            choice = mod.StreamingLeastSquaresChoice(num_iter=3, lam=1e-4,
                                                     block_size_hint=1024)
            choice.budget_bytes = budget
            with o.tracing() as trace:
                choice.build_estimator(bank, d_feat)
            (args,) = _events(trace, "cost.decision")
            events.append(args)
        got, want = events
        assert got["decision"] == want["decision"] == "streaming_tier"
        for key in ("winner", "reason", "candidates", "d_feat", "budget_bytes", "featurize"):
            assert got[key] == want[key], key


class TestWeightFamilySwitch:
    @pytest.mark.parametrize("raw, family", [
        ("", "ec2"), ("ec2", "ec2"), ("EC2", "ec2"), (" tpu ", "tpu"), ("TPU", "tpu"),
    ])
    def test_named_families(self, monkeypatch, raw, family):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", raw)
        assert tcost.weights_family_name() == family == tengine.active_family()
        consts = tcost._FAMILIES[family]
        assert tcost.active_weights() == (consts["cpu"], consts["mem"], consts["network"])
        assert tcost.sparse_gather_overhead() == consts["sparse_gather_overhead"]
        assert tcost.zoo_page_overhead() == consts["zoo_page_overhead"]
        assert tcost.image_decode_overhead() == consts["image_decode_overhead"]

    def test_tpu_family_carries_the_reference_constants(self, monkeypatch):
        for name in ("CPU_WEIGHT", "MEM_WEIGHT", "NETWORK_WEIGHT", "SPARSE_GATHER_OVERHEAD",
                     "SRHT_SKETCH_OVERHEAD", "COUNTSKETCH_OVERHEAD", "IMAGE_DECODE_OVERHEAD",
                     "ZOO_PAGE_OVERHEAD"):
            assert getattr(tcost, f"TPU_{name}") == getattr(jcost, f"TPU_{name}"), name
            assert getattr(tcost, f"EC2_{name}") == getattr(jcost, f"EC2_{name}"), name
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")
        assert tcost.active_weights() == jcost.active_weights()
        assert tcost.countsketch_overhead() == jcost.countsketch_overhead()

    @pytest.mark.parametrize("bad", ["gpu", "h100", "calibratd:/x.json", "ec2x"])
    def test_unknown_family_raises_and_the_engine_says_custom(self, monkeypatch, bad):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", bad)
        with pytest.raises(ValueError, match="KEYSTONE_COST_WEIGHTS"):
            tcost.weights_family_name()
        with pytest.raises(ValueError, match="KEYSTONE_COST_WEIGHTS"):
            tcost.active_weights()
        assert tengine.active_family() == "custom"

    def test_calibrated_artifact_and_its_errors(self, monkeypatch, tmp_path):
        from keystone_tpu_torch.obs.calibrate import write_calibration_artifact

        path = str(tmp_path / "w.json")
        write_calibration_artifact(path, {"cpu": 7e-15, "mem": 3e-11, "network": 2e-11,
                                          "sparse_gather_overhead": 321.0}, {})
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{path}")
        assert tcost.active_weights() == (7e-15, 3e-11, 2e-11)
        assert tcost.weights_family_name() == tengine.active_family() == "calibrated"
        est = tcost.LeastSquaresEstimator(lam=0.1)
        assert (est.cpu_weight, est.mem_weight) == (7e-15, 3e-11)
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", f"calibrated:{tmp_path}/missing.json")
        with pytest.raises(ValueError, match="KEYSTONE_COST_WEIGHTS"):
            tcost.active_weights()

    def test_overheads_taken_at_construction(self, monkeypatch):
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "tpu")
        gather = tlbfgs.SparseLBFGSwithL2(lam=1e-3, num_iterations=20)
        srht, ihs = tsketch.SketchedLeastSquares(lam=1e-3), tsketch.IterativeHessianSketch(
            lam=1e-3)
        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        assert gather._sparse_overhead == tcost.TPU_SPARSE_GATHER_OVERHEAD
        assert srht._sketch_overhead == tcost.TPU_SRHT_SKETCH_OVERHEAD
        assert ihs._cs_overhead == tcost.TPU_COUNTSKETCH_OVERHEAD
        assert tlbfgs.SparseLBFGSwithL2(lam=1e-3)._sparse_overhead == \
            tcost.EC2_SPARSE_GATHER_OVERHEAD

    def test_explicit_weights_make_a_custom_decision(self):
        make, kw = GEOMETRIES["timit resident"]
        (ts, tls), _ = make()
        est = tcost.LeastSquaresEstimator(host_budget_bytes=64 << 30, cpu_weight=1.0,
                                          mem_weight=2.0, **kw)
        est.optimize(ts, tls)
        assert est.last_decision["context"]["weights"]["family"] == "custom"
        assert est.last_decision["context"]["weights"]["cpu"] == 1.0


class _Ref:
    def __init__(self):
        self.stamps = []

    def stamp(self, measured_s, span_id=None, **extra):
        self.stamps.append((measured_s, span_id, extra))


class _Failing(TLinearMapEstimator):
    def fit(self, data, labels):
        raise RuntimeError("fit failed")


class TestStampedFit:
    @staticmethod
    def _data():
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
        Y = torch.from_numpy(rng.normal(size=(64, 2)).astype(np.float32))
        return TDataset.of(X), TDataset.of(Y)

    def test_stamps_once(self):
        est = TLinearMapEstimator(1e-3)
        ref = est._pending_cost_outcome = _Ref()
        data, labels = self._data()
        with tobs.tracing() as trace:
            est.fit_datasets([data, labels])
            est.fit_datasets([data, labels])
        assert len(ref.stamps) == 1
        measured_s, span_id, extra = ref.stamps[0]
        (span,) = trace.spans("estimator.fit")
        assert measured_s > 0 and span_id == span["span_id"]
        assert extra == {"timing": "single_run_cold"}
        assert est._pending_cost_outcome is None

    def test_never_stamps_a_failed_fit(self):
        est = _Failing(1e-3)
        ref = est._pending_cost_outcome = _Ref()
        with pytest.raises(RuntimeError, match="fit failed"):
            est.fit_datasets(list(self._data()))
        assert ref.stamps == [] and est._pending_cost_outcome is None

    def test_bare_path_without_a_pending_decision(self):
        est = TLinearMapEstimator(1e-3)
        with tobs.tracing() as trace:
            est.fit_datasets(list(self._data()))
        assert trace.spans("estimator.fit") == []

    def test_device_search_reaches_nested_weights(self):
        class Holder:
            def __init__(self, inner):
                self.inner = inner

        t = torch.zeros(2)
        assert tpipeline._cuda_device_of(Holder([{"w": t}])) is None  # CPU tensors only
        tpipeline._sync_fitted(Holder(t))  # a CPU model: returns at once


class TestFusedFitInheritsTheOutcome:
    def test_estimator_fusion_moves_the_pending_outcome(self):
        """The block fit fused with its featurizer (the fit-first route)
        carries the selector's pending outcome, so its fit is stamped."""
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.stats import CosineRandomFeatures
        from keystone_tpu_torch.workflow import fusion

        rng = np.random.default_rng(2)
        X = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
        Y = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
        est = BlockLeastSquaresEstimator(16, 1, lam=1e-2)
        ref = est._pending_cost_outcome = _Ref()
        feat = CosineRandomFeatures(8, 32, 0.5, seed=0, device="cpu")
        pipe = feat.to_pipeline().and_then(est, TDataset.of(X), TDataset.of(Y))
        with tobs.tracing() as trace:
            pipe.fit()
        fused = [n for n in trace.spans("fit.estimator")]
        assert fused and fused[0]["args"]["operator"] == fusion.FusedFitEstimator.__name__
        assert len(ref.stamps) == 1 and est._pending_cost_outcome is None


class TestFitSpans:
    def test_pipeline_fit_spans_equal_the_reference(self):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(128, 6)).astype(np.float32)
        Y = rng.normal(size=(128, 2)).astype(np.float32)
        names = []
        for Dataset, conv, est, o in (
                (TDataset, torch.from_numpy, TLinearMapEstimator(1e-2), tobs),
                (JDataset, jnp.asarray, JLinearMapEstimator(1e-2), jobs)):
            with o.tracing() as trace:
                pipe = est.with_data(Dataset.of(conv(X)), Dataset.of(conv(Y)))
                pipe.fit().apply(Dataset.of(conv(X)))
                pipe.apply(Dataset.of(conv(X))).get()
            names.append({r["name"] for r in trace.events if r["type"] == "span"})
        wanted = {"pipeline.fit", "fit.verify", "fit.optimize", "fit.estimator",
                  "verify.pre_pass"}
        assert wanted <= names[0] and wanted <= names[1]
        rules = {n for n in names[1] if n.startswith("optimizer.rule.")}
        assert rules and rules <= names[0]
        assert ("executor.node" in names[0]) == ("executor.node" in names[1])
