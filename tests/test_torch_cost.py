"""The port's cost-model solver selector against the JAX package, on the CPU.

``keystone_tpu_torch.ops.learning.cost.LeastSquaresEstimator`` prices the
reference's candidates with the reference's EC2 weight family on one
machine. The reference is run with ``KEYSTONE_COST_WEIGHTS=ec2`` and
``num_machines=1`` (the test env gives JAX 8 CPU devices, which would shard
its capacity 8x), and both sides get the same device and host budgets.

What is held, and to what:
  - each candidate's ``cost`` and ``resident_bytes``, and the streaming
    choice's tier helpers and ``pick_tile_rows``: equal to 1e-12 relative
    (Python float arithmetic on both sides, in the same order);
  - whole-selector replays of the reference's own replay geometries
    (tests/test_cost_replay.py): the same winner type and label, the same
    reason, and per candidate the same cost (1e-12 relative), feasibility
    and resident bytes;
  - the sample collector: the same ``total_n``, ``source_row_bytes`` and
    ``total_d`` reach ``optimize``, it picks the same operator, and the
    optimized plans match node for node;
  - TIMIT ``--solver auto`` end to end at a small size, in the reference's
    call order (apply first), at a budget where the block chain wins and at
    one where only the streaming tier fits: the same route, weights within
    1e-4 relative Frobenius (the tolerance tests/test_torch_timit_slice.py
    and tests/test_torch_streaming.py hold those routes to: the same
    float32 Gauss-Seidel iterates, reordered sums) and predicted labels at
    least 99.5% identical.
"""

import math
import types

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data.loaders import synthetic_timit as t_synthetic_timit
from keystone_tpu_torch.ops import sparse as tsparse
from keystone_tpu_torch.ops.learning import block as tblock
from keystone_tpu_torch.ops.learning import cost as tcost
from keystone_tpu_torch.ops.learning import lbfgs as tlbfgs
from keystone_tpu_torch.ops.learning import linear as tlinear
from keystone_tpu_torch.ops.learning import sketch as tsketch
from keystone_tpu_torch.ops.learning import streaming_ls as tsls
from keystone_tpu_torch.ops.stats import CosineRandomFeatures as TCosineRandomFeatures
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
from keystone_tpu_torch.parallel import streaming as tstream
from keystone_tpu_torch.pipelines import timit as t_timit
from keystone_tpu_torch.workflow import DefaultOptimizer as TDefaultOptimizer
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

import jax
import jax.numpy as jnp

from keystone_tpu import obs
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import LabeledData as JLabeledData
from keystone_tpu.data.loaders import synthetic_timit as j_synthetic_timit
from keystone_tpu.ops import sparse as jsparse
from keystone_tpu.ops.learning import block as jblock
from keystone_tpu.ops.learning import cost as jcost
from keystone_tpu.ops.learning import lbfgs as jlbfgs
from keystone_tpu.ops.learning import linear as jlinear
from keystone_tpu.ops.learning import sketch as jsketch
from keystone_tpu.ops.learning import streaming_ls as jsls
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
from keystone_tpu.parallel import streaming as jstream
from keystone_tpu.pipelines import timit as j_timit
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.optimizer import DefaultOptimizer as JDefaultOptimizer

REL = 1e-12
GiB = 1 << 30
EC2 = (3.8e-4, 2.9e-1, 1.32)


@pytest.fixture(autouse=True)
def ec2_weights(monkeypatch):
    """The reference prices with its EC2 family (the port's only one), and
    both optimizers start from empty state tables."""
    monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
    monkeypatch.delenv("KEYSTONE_HOST_BUDGET_BYTES", raising=False)
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _close(a, b) -> bool:
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * abs(b)


# ---------------------------------------------------------------------------
# Each candidate's cost and capacity models
# ---------------------------------------------------------------------------

# (n, d, k, sparsity): the replay geometries and the two card geometries.
GEOMETRIES = {
    "timit resident": (262_144, 16_384, 147, 1.0),
    "timit past the wall": (2_200_000, 16_384, 147, 1.0),
    "timit card resident": (65_536, 16_384, 147, 1.0),
    "timit card past the wall": (1_310_720, 16_384, 147, 1.0),
    "amazon sparse": (500_000, 16_384, 2, 82 / 16_384),
    "amazon compressed": (30_000_000, 16_384, 2, 82 / 16_384),
    "small dense": (4_096, 1_024, 147, 1.0),
    "past int16": (1_000_000, 40_000, 2, 1e-3),
}


def _candidates(t, j):
    """Candidate name -> (port estimator, reference estimator)."""
    return {
        "dense lbfgs": (t[0].DenseLBFGSwithL2(lam=1e-3, num_iterations=20),
                        j[0].DenseLBFGSwithL2(lam=1e-3, num_iterations=20)),
        "sparse gather": (t[0].SparseLBFGSwithL2(lam=1e-3, num_iterations=20),
                          j[0].SparseLBFGSwithL2(lam=1e-3, num_iterations=20)),
        "sparse gram": (t[0].SparseLBFGSwithL2(num_iterations=20, solver="gram"),
                        j[0].SparseLBFGSwithL2(num_iterations=20, solver="gram")),
        "sparse compressed": tuple(
            m.SparseLBFGSwithL2(num_iterations=20, solver="gram", compress="int16_bf16")
            for m in (t[0], j[0])),
        "block 4096 x 3": (t[1].BlockLeastSquaresEstimator(4096, 3),
                           j[1].BlockLeastSquaresEstimator(4096, 3)),
        "block 1000 x 5": (t[1].BlockLeastSquaresEstimator(1000, 5, lam=1e-4),
                           j[1].BlockLeastSquaresEstimator(1000, 5, lam=1e-4)),
        "exact": (t[2].LinearMapEstimator(1e-4), j[2].LinearMapEstimator(1e-4)),
        "sketched estimator": (t[2].SketchedLeastSquaresEstimator(lam=1e-3),
                               j[2].SketchedLeastSquaresEstimator(lam=1e-3)),
        "srht": (t[3].SketchedLeastSquares(lam=1e-3), j[3].SketchedLeastSquares(lam=1e-3)),
        "ihs": (t[3].IterativeHessianSketch(lam=1e-3), j[3].IterativeHessianSketch(lam=1e-3)),
    }


# The streaming choice's owner-set fields: (raw_row_bytes, input_is_sparse,
# budget_bytes). The slab follows the budget as the selector sets it.
STREAMING_STATES = {
    "gram tier": (1760.0, False, 0.85 * 80 * GiB),
    "block tier": (1760.0, False, 0.85 * 2 * GiB),
    "sparse input": (328.0, True, 0.85 * 16 * GiB),
    "unset raw width": (None, False, 0.85 * 16 * GiB),
    "no owner": (None, None, None),
}


def _streaming_pair(state):
    raw, sparse, budget = STREAMING_STATES[state]
    pair = (tsls.StreamingLeastSquaresChoice(num_iter=3, block_size_hint=4096),
            jsls.StreamingLeastSquaresChoice(num_iter=3, block_size_hint=4096))
    for choice in pair:
        if budget is not None:
            choice.raw_row_bytes, choice.input_is_sparse = raw, sparse
            choice.slab_bytes = int(min(2 << 30, budget // 4))
            choice.budget_bytes = budget
    return pair


class TestCandidateModels:
    @pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
    @pytest.mark.parametrize("candidate", sorted(_candidates(
        (tlbfgs, tblock, tlinear, tsketch), (jlbfgs, jblock, jlinear, jsketch))))
    def test_cost_and_resident_bytes(self, geometry, candidate):
        port, ref = _candidates((tlbfgs, tblock, tlinear, tsketch),
                                (jlbfgs, jblock, jlinear, jsketch))[candidate]
        n, d, k, sparsity = GEOMETRIES[geometry]
        for machines in (1, 4):
            got = port.cost(n, d, k, sparsity, machines, *EC2)
            want = ref.cost(n, d, k, sparsity, machines, *EC2)
            assert _close(got, want), (got, want)
            got = port.resident_bytes(n, d, k, sparsity, machines)
            want = ref.resident_bytes(n, d, k, sparsity, machines)
            assert _close(got, want), (got, want)

    @pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
    @pytest.mark.parametrize("state", sorted(STREAMING_STATES))
    def test_streaming_choice(self, geometry, state):
        port, ref = _streaming_pair(state)
        n, d, k, sparsity = GEOMETRIES[geometry]
        assert _close(port.cost(n, d, k, sparsity, 1, *EC2), ref.cost(n, d, k, sparsity, 1, *EC2))
        assert _close(port.resident_bytes(n, d, k, sparsity, 1),
                      ref.resident_bytes(n, d, k, sparsity, 1))
        assert port._gram_tier_ok(d) == ref._gram_tier_ok(d)
        assert port._block_tier_bs(d) == ref._block_tier_bs(d)

    def test_streaming_states_reach_both_tiers(self):
        # The states above are not vacuous: one is past the gram tier.
        assert _streaming_pair("gram tier")[0]._gram_tier_ok(16_384)
        assert not _streaming_pair("block tier")[0]._gram_tier_ok(16_384)

    @pytest.mark.parametrize("d", [1, 300, 1_024, 16_384, 16_385, 10 ** 7])
    def test_pick_tile_rows(self, d):
        for itemsize in (2, 4):
            assert tstream.pick_tile_rows(d, itemsize) == jstream.pick_tile_rows(d, itemsize)
            for slab in (1 << 20, 12_500_000, 2 << 30, 17 << 30):
                assert (tstream.pick_tile_rows(d, itemsize, slab_bytes=slab)
                        == jstream.pick_tile_rows(d, itemsize, slab_bytes=slab))

    def test_weights_are_the_reference_ec2_family(self):
        assert (tcost.EC2_CPU_WEIGHT, tcost.EC2_MEM_WEIGHT, tcost.EC2_NETWORK_WEIGHT) == EC2
        assert EC2 == (jcost.EC2_CPU_WEIGHT, jcost.EC2_MEM_WEIGHT, jcost.EC2_NETWORK_WEIGHT)
        for name in ("EC2_SPARSE_GATHER_OVERHEAD", "EC2_SRHT_SKETCH_OVERHEAD",
                     "EC2_COUNTSKETCH_OVERHEAD", "DEFAULT_HBM_BYTES",
                     "DEFAULT_HBM_UTILIZATION", "DEFAULT_HOST_BYTES",
                     "DEFAULT_HOST_UTILIZATION"):
            assert getattr(tcost, name) == getattr(jcost, name), name
        est = tcost.LeastSquaresEstimator()
        assert est.num_machines == 1
        assert [tcost.candidate_label(o[0]) for o in est.options] == [
            jcost.candidate_label(o[0]) for o in jcost.LeastSquaresEstimator().options]

    def test_budgets(self, monkeypatch):
        assert tcost.device_memory_bytes() == tcost.DEFAULT_HBM_BYTES
        assert tcost.device_memory_bytes("cpu") == tcost.DEFAULT_HBM_BYTES
        monkeypatch.setenv("KEYSTONE_HOST_BUDGET_BYTES", "3e9")
        assert tcost.host_memory_bytes() == jcost.host_memory_bytes() == 3_000_000_000
        monkeypatch.delenv("KEYSTONE_HOST_BUDGET_BYTES")
        assert tcost.host_memory_bytes() == jcost.host_memory_bytes()


# ---------------------------------------------------------------------------
# Whole-selector replays
# ---------------------------------------------------------------------------


def _dense_sample(n_total, d, k, seed):
    """The reference's replay sample: 24 rows, the full n and raw TIMIT
    rows of 440 float32 upstream (tests/test_cost_replay.py)."""
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


# name -> (sample factory, selector kwargs)
REPLAYS = {
    "timit resident": (lambda: _dense_sample(262_144, 16_384, 147, 0),
                       dict(lam=1e-4, hbm_bytes=48 << 30)),
    "timit past the wall": (lambda: _dense_sample(2_200_000, 16_384, 147, 0),
                            dict(lam=1e-4, hbm_bytes=16 << 30)),
    "amazon sparse": (lambda: _sparse_sample(500_000, 16_384, 82, 2, 4),
                      dict(lam=1e-3, hbm_bytes=16 << 30)),
    "amazon compressed resident": (lambda: _sparse_sample(30_000_000, 16_384, 82, 2, 8),
                                   dict(lam=1e-3, hbm_bytes=16 << 30)),
    # Raw and compressed gram price the same and both fit: the first wins.
    "first-minimum tie": (lambda: _sparse_sample(500_000, 16_384, 82, 2, 5),
                          dict(lam=1e-2, hbm_bytes=24 << 30)),
    # Nothing fits: the least-resident candidate.
    "all infeasible": (lambda: _dense_sample(2_200_000, 16_384, 147, 1),
                       dict(lam=1e-4, hbm_bytes=1 << 30)),
    "allow approximate": (lambda: _sparse_sample(500_000, 16_384, 82, 2, 4),
                          dict(lam=1e-3, hbm_bytes=16 << 30, allow_approximate=True)),
    "timit card past the wall": (lambda: _dense_sample(1_310_720, 16_384, 147, 2),
                                 dict(lam=0.0, hbm_bytes=80 << 30, block_size=4096)),
}


def _replay(name):
    make, kw = REPLAYS[name]
    (ts, tls), (js, jls) = make()
    port = tcost.LeastSquaresEstimator(host_budget_bytes=64 << 30, **kw)
    ref = jcost.LeastSquaresEstimator(num_machines=1, host_budget_bytes=64 << 30, **kw)
    t_chosen = port.optimize(ts, tls)
    with obs.tracing() as trace:
        j_chosen = ref.optimize(js, jls)
    (audit,) = [
        e["args"] for e in trace.events
        if e["type"] == "event" and e["name"] == "cost.decision"
        and e["args"]["decision"] == "least_squares_solver"
    ]
    return port, t_chosen, ref, j_chosen, audit


def _inner(chosen):
    return getattr(chosen, "estimator", chosen)


class TestSelectorReplays:
    @pytest.mark.parametrize("name", sorted(REPLAYS))
    def test_same_decision(self, name):
        port, t_chosen, ref, j_chosen, audit = _replay(name)
        decision = port.last_decision
        assert type(t_chosen).__name__ == type(j_chosen).__name__
        assert type(_inner(t_chosen)).__name__ == type(_inner(j_chosen)).__name__
        assert decision["winner"] == audit["winner"]
        assert decision["reason"] == audit["reason"]
        assert len(decision["candidates"]) == len(audit["candidates"]) == len(ref.options)
        for got, want in zip(decision["candidates"], audit["candidates"]):
            assert got["label"] == want["label"]
            assert got["feasible"] == want["feasible"], (got, want)
            assert _close(got["resident_bytes"], want["resident_bytes"]), (got, want)
            if want["cost_s"] is None:
                assert got["cost_s"] is None
            else:
                assert _close(got["cost_s"], want["cost_s"]), (got, want)
        for key in ("n", "d", "k", "sparsity", "machines", "hbm_budget_bytes",
                    "host_budget_bytes"):
            assert decision["context"][key] == audit[key], key

    def test_cases_reach_the_branches_they_name(self):
        def decision(name):
            return _replay(name)[0].last_decision

        assert decision("timit resident")["winner"] == "BlockLeastSquaresEstimator"
        for name in ("timit past the wall", "timit card past the wall"):
            assert decision(name)["winner"] == "StreamingLeastSquaresChoice"
        assert decision("amazon compressed resident")["winner"] == (
            "SparseLBFGSwithL2[gram,int16_bf16]")
        tie = decision("first-minimum tie")
        costs = {c["label"]: c["cost_s"] for c in tie["candidates"]}
        assert costs["SparseLBFGSwithL2[gram]"] == costs["SparseLBFGSwithL2[gram,int16_bf16]"]
        assert tie["winner"] == "SparseLBFGSwithL2[gram]"
        assert decision("all infeasible")["reason"] == "least_resident_fallback"
        labels = [c["label"] for c in decision("allow approximate")["candidates"]]
        assert labels[-3:] == ["SketchedLeastSquaresEstimator", "SketchedLeastSquares",
                               "IterativeHessianSketch"]

    def test_card_geometry_is_past_the_wall_by_a_margin(self):
        # chip_smoke.py's past-the-wall phase: every resident candidate over
        # the budget by more than 5% on an 80 GB card.
        decision = _replay("timit card past the wall")[0].last_decision
        budget = decision["context"]["hbm_budget_bytes"]
        for c in decision["candidates"]:
            if c["label"] != "StreamingLeastSquaresChoice":
                assert c["resident_bytes"] > 1.05 * budget, c

    def test_decision_is_sampled_on_the_host_from_card_style_tensors(self):
        # Sparsity is an exact ratio of counts: one exact zero in 24 x 5.
        X = np.ones((24, 5), np.float32)
        X[3, 2] = 0.0
        s = TDataset.of(torch.from_numpy(X))
        s.total_n = 1000
        est = tcost.LeastSquaresEstimator(hbm_bytes=16 << 30, host_budget_bytes=1 << 30)
        est.optimize(s, TDataset.of(torch.ones((24, 3))))
        assert est.last_decision["context"]["sparsity"] == 119 / 120
        assert est.last_decision["context"]["d"] == 5


# ---------------------------------------------------------------------------
# The sample collector
# ---------------------------------------------------------------------------


def _recording(cls):
    class Recording(cls):
        def optimize(self, sample, labels_sample):
            chosen = super().optimize(sample, labels_sample)
            self.seen = {
                "total_n": getattr(sample, "total_n", None),
                "source_row_bytes": getattr(sample, "source_row_bytes", None),
                "total_d": getattr(sample, "total_d", None),
                "chosen": type(getattr(chosen, "estimator", chosen)).__name__,
            }
            return chosen

    return Recording


def _plan(optimizer, graph):
    plan, _ = optimizer.execute(graph, {})
    return {
        node.id: (
            plan.get_operator(node).label,
            tuple((type(d).__name__, d.id) for d in plan.get_dependencies(node)),
        )
        for node in plan.nodes
    }


def _collector_pipeline(package, kind):
    rng = np.random.default_rng(3)
    labels_np = rng.integers(0, 4, size=256)
    if package == "jax":
        Dataset, Labels, cost, conv = JDataset, JLabels, jcost, jnp.asarray
        featurizer = (JCosineRandomFeatures(440, 64, 0.05, seed=1) if kind == "dense"
                      else jsparse.Sparsify())
        kw = dict(num_machines=1)
    else:
        Dataset, Labels, cost, conv = TDataset, TLabels, tcost, torch.from_numpy
        featurizer = (TCosineRandomFeatures(440, 64, 0.05, seed=1, device="cpu")
                      if kind == "dense" else tsparse.Sparsify())
        kw = {}
    if kind == "dense":
        X = t_synthetic_timit(256, seed=2, device="cpu").data.to_numpy()
    else:
        X = rng.normal(size=(256, 300)).astype(np.float32)
        X[rng.random(X.shape) < 0.9] = 0.0
    est = _recording(cost.LeastSquaresEstimator)(
        lam=1e-3, hbm_bytes=16 << 30, host_budget_bytes=1 << 30, **kw)
    labels = Labels(4)(Dataset.of(conv(labels_np)))
    pipeline = featurizer.to_pipeline().and_then(est, Dataset.of(conv(X)), labels)
    return est, pipeline


class TestSampleCollector:
    @pytest.mark.parametrize("kind", ["dense", "sparse"])
    def test_same_annotations_choice_and_plan(self, kind):
        t_est, t_pipe = _collector_pipeline("torch", kind)
        j_est, j_pipe = _collector_pipeline("jax", kind)
        t_plan = _plan(TDefaultOptimizer(), t_pipe.executor.graph)
        j_plan = _plan(JDefaultOptimizer(), j_pipe.executor.graph)
        assert t_est.seen == j_est.seen
        assert t_est.seen["total_n"] == 256
        if kind == "dense":
            assert t_est.seen["source_row_bytes"] == 440 * 4
            assert t_est.seen["total_d"] is None
        else:
            assert t_est.seen["source_row_bytes"] == 300 * 4
            assert t_est.seen["total_d"] == 300
        assert t_plan == j_plan

    def test_sparse_source_width_and_inheritance(self):
        # A sparse source whose first rows miss the top id: total_d comes
        # from the full index array, and survives a width-preserving node.
        idx = np.full((64, 3), -1, np.int32)
        idx[:, 0] = np.arange(64) % 10
        idx[40, 1] = 499
        vals = np.ones((64, 3), np.float32)
        seen = {}
        for name, Dataset, conv, cost, Sparsify, Labels, kw in (
            ("torch", TDataset, torch.from_numpy, tcost, tsparse.Sparsify, TLabels, {}),
            ("jax", JDataset, jnp.asarray, jcost, jsparse.Sparsify, JLabels,
             dict(num_machines=1)),
        ):
            est = _recording(cost.LeastSquaresEstimator)(
                hbm_bytes=16 << 30, host_budget_bytes=1 << 30, **kw)
            data = Dataset({"indices": conv(idx), "values": conv(vals)}, n=64)
            labels = Labels(2)(Dataset.of(conv(np.arange(64) % 2)))
            Sparsify().to_pipeline().and_then(est, data, labels).fit()
            seen[name] = est.seen
        assert seen["torch"] == seen["jax"]
        assert seen["torch"]["total_d"] == 500
        assert seen["torch"]["source_row_bytes"] == 3 * 4 + 3 * 4


# ---------------------------------------------------------------------------
# TIMIT --solver auto end to end, both sides of a forced budget
# ---------------------------------------------------------------------------

# Four branches of 256 features (d = 1,024), one epoch, 8,192 rows: at a
# 16 GiB budget the block chain is the argmin; at 56 MiB only the streaming
# tier's operands fit (the compressed gram engine's, the next smallest, do
# not).
AUTO = dict(num_cosines=4, block_size=256, synthetic_n=8192, num_epochs=1, lam=1e-3)
BUDGETS = {"block chain": 16 << 30, "streaming": 56 << 20}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _j_chain_model(chained):
    """The fitted model inside the reference's local ``Chained`` class."""
    fn = type(chained).batch_apply
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))["inner"]


def _one(fitted, cls):
    (op,) = [o for o in fitted.transformer_graph.operators.values() if isinstance(o, cls)]
    return op


def _f32_timit(n, seed):
    """The reference's synthetic TIMIT rows in float32, as both packages
    make them outside the x64 test env: the streaming tier prices the raw
    row width (1,760 bytes; float64 would be 3,520)."""
    rows = j_synthetic_timit(n, seed=seed)
    return JLabeledData(np.asarray(rows.data.array, np.float32), np.asarray(rows.labels.array))


def run_auto_both(monkeypatch, hbm_bytes, config=AUTO):
    """TIMIT --solver auto on both packages, apply first, the same rows,
    draws and device budget; the reference on one machine."""
    monkeypatch.setattr(j_timit, "synthetic_timit", _f32_timit)
    monkeypatch.setattr(jcost, "device_memory_bytes", lambda: hbm_bytes)
    monkeypatch.setattr(jcost, "jax", types.SimpleNamespace(devices=lambda: jax.devices()[:1]))
    monkeypatch.setattr(tcost, "device_memory_bytes", lambda device=None: hbm_bytes)
    j_cfg = j_timit.TimitConfig(solver="auto", **config)
    JPipelineEnv.get_or_create().reset()
    pipe, j_train, j_test = j_timit.run(j_cfg)
    j_fitted = pipe.fit()
    test = _f32_timit(max(j_cfg.synthetic_n // 4, 256), seed=j_cfg.seed + 1)
    j_pred = np.asarray(pipe.apply(test.data).get().to_numpy())
    models = [
        interop.params_from_jax({"W": np.asarray(rf.W), "b": np.asarray(rf.b)}, device="cpu")
        for rf in (JCosineRandomFeatures(440, j_cfg.block_size, j_cfg.gamma, seed=j_cfg.seed + i)
                   for i in range(j_cfg.num_cosines))
    ]
    JPipelineEnv.get_or_create().reset()
    TPipelineEnv.get_or_create().reset()
    result = t_timit.run(t_timit.TimitConfig(solver="auto", **config), device="cpu",
                         cosine_models=models, fit_first=False)
    t_test = t_synthetic_timit(max(j_cfg.synthetic_n // 4, 256), seed=j_cfg.seed + 1,
                               device="cpu")
    t_pred = result.fitted.apply(t_test.data).to_numpy()
    return dict(j_fitted=j_fitted, t_fitted=result.fitted, j_pred=j_pred, t_pred=t_pred,
                j_err=(j_train.total_error, j_test.total_error),
                t_err=(result.train_eval.total_error, result.test_eval.total_error),
                decision=result.selector.last_decision)


def weights_of(run):
    """(route, port weights, reference weights) of a fitted auto run."""
    t_ops = {type(o).__name__ for o in run["t_fitted"].transformer_graph.operators.values()}
    if "StreamingFeaturizedLinearModel" in t_ops:
        t_model = _one(run["t_fitted"], tsls.StreamingFeaturizedLinearModel)
        j_model = _one(run["j_fitted"], jsls.StreamingFeaturizedLinearModel)
        return "streaming", t_model.W_stack.numpy(), np.asarray(j_model.W_stack)
    t_model = _one(run["t_fitted"], tcost.Chained).model
    j_model = _j_chain_model(_j_chained(run["j_fitted"]))
    if isinstance(t_model, tblock.BlockLinearMapper):
        return ("block chain", np.concatenate([x.numpy() for x in t_model.xs]),
                np.concatenate([np.asarray(x) for x in j_model.xs]))
    return "exact chain", t_model.x.numpy(), np.asarray(j_model.x)


def _j_chained(fitted):
    (op,) = [o for o in fitted.transformer_graph.operators.values()
             if type(o).__name__ == "Chained"]
    return op


@pytest.fixture(scope="module", params=sorted(BUDGETS))
def auto_runs(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        mp.delenv("KEYSTONE_HOST_BUDGET_BYTES", raising=False)
        return request.param, run_auto_both(mp, BUDGETS[request.param])


class TestTimitAuto:
    def test_route(self, auto_runs):
        expected, run = auto_runs
        route, _, _ = weights_of(run)
        assert route == expected, run["decision"]
        winner = {"block chain": "BlockLeastSquaresEstimator",
                  "streaming": "StreamingLeastSquaresChoice"}[expected]
        assert run["decision"]["winner"] == winner

    def test_weights(self, auto_runs):
        _, run = auto_runs
        _, t_W, j_W = weights_of(run)
        assert t_W.shape == j_W.shape
        assert _rel(t_W, j_W) <= 1e-4

    def test_fitted_pipeline_saves_and_loads(self, auto_runs, tmp_path):
        # The chain's fitted form is a module-level class: it pickles.
        from keystone_tpu_torch.workflow import FittedPipeline

        _, run = auto_runs
        path = str(tmp_path / "fitted.pkl")
        run["t_fitted"].save(path)
        rows = t_synthetic_timit(64, seed=9, device="cpu").data
        np.testing.assert_array_equal(FittedPipeline.load(path).apply(rows).to_numpy(),
                                      run["t_fitted"].apply(rows).to_numpy())

    def test_predictions_and_errors(self, auto_runs):
        _, run = auto_runs
        assert run["t_pred"].shape == run["j_pred"].shape == (2048,)
        assert np.mean(run["t_pred"] == run["j_pred"]) >= 0.995
        for t_err, j_err in zip(run["t_err"], run["j_err"]):
            assert abs(t_err - j_err) <= 0.005
