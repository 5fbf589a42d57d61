"""The port's cache placement (keystone_tpu_torch/workflow/autocache.py and
the AutoCachingOptimizer) against the JAX package's, on the CPU.

Each case runs on both packages with the same inputs:
  - tests/test_autocache_reference_sweep.py: the reference suite's 13-node
    plan (AutocCacheRuleSuite.scala) with its injected profiles, greedy's
    exact cached sets at budgets 10 / 75 / 125 / 175 / 350 / 10,000,
    aggressive's {+2, +5}, both strategies end to end (apply(5) == 168),
    the source-descendant selection guard, generalize_profiles;
  - tests/test_autocache_postfusion.py: fusion-preserving placement (no
    Cacher inside a fusable chain or on a fit's featurize input, Cachers
    on multi-consumer and host-decode boundaries), the post-fusion batch
    order, the cross-fit host-boundary reuse, and the executor's observed
    profiles;
  - the bench's host-boundary λ-sweep (bench.py autocache_host_boundary:
    host decode -> 512 -> 4,096 cosine features -> BlockLeastSquares(512,
    1, λ)) at n = 2,048: the same cache insertions and full-size decode
    calls under DefaultOptimizer and greedy AutoCachingOptimizer in both
    packages, and the same weights for every λ.

Tolerances: selections, counts and plan shapes compare exactly; the
sweep's block weights to 1e-5 relative (Frobenius): both packages fit the
same float32 cosine features with one epoch of block coordinate descent
whose 512-wide Gramians sum 2,048 rows in different orders; greedy's
weights equal DefaultOptimizer's bit for bit within one package (a cache
changes where a result is kept, not what is computed).
"""

import importlib

import numpy as np
import pytest
import torch

REF = "keystone_tpu"
PORT = "keystone_tpu_torch"
BOTH = [REF, PORT]


class Pkg:
    def __init__(self, base):
        self.base = base
        self.torch = base == PORT

        def m(mod):
            return importlib.import_module(f"{base}.{mod}")

        self.Dataset = m("data").Dataset
        self.wf = m("workflow")
        self.ac = m("workflow.autocache")
        self.fusion = m("workflow.fusion")
        self.graph = m("workflow.graph")
        self.ops = m("workflow.operators")
        self.opt = m("workflow.optimizer")
        self.executor = m("workflow.executor")
        self.util = m("ops.util")
        self.block = m("ops.learning.block")

    def array(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)) if self.torch else a

    def to_numpy(self, x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)


_PKGS = {}


def pkg(base) -> Pkg:
    if base not in _PKGS:
        _PKGS[base] = Pkg(base)
    return _PKGS[base]


@pytest.fixture
def env_reset():
    yield
    for p in _PKGS.values():
        p.wf.PipelineEnv.get_or_create().reset()


# ---------------------------------------------------------------------------
# The reference suite's plan and profiles
# ---------------------------------------------------------------------------


def _plus_classes(p):
    class TransformerPlus(p.wf.Transformer):
        def __init__(self, plus: int):
            self.plus = plus

        def apply(self, x):
            return x + self.plus

        def __eq__(self, other):
            return isinstance(other, TransformerPlus) and other.plus == self.plus

        def __hash__(self):
            return hash(("TransformerPlus", self.plus))

    class SumEstimator(p.wf.Estimator):
        weight = 4

        def fit(self, data):
            return TransformerPlus(sum(data.to_list()))

    return TransformerPlus, SumEstimator


def _plan(p):
    """The suite's 13-node graph; returns (graph, ids, source, sink)."""
    Plus, SumEst = _plus_classes(p)
    train = p.Dataset.of([1, 2, 3, 4, 5, 6, 7, 8])
    g = p.graph.Graph()
    g, n0 = g.add_node(p.ops.DatasetOperator(train), [])
    g, n1 = g.add_node(Plus(1), [n0])
    g, n2 = g.add_node(Plus(2), [n1])
    g, n3 = g.add_node(Plus(3), [n2])
    g, n4 = g.add_node(Plus(4), [n2])
    g, n5 = g.add_node(Plus(5), [n3, n4])
    g, n6 = g.add_node(SumEst(), [n5])
    g, src = g.add_source()
    g, n8 = g.add_node(Plus(8), [src])
    g, n9 = g.add_node(Plus(9), [n8])
    g, n10 = g.add_node(Plus(10), [n9])
    g, n11 = g.add_node(Plus(11), [n9])
    g, n12 = g.add_node(Plus(12), [n10, n11])
    g, n7 = g.add_node(p.ops.DelegatingOperator(), [n6, n12])
    g, sink = g.add_sink(n7)
    ids = dict(n0=n0, n1=n1, n2=n2, n3=n3, n4=n4, n5=n5, n6=n6, n7=n7)
    return g, ids, src, sink


def _profiles(p, ids):
    big = 1 << 62  # Long.MaxValue stand-in: never fits any budget
    P = p.ac.Profile
    return {
        ids["n0"]: P(10, big), ids["n1"]: P(10, 50), ids["n2"]: P(30, 200),
        ids["n3"]: P(20, 1000), ids["n4"]: P(20, 1000), ids["n5"]: P(20, 100),
    }


@pytest.mark.parametrize("budget,expected", [
    (10, set()), (75, {"n1"}), (125, {"n5"}), (175, {"n1", "n5"}),
    (350, {"n2", "n5"}), (10000, {"n2", "n5"}),
])
def test_greedy_budget_sweep_exact(budget, expected):
    got = {}
    for base in BOTH:
        p = pkg(base)
        g, ids, _, _ = _plan(p)
        cached = p.ac.greedy_cache_set(g, _profiles(p, ids), budget)
        names = {k for k, v in ids.items() if v in cached}
        got[base] = names
    assert got[PORT] == got[REF] == expected


@pytest.mark.parametrize("base", BOTH)
def test_aggressive_picks_multiply_consumed_nodes(base):
    p = pkg(base)
    g, ids, _, _ = _plan(p)
    assert p.ac.AutoCacheRule(p.ac.AggressiveCache())._aggressive(g) == {ids["n2"], ids["n5"]}


@pytest.mark.parametrize("strategy", ["greedy", "aggressive"])
def test_end_to_end_168(strategy, env_reset):
    for base in BOTH:
        p = pkg(base)
        g, _, src, sink = _plan(p)
        strat = p.ac.GreedyCache() if strategy == "greedy" else p.ac.AggressiveCache()

        class CacheOnlyOptimizer(p.opt.Optimizer):
            batches = [p.opt.Batch("Auto Cache", p.opt.Once(), [p.ac.AutoCacheRule(strat)])]

        env = p.wf.PipelineEnv.get_or_create()
        env.reset()
        env.set_optimizer(CacheOnlyOptimizer())
        pipe = p.wf.Pipeline(p.executor.GraphExecutor(g), src, sink)
        assert pipe.apply(5).get() == 168, base
        env.reset()


def test_source_descendants_cannot_absorb_ancestor_savings():
    for base in BOTH:
        p = pkg(base)
        Plus, SumEst = _plus_classes(p)
        g = p.graph.Graph()
        g, d = g.add_node(p.ops.DatasetOperator(p.Dataset.of([1, 2, 3, 4])), [])
        g, a = g.add_node(Plus(1), [d])
        g, b = g.add_node(Plus(2), [a])
        g, src = g.add_source()
        g, est = g.add_node(SumEst(), [b])
        g, mix = g.add_node(p.ops.DelegatingOperator(), [est, src])
        g, fan1 = g.add_node(Plus(3), [mix])
        g, fan2 = g.add_node(Plus(4), [mix])
        g, _ = g.add_sink(fan1)
        g, _ = g.add_sink(fan2)
        profiles = {a: p.ac.Profile(1000, 10), b: p.ac.Profile(1000, 10)}
        assert p.ac.greedy_cache_set(g, profiles, 10_000) == {b}, base


@pytest.mark.parametrize("samples,scale", [
    ([(2, 3 * 2 + 5, 20), (4, 3 * 4 + 5, 40)], 100),     # slope and intercept
    ([(2, 100.0, 100), (4, 50.0, 50)], 1000),              # negative slope clipped
    ([(1, 7.0, 3), (3, 7.0, 9), (9, 8.0, 27)], 50),        # least squares over 3
])
def test_generalize_profiles(samples, scale):
    out = {}
    for base in BOTH:
        ac = pkg(base).ac
        sp = [ac.SampleProfile(s, ac.Profile(ns=ns, mem_bytes=m)) for s, ns, m in samples]
        prof = ac.generalize_profiles(scale, sp)
        out[base] = (prof.ns, prof.mem_bytes)
        assert prof.ns >= 0 and prof.mem_bytes >= 0
    assert out[PORT] == out[REF]


@pytest.mark.parametrize("base", BOTH)
def test_compute_runs_and_estimate(base):
    p = pkg(base)
    g, ids, _, _ = _plan(p)
    cached = p.ac.init_cache_set(g)
    runs = p.ac.compute_runs(g, cached)
    # +5 feeds the weight-4 estimator; +2 feeds +3 and +4, each run 4 times.
    assert runs[ids["n5"]] == 4 and runs[ids["n2"]] == 8 and runs[ids["n1"]] == 8
    est = p.ac.estimate_cached_runtime(g, cached | {ids["n2"]}, _profiles(p, ids))
    assert est == 10 * 1 + 10 * 1 + 30 * 1 + 20 * 4 + 20 * 4 + 20 * 4


# ---------------------------------------------------------------------------
# Post-fusion placement (tests/test_autocache_postfusion.py)
# ---------------------------------------------------------------------------


def _nodes(p):
    class DeviceScale(p.wf.Transformer):
        def __init__(self, c, weight=1):
            self.c = float(c)
            self.weight = weight

        def device_fn(self):
            c = self.c
            return lambda X: X * c

        def apply(self, x):
            return x * self.c

    class HostDecode(p.wf.Transformer):
        """Host-side stage: NOT device-fusable; counts batch executions."""

        def __init__(self, weight=1):
            self.weight = weight
            self.batch_ns = []

        def apply(self, x):
            return np.sqrt(np.abs(p.to_numpy(x))).astype(np.float32)

        def batch_apply(self, data):
            self.batch_ns.append(data.n)
            X = p.to_numpy(data.array)
            return p.Dataset.of(p.array(np.sqrt(np.abs(X)).astype(np.float32)))

    class WeightedSumEstimator(p.wf.Estimator):
        weight = 4

        def fit(self, data):
            total = float(np.sum(p.to_numpy(data.array)))
            return DeviceScale(1.0 + 0.0 * total)

    class TraceableFit(p.wf.Estimator):
        weight = 4
        streamed_fit_fusable = True

        def fit(self, data):
            return DeviceScale(1.0)

    return DeviceScale, HostDecode, WeightedSumEstimator, TraceableFit


def _cachers(p, graph):
    return [n for n in graph.nodes if isinstance(graph.get_operator(n), p.util.Cacher)]


def _ds(p, a):
    return p.Dataset.of(p.array(a))


def _chain_graph(p):
    DeviceScale = _nodes(p)[0]
    g = p.graph.Graph()
    g, d = g.add_node(p.ops.DatasetOperator(_ds(p, np.arange(32.0, dtype=np.float32)
                                                .reshape(8, 4))), [])
    g, a = g.add_node(DeviceScale(2.0), [d])
    g, b = g.add_node(DeviceScale(3.0, weight=4), [a])
    g, _ = g.add_sink(b)
    return g, d, a, b


def _placement(p, case):
    """(graph, node under test, whether a Cacher may depend on it, expected
    split predicate) for one placement case."""
    DeviceScale, HostDecode, _, TraceableFit = _nodes(p)
    if case == "chain":
        g, d, a, b = _chain_graph(p)
        return g, a, True
    g = p.graph.Graph()
    X = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    g, d = g.add_node(p.ops.DatasetOperator(_ds(p, X)), [])
    if case == "fit_input":
        g, dl = g.add_node(p.ops.DatasetOperator(_ds(p, np.ones((8, 2), np.float32))), [])
        g, f = g.add_node(DeviceScale(2.0), [d])
        g, est = g.add_node(TraceableFit(), [f, dl])
        g, _ = g.add_sink(est)
        return g, f, True
    if case == "multi_consumer":
        g, a = g.add_node(DeviceScale(2.0), [d])
        g, b = g.add_node(DeviceScale(3.0, weight=3), [a])
        g, c = g.add_node(DeviceScale(4.0, weight=3), [a])
        g, _ = g.add_sink(b)
        g, _ = g.add_sink(c)
        return g, a, False
    g, h = g.add_node(HostDecode(), [d])
    g, b = g.add_node(DeviceScale(3.0, weight=4), [h])
    g, _ = g.add_sink(b)
    return g, h, False


@pytest.mark.parametrize("case", ["chain", "fit_input", "multi_consumer", "host_decode"])
def test_aggressive_placement(case):
    got = {}
    for base in BOTH:
        p = pkg(base)
        g, node, splits = _placement(p, case)
        assert p.fusion.cache_would_split_fusion(g, node, {}) == splits
        assert (node in p.fusion.fusion_splitting_nodes(g, {})) == splits
        new, _ = p.ac.AutoCacheRule(p.ac.AggressiveCache()).apply(g, {})
        deps = sorted(repr(new.get_dependencies(c)) for c in _cachers(p, new))
        assert (repr((node,)) in deps) == (not splits), (base, deps)
        got[base] = deps
    assert got[PORT] == got[REF]


def test_greedy_declines_and_skips_profiling_inside_chain(monkeypatch):
    for base in BOTH:
        p = pkg(base)
        calls = []
        monkeypatch.setattr(p.ac, "profile_nodes", lambda *a, **k: calls.append(a) or {})
        g, d, a, b = _chain_graph(p)
        new, _ = p.ac.AutoCacheRule(p.ac.GreedyCache(max_mem_bytes=1 << 30)).apply(g, {})
        for c in _cachers(p, new):
            assert new.get_dependencies(c) != (a,)
        for (graph_arg, nodes, *_rest) in calls:
            assert a not in nodes


def test_greedy_keeps_whole_chain_fused(env_reset):
    for base in BOTH:
        p = pkg(base)
        DeviceScale, _, WeightedSum, _ = _nodes(p)
        env = p.wf.PipelineEnv.get_or_create()
        env.reset()
        env.set_optimizer(p.opt.AutoCachingOptimizer(p.ac.GreedyCache(max_mem_bytes=1 << 30)))
        X = np.arange(64.0, dtype=np.float32).reshape(16, 4)
        pipe = (DeviceScale(2.0).to_pipeline().and_then(DeviceScale(0.5))
                .and_then(DeviceScale(3.0)).and_then(WeightedSum(), _ds(p, X)))
        res = pipe.apply(_ds(p, X[:4]))
        out = p.to_numpy(res.get().to_numpy())
        g = res.executor.optimized_graph
        fused = [g.get_operator(n) for n in g.nodes
                 if str(getattr(g.get_operator(n), "label", "")).startswith("Fused[")]
        assert any(len(p.fusion.fused_members(op)) == 3 for op in fused), base
        for c in _cachers(p, g):
            (dep,) = g.get_dependencies(c)
            assert not p.fusion.cache_would_split_fusion(g, dep, {})
        np.testing.assert_allclose(out, X[:4] * 3.0, rtol=1e-5)
        env.reset()


def test_host_boundary_cached_and_reused_across_fits(env_reset):
    for base in BOTH:
        p = pkg(base)
        DeviceScale, HostDecode, WeightedSum, _ = _nodes(p)
        env = p.wf.PipelineEnv.get_or_create()
        env.reset()
        env.set_optimizer(p.opt.AutoCachingOptimizer(p.ac.GreedyCache(max_mem_bytes=1 << 30)))
        host, f = HostDecode(), DeviceScale(2.0)
        X = np.abs(np.random.default_rng(0).normal(size=(64, 4))).astype(np.float32)
        data = _ds(p, X)
        for _ in range(3):  # a sweep refitting the same prefix
            pipe = host.to_pipeline().and_then(f).and_then(WeightedSum(), data)
            p.to_numpy(pipe.apply(_ds(p, X[:4])).get().to_numpy())
        assert [n for n in host.batch_ns if n == 64] == [64], (base, host.batch_ns)
        env.reset()


@pytest.mark.parametrize("before", [False, True])
def test_batch_order(before):
    names = {}
    for base in BOTH:
        p = pkg(base)
        opt = p.opt.AutoCachingOptimizer(p.ac.GreedyCache(), cache_before_fusion=before)
        names[base] = [b.name for b in opt.batches]
    assert names[PORT] == names[REF]
    if before:
        assert names[PORT].index("Auto Cache") < names[PORT].index("Stage Fusion")
    else:
        assert names[PORT].index("Auto Cache (post-fusion)") > names[PORT].index(
            "Tree & Fit Fusion")


def test_executor_records_full_scale_profiles():
    p = pkg(PORT)
    _, HostDecode, _, _ = _nodes(p)
    p.ac.clear_observed_profiles()
    g = p.graph.Graph()
    g, d = g.add_node(p.ops.DatasetOperator(_ds(p, np.ones((8, 4), np.float32))), [])
    g, h = g.add_node(HostDecode(), [d])
    g, sink = g.add_sink(h)
    p.executor.GraphExecutor(g, optimize=False).execute(sink).get()
    prof = p.ac.get_observed_profile(p.ac.observed_profile_key(g, h))
    assert prof is not None and prof.ns > 0 and prof.mem_bytes == 8 * 4 * 4


def test_greedy_prefers_observed_over_sampling(monkeypatch):
    p = pkg(PORT)
    DeviceScale, HostDecode, _, _ = _nodes(p)
    p.ac.clear_observed_profiles()
    g = p.graph.Graph()
    g, d = g.add_node(p.ops.DatasetOperator(_ds(p, np.ones((8, 4), np.float32))), [])
    g, h = g.add_node(HostDecode(), [d])
    g, b = g.add_node(DeviceScale(1.0, weight=4), [h])
    g, sink = g.add_sink(b)
    p.executor.GraphExecutor(g, optimize=False).execute(sink).get()
    sampled = []
    monkeypatch.setattr(p.ac, "profile_nodes",
                        lambda graph, nodes, *a, **k: sampled.append(set(nodes)) or {})
    p.ac.AutoCacheRule(p.ac.GreedyCache(max_mem_bytes=1 << 30)).apply(g, {})
    assert not sampled or all(h not in nodes and d not in nodes for nodes in sampled)


def test_env_reset_clears_observed_profiles():
    p = pkg(PORT)
    p.ac.record_observed_profile(("k",), 5.0, 10)
    assert p.ac.get_observed_profile(("k",)) is not None
    p.wf.PipelineEnv.get_or_create().reset()
    assert p.ac.get_observed_profile(("k",)) is None


def test_observed_profile_keeps_min_time_and_latest_size():
    ac = pkg(PORT).ac
    ac.clear_observed_profiles()
    ac.record_observed_profile(("x",), 9.0, 1)
    ac.record_observed_profile(("x",), 4.0, 2)
    ac.record_observed_profile(("x",), 7.0, 3)
    ac.record_observed_profile(("x",), 0.0, 4)  # ignored
    assert ac.get_observed_profile(("x",)) == ac.Profile(4.0, 3)
    ac.clear_observed_profiles()


def test_estimate_bytes_counts_tensor_bytes():
    p = pkg(PORT)
    assert p.ac._estimate_bytes(p.Dataset(torch.zeros(10, 3))) == 120
    assert p.ac._estimate_bytes(p.Dataset(torch.zeros(10, 3, dtype=torch.bfloat16))) == 60
    assert p.ac._estimate_bytes(p.Dataset((torch.zeros(2, 3), torch.zeros(2, 5)))) == 64
    assert p.ac._default_mem_budget() == (8 << 30 if not torch.cuda.is_available() else
                                          p.ac._default_mem_budget())


def test_profiling_fallback_is_recorded():
    p = pkg(PORT)
    DeviceScale = _nodes(p)[0]

    class Fails(p.wf.Transformer):
        def apply(self, x):
            raise RuntimeError("cannot run on a sample")

        def batch_apply(self, data):
            raise RuntimeError("cannot run on a sample")

    g = p.graph.Graph()
    g, d = g.add_node(p.ops.DatasetOperator(_ds(p, np.ones((8, 4), np.float32))), [])
    g, f = g.add_node(Fails(), [d])
    g, b = g.add_node(DeviceScale(1.0, weight=4), [f])
    g, _ = g.add_sink(b)
    p.ac.profile_fallbacks.clear()
    profs = p.ac.profile_nodes(g, {f})
    assert profs[f] == p.ac.Profile()
    assert p.ac.profile_fallbacks and "cannot run on a sample" in p.ac.profile_fallbacks[0][1]
    p.ac.profile_fallbacks.clear()


def test_profile_memo_profiles_once_across_a_sweep(monkeypatch, env_reset):
    p = pkg(PORT)
    _, HostDecode, _, _ = _nodes(p)
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats import CosineRandomFeatures

    calls = []
    real = p.ac.profile_nodes
    monkeypatch.setattr(p.ac, "profile_nodes",
                        lambda g, nodes, *a, **k: calls.append(len(nodes)) or real(g, nodes, *a, **k))
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    crf = CosineRandomFeatures(16, 64, 0.1, seed=0, device="cpu")
    host = HostDecode()
    env = p.wf.PipelineEnv.get_or_create()
    env.reset()
    env.set_optimizer(p.opt.AutoCachingOptimizer(p.ac.GreedyCache(max_mem_bytes=1 << 24)))
    data, labels = p.Dataset(X), p.Dataset(Y)
    for lam in (1e-3, 1e-2, 1e-1):
        fitted = host.to_pipeline().and_then(crf).and_then(
            BlockLeastSquaresEstimator(32, 1, lam), data, labels).fit()
        fitted.apply(p.Dataset(X[:8])).to_numpy()
    assert calls and sum(calls[1:]) == 0, calls


# ---------------------------------------------------------------------------
# The host-boundary λ-sweep (bench.py autocache_host_boundary) at n = 2,048
# ---------------------------------------------------------------------------

SWEEP_N, SWEEP_D_IN, SWEEP_D = 2048, 512, 4096
SWEEP_LAMS = np.logspace(-5, -2, 12)[:6]


def _sweep_inputs():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(SWEEP_N, SWEEP_D_IN)).astype(np.float32)
    y = rng.integers(0, 10, size=SWEEP_N)
    Y = (2.0 * np.eye(10, dtype=np.float32)[y] - 1.0)
    from keystone_tpu.ops.stats import CosineRandomFeatures

    ref = CosineRandomFeatures(SWEEP_D_IN, SWEEP_D, 1e-2, seed=2)
    return X, Y, np.asarray(ref.W, np.float32), np.asarray(ref.b, np.float32)


def _host_decode(p):
    class HostDecode(p.wf.Transformer):
        """Not device-fusable: device -> host, host decode math, -> device."""

        def __init__(self):
            self.full_calls = 0

        def apply(self, x):
            v = p.to_numpy(x)
            return p.array(np.sign(v) * np.sqrt(np.abs(v)).astype(np.float32))

        def batch_apply(self, ds):
            if ds.n == SWEEP_N:
                self.full_calls += 1
            V = p.to_numpy(ds.array)
            return p.Dataset(p.array(np.sign(V) * np.sqrt(np.abs(V)).astype(np.float32)), n=ds.n)

    return HostDecode()


def _weights(p, fitted):
    g = fitted.transformer_graph
    for n in g.nodes:
        op = g.get_operator(n)
        if isinstance(op, p.block.BlockLinearMapper):
            return np.concatenate([p.to_numpy(x) for x in op.xs], axis=0)
    raise AssertionError("no BlockLinearMapper in the fitted plan")


def _sweep(p, greedy: bool, inputs):
    X, Y, W, b = inputs
    if p.torch:
        from keystone_tpu_torch import interop

        crf = interop.cosine_features_model(W, b, device="cpu")
    else:
        from keystone_tpu.ops.stats import CosineRandomFeaturesModel

        crf = CosineRandomFeaturesModel(W, b)
    env = p.wf.PipelineEnv.get_or_create()
    env.reset()
    p.ac.clear_observed_profiles()
    optimizer = (p.opt.AutoCachingOptimizer(p.ac.GreedyCache(max_mem_bytes=3 << 30))
                 if greedy else p.opt.DefaultOptimizer())
    env.set_optimizer(optimizer)
    host = _host_decode(p)
    data, labels = p.Dataset.of(p.array(X)), p.Dataset.of(p.array(Y))
    weights = []
    for lam in SWEEP_LAMS:
        fitted = host.to_pipeline().and_then(crf).and_then(
            p.block.BlockLeastSquaresEstimator(512, 1, float(lam)), data, labels).fit()
        fitted.apply(p.Dataset.of(p.array(X[:256])))
        weights.append(_weights(p, fitted))
    # The plan probe: one fresh optimization; the rule's selection.
    host.to_pipeline().and_then(crf).and_then(
        p.block.BlockLeastSquaresEstimator(512, 1, 3e-3), data, labels
    ).executor.optimized_graph
    inserted = sum(len(getattr(r, "last_selection", ())) for bt in optimizer.batches
                   for r in bt.rules)
    env.reset()
    return weights, host.full_calls, inserted


@pytest.fixture(scope="module")
def sweeps():
    inputs = _sweep_inputs()
    out = {}
    for base in BOTH:
        for greedy in (False, True):
            out[(base, greedy)] = _sweep(pkg(base), greedy, inputs)
    for p in _PKGS.values():
        p.wf.PipelineEnv.get_or_create().reset()
    return out


@pytest.mark.parametrize("greedy", [False, True], ids=["default", "greedy"])
def test_host_boundary_sweep_counts_match(sweeps, greedy):
    _, ref_calls, ref_inserted = sweeps[(REF, greedy)]
    _, calls, inserted = sweeps[(PORT, greedy)]
    assert (calls, inserted) == (ref_calls, ref_inserted)
    if greedy:
        assert inserted >= 1 and calls == 1
    else:
        assert inserted == 0 and calls == len(SWEEP_LAMS)


@pytest.mark.parametrize("greedy", [False, True], ids=["default", "greedy"])
def test_host_boundary_sweep_weights_match_reference(sweeps, greedy):
    for ref_w, w in zip(sweeps[(REF, greedy)][0], sweeps[(PORT, greedy)][0]):
        rel = np.linalg.norm(w - ref_w) / np.linalg.norm(ref_w)
        assert rel <= 1e-5, rel


def test_host_boundary_greedy_weights_bit_equal_to_default(sweeps):
    for a, b in zip(sweeps[(PORT, False)][0], sweeps[(PORT, True)][0]):
        assert np.array_equal(a, b)
