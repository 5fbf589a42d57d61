"""The port's workflow layer against the JAX package's, on the CPU: what
tests/test_graph.py, test_analysis.py, test_pipeline.py (its datum-program
tests too) and test_optimizer_rules.py pin, each case run on both packages
(``pkg`` is parametrized) where the two share the behaviour; cases that
repeat each other are merged into parametrized tests.

The port's single-datum programs are held on the CPU: one program per input
(shape, dtype), composed once, the cap of 16 with first-in eviction, the
caches dropped on pickling and rebuilt after, the per-node walk for graphs
that do not compose, and 8 threads applying at once. (On the card a program
is a CUDA graph; tests/test_torch_workflow_cuda.py holds capture and replay
there.)

Values compare exactly (small integers and halves in float32/float64),
except the estimator end-to-end case: 1e-6 absolute, a 32-row ridge fit
with and without cache placement in one package.
"""

import importlib
import pickle
import threading

import numpy as np
import pytest
import torch

from keystone_tpu_torch.workflow import Estimator as _PortEstimator
from keystone_tpu_torch.workflow import Transformer as _PortTransformer

REF = "keystone_tpu"
PORT = "keystone_tpu_torch"


# Module-level port nodes for the pickling cases: the port saves with the
# standard pickle (the reference with cloudpickle, which also takes local
# classes), so what it saves must be importable.
class PortScale(_PortTransformer):
    """Device-pure x -> 2x; counts how often its device_fn is asked for
    (once a composition)."""

    def __init__(self):
        self.compositions = 0

    def apply(self, x):
        return x * 2.0

    def device_fn(self):
        self.compositions += 1
        return _double


def _double(X):
    return X * 2.0


class PortAddConst(_PortTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply(self, x):
        return x + self.c


class PortMeanEstimator(_PortEstimator):
    def fit(self, data):
        return PortAddConst(np.mean([float(v) for v in data.to_list()]))


class Pkg:
    def __init__(self, base):
        self.base = base
        self.torch = base == PORT

        def m(mod):
            return importlib.import_module(f"{base}.{mod}")

        self.Dataset = m("data").Dataset
        self.wf = m("workflow")
        self.graph = m("workflow.graph")
        self.analysis = m("workflow.analysis")
        self.ops = m("workflow.operators")
        self.pipeline = m("workflow.pipeline")
        self.opt = m("workflow.optimizer")
        self.optimizable = m("workflow.optimizable")
        self.ac = m("workflow.autocache")
        self.util = m("ops.util")
        self.linear = m("ops.learning.linear")


_PKGS = {}


@pytest.fixture(params=[REF, PORT])
def pkg(request):
    if request.param not in _PKGS:
        _PKGS[request.param] = Pkg(request.param)
    p = _PKGS[request.param]
    p.wf.PipelineEnv.get_or_create().reset()
    yield p
    p.wf.PipelineEnv.get_or_create().reset()


@pytest.fixture
def port():
    if PORT not in _PKGS:
        _PKGS[PORT] = Pkg(PORT)
    p = _PKGS[PORT]
    p.wf.PipelineEnv.get_or_create().reset()
    yield p
    p.wf.PipelineEnv.get_or_create().reset()


# ---------------------------------------------------------------------------
# Graph surgery (tests/test_graph.py)
# ---------------------------------------------------------------------------


def _chain(p):
    """source -> n1 -> n2 -> sink"""
    g = p.graph.Graph(sources=frozenset({p.graph.SourceId(1)}))
    g, n1 = g.add_node(p.ops.DatumOperator("a"), [p.graph.SourceId(1)])
    g, n2 = g.add_node(p.ops.DatumOperator("b"), [n1])
    g, sink = g.add_sink(n2)
    return g, n1, n2, sink


class TestGraph:
    def test_add_node_sink_source(self, pkg):
        g, n1, n2, sink = _chain(pkg)
        assert n1 != n2 and g.get_dependencies(n2) == (n1,)
        assert g.get_sink_dependency(sink) == n2
        g2, s = g.add_source()
        assert s in g2.sources and s not in g.sources
        g3, lone = g2.add_node(pkg.ops.DatumOperator("z"), [])
        assert g3.get_dependencies(lone) == ()
        g4 = g.remove_sink(sink)
        assert sink not in g4.sinks

    @pytest.mark.parametrize("surgery", [
        lambda p, g, n1, n2, s: g.add_node(p.ops.DatumOperator("x"), [p.graph.NodeId(99)]),
        lambda p, g, n1, n2, s: g.add_sink(p.graph.NodeId(99)),
        lambda p, g, n1, n2, s: g.remove_node(p.graph.NodeId(99)),
        lambda p, g, n1, n2, s: g.set_dependencies(n2, [p.graph.NodeId(99)]),
        lambda p, g, n1, n2, s: g.connect_graph(g, {p.graph.SourceId(42): p.graph.SinkId(1)}),
    ], ids=["dep", "sink", "remove", "set_deps", "connect"])
    def test_invalid_surgery_raises(self, pkg, surgery):
        g, n1, n2, sink = _chain(pkg)
        with pytest.raises(pkg.graph.GraphError):
            surgery(pkg, g, n1, n2, sink)

    def test_setters_and_replace_dependency(self, pkg):
        g, n1, n2, sink = _chain(pkg)
        g2 = g.set_operator(n2, pkg.ops.DatumOperator("c"))
        assert g2.get_operator(n2).datum == "c" and g.get_operator(n2).datum == "b"
        g3 = g.set_dependencies(n2, [pkg.graph.SourceId(1)])
        assert g3.get_dependencies(n2) == (pkg.graph.SourceId(1),)
        assert g.replace_dependency(n2, n1).get_sink_dependency(sink) == n1

    def test_add_and_connect_graph(self, pkg):
        g1, _, n2, sink1 = _chain(pkg)
        g2, *_ = _chain(pkg)
        combined, _, node_map, _ = g1.add_graph(g2)
        assert len(combined.nodes) == 4 and len(combined.sources) == 2
        assert set(node_map.values()).isdisjoint(g1.nodes)
        joined, src_map, node_map, _ = g1.connect_graph(g2, {pkg.graph.SourceId(1): sink1})
        assert sink1 not in joined.sinks and len(joined.sources) == 1
        assert joined.get_dependencies(node_map[pkg.graph.NodeId(1)]) == (n2,)
        assert pkg.graph.SourceId(1) not in src_map

    def test_replace_nodes(self, pkg):
        g, n1, n2, sink = _chain(pkg)
        rep = pkg.graph.Graph(sources=frozenset({pkg.graph.SourceId(1)}))
        rep, r1 = rep.add_node(pkg.ops.DatumOperator("r"), [pkg.graph.SourceId(1)])
        rep, rsink = rep.add_sink(r1)
        out = g.replace_nodes({n2}, rep, {pkg.graph.SourceId(1): n1}, {n2: rsink})
        new = next(n for n in out.nodes if n != n1)
        assert out.get_operator(new).datum == "r" and out.get_sink_dependency(sink) == new
        with pytest.raises(pkg.graph.GraphError):
            g.replace_nodes({n2}, rep, {}, {n2: rsink})

    def test_dot_export(self, pkg):
        g, *_ = _chain(pkg)
        dot = g.to_dot()
        assert dot.startswith("digraph") and "->" in dot


# ---------------------------------------------------------------------------
# Analysis (tests/test_analysis.py)
# ---------------------------------------------------------------------------


def _diamond(p):
    """source -> a -> {b, c} -> d -> sink, plus a second sink on b."""
    g = p.graph.Graph(sources=frozenset({p.graph.SourceId(0)}))
    g, a = g.add_node(p.ops.DatumOperator("a"), [p.graph.SourceId(0)])
    g, b = g.add_node(p.ops.DatumOperator("b"), [a])
    g, c = g.add_node(p.ops.DatumOperator("c"), [a])
    g, d = g.add_node(p.ops.DatumOperator("d"), [b, c])
    g, s1 = g.add_sink(d)
    g, s2 = g.add_sink(b)
    return g, a, b, c, d, s1, s2


class TestAnalysis:
    def test_parents_children(self, pkg):
        an = pkg.analysis
        g, a, b, c, d, s1, s2 = _diamond(pkg)
        src = pkg.graph.SourceId(0)
        assert an.get_children(g, src) == {a}
        assert an.get_children(g, b) == {d, s2}
        assert an.get_parents(g, s1) == {d}
        assert an.get_parents(g, d) == {b, c}
        assert an.get_parents(g, src) == set()

    def test_ancestors_descendants(self, pkg):
        an = pkg.analysis
        g, a, b, c, d, s1, s2 = _diamond(pkg)
        src = pkg.graph.SourceId(0)
        assert an.get_ancestors(g, s1) == {src, a, b, c, d}
        assert an.get_descendants(g, src) == {a, b, c, d, s1, s2}
        assert an.get_ancestors(g, c) == {src, a}
        assert an.get_descendants(g, s1) == set() and an.get_ancestors(g, src) == set()
        assert c not in an.get_descendants(g, b) and d in an.get_descendants(g, c)

    def test_linearize(self, pkg):
        an = pkg.analysis
        g, a, b, c, d, s1, s2 = _diamond(pkg)
        order = an.linearize(g)
        assert order == an.linearize(g)  # deterministic
        for node in (a, b, c, d):
            for dep in g.get_dependencies(node):
                assert order.index(dep) < order.index(node)
        assert set(order) >= {a, b, c, d, s1, s2}
        sub = an.linearize(g, b)
        assert sub[-1] == b and c not in sub and d not in sub
        assert an.linearize(pkg.graph.Graph()) == []

    def test_linearize_skips_islands_and_deep_chains(self, pkg):
        an = pkg.analysis
        g, *_ = _diamond(pkg)
        g, island = g.add_node(pkg.ops.DatumOperator("i"), [])
        assert island not in an.linearize(g)
        deep = pkg.graph.Graph(sources=frozenset({pkg.graph.SourceId(0)}))
        prev = pkg.graph.SourceId(0)
        for i in range(3000):
            deep, prev = deep.add_node(pkg.ops.DatumOperator(i), [prev])
        deep, _ = deep.add_sink(prev)
        assert len(an.linearize(deep)) == 3002

    def test_same_order_in_both_packages(self):
        orders = []
        for base in (REF, PORT):
            p = _PKGS.setdefault(base, Pkg(base))
            g, *_ = _diamond(p)
            orders.append([repr(x) for x in p.analysis.linearize(g)])
        assert orders[0] == orders[1]


# ---------------------------------------------------------------------------
# Pipeline semantics (tests/test_pipeline.py)
# ---------------------------------------------------------------------------


def _nodes(p):
    T = p.wf.Transformer

    class Double(T):
        def apply(self, x):
            return x * 2

    class AddOne(T):
        def apply(self, x):
            return x + 1

    class AddConst(T):
        def __init__(self, c):
            self.c = float(c)

        def apply(self, x):
            return x + self.c

    class CountingEstimator(p.wf.Estimator):
        def __init__(self):
            self.fit_count = 0

        def fit(self, data):
            self.fit_count += 1
            return AddConst(np.mean([float(v) for v in data.to_list()]))

    class CountingLabelEstimator(p.wf.LabelEstimator):
        def __init__(self):
            self.fit_count = 0

        def fit(self, data, labels):
            self.fit_count += 1
            return AddConst(np.mean([float(v) for v in data.to_list()])
                            + np.mean([float(v) for v in labels.to_list()]))

    return Double, AddOne, AddConst, CountingEstimator, CountingLabelEstimator


def _dataset(p, values):
    return p.Dataset.of(np.asarray(values, dtype=np.float64))


class TestPipeline:
    @pytest.mark.parametrize("build,x,want", [
        (lambda D, A: D().and_then(A()), 3.0, 7.0),
        (lambda D, A: D() | A() | D(), 1.0, 6.0),
        (lambda D, A: D().to_pipeline(), 2.5, 5.0),
    ], ids=["and_then", "or_sugar", "single"])
    def test_chain_datum(self, pkg, build, x, want):
        Double, AddOne = _nodes(pkg)[:2]
        assert float(build(Double, AddOne).apply(x).get()) == want

    def test_identity_and_lambda(self, pkg):
        Double = _nodes(pkg)[0]
        assert float(pkg.wf.Identity().and_then(Double()).apply(2.0).get()) == 4.0
        assert float(pkg.wf.transformer(lambda x: x * 3).to_pipeline().apply(2.0).get()) == 6.0

    def test_chain_dataset(self, pkg):
        Double, AddOne = _nodes(pkg)[:2]
        out = Double().and_then(AddOne()).apply(_dataset(pkg, [1.0, 2.0, 3.0])).get()
        np.testing.assert_allclose(np.asarray(out.to_numpy(), np.float64), [3.0, 5.0, 7.0])

    def test_result_memoized(self, pkg):
        calls = []

        class Tracking(pkg.wf.Transformer):
            def apply(self, x):
                calls.append(x)
                return x

        res = Tracking().to_pipeline().apply(1.0)
        res.get()
        res.get()
        assert len(calls) == 1

    def test_estimator_fits_once_and_applies(self, pkg):
        Double, _, _, Counting, _ = _nodes(pkg)
        est = Counting()
        pipe = Double().and_then(est, _dataset(pkg, [0.0, 2.0, 4.0]))
        assert float(pipe.apply(1.0).get()) == pytest.approx(6.0)
        pipe.apply(2.0).get()
        pipe.apply(_dataset(pkg, [1.0, 4.0])).get()
        assert est.fit_count == 1

    def test_label_estimator(self, pkg):
        Double, _, _, _, CountingLabel = _nodes(pkg)
        est = CountingLabel()
        pipe = Double().and_then(est, _dataset(pkg, [0.0, 2.0]), _dataset(pkg, [10.0, 20.0]))
        assert float(pipe.apply(0.0).get()) == pytest.approx(17.0)
        assert est.fit_count == 1

    @pytest.mark.parametrize("first", ["apply", "fit"])
    def test_state_reuse_across_pipelines(self, pkg, first):
        Double, _, _, Counting, _ = _nodes(pkg)
        data, est, dbl = _dataset(pkg, [1.0, 2.0, 3.0]), Counting(), Double()
        pipe1 = dbl.and_then(est, data)
        pipe1.apply(1.0).get() if first == "apply" else pipe1.fit()
        dbl.and_then(est, data).apply(5.0).get()
        assert est.fit_count == 1

    def test_gather(self, pkg):
        Double, AddOne = _nodes(pkg)[:2]
        pipe = pkg.wf.Pipeline.gather([Double().to_pipeline(), AddOne().to_pipeline()])
        assert [float(v) for v in pipe.apply(3.0).get()] == [6.0, 4.0]
        items = pipe.apply(_dataset(pkg, [1.0, 2.0])).get().to_list()
        assert [[float(v) for v in it] for it in items] == [[2.0, 2.0], [4.0, 3.0]]

    def test_fit_produces_transformer_only_pipeline(self, pkg):
        Double, _, _, Counting, _ = _nodes(pkg)
        est = Counting()
        fitted = Double().and_then(est, _dataset(pkg, [0.0, 4.0])).fit()
        assert isinstance(fitted.transformer_graph, pkg.pipeline.TransformerGraph)
        assert float(fitted.apply(1.0)) == pytest.approx(6.0)
        np.testing.assert_allclose(
            np.asarray(fitted.apply(_dataset(pkg, [0.0, 1.0])).to_numpy(), np.float64),
            [4.0, 6.0])
        fitted.apply(2.0)
        assert est.fit_count == 1

    def test_fitted_pipeline_save_load(self, port, tmp_path):
        fitted = PortScale().and_then(PortMeanEstimator(), _dataset(port, [0.0, 2.0])).fit()
        path = str(tmp_path / "pipe.pkl")
        fitted.save(path)
        assert float(type(fitted).load(path).apply(torch.tensor(1.0))) == pytest.approx(4.0)

    def test_cacher_publishes_prefix_state(self, pkg):
        Double = _nodes(pkg)[0]
        Double().and_then(pkg.util.Cacher()).apply(_dataset(pkg, [1.0, 2.0])).get()
        assert len(pkg.wf.PipelineEnv.get_or_create().state) >= 1

    def test_equal_transformers_merge(self, pkg):
        from dataclasses import dataclass

        calls = []

        @dataclass(frozen=True)
        class Stamp(pkg.wf.Transformer):
            tag: int

            def apply(self, x):
                calls.append(self.tag)
                return x + self.tag

        pipe = pkg.wf.Pipeline.gather([Stamp(5).to_pipeline(), Stamp(5).to_pipeline()])
        assert [float(v) for v in pipe.apply(1.0).get()] == [6.0, 6.0]
        assert len(calls) == 1

    def test_no_device_fn_maps_apply(self, pkg):
        AddOne = _nodes(pkg)[1]
        out = AddOne().batch_apply(pkg.Dataset.of([1.0, 2.0]))
        assert [float(v) for v in out.to_list()] == [2.0, 3.0]


# ---------------------------------------------------------------------------
# Optimizer rules (tests/test_optimizer_rules.py)
# ---------------------------------------------------------------------------


def _rule_nodes(p):
    T = p.wf.Transformer

    class PlusOne(T):
        def apply(self, x):
            return x + 1

    class TimesTen(T):
        def apply(self, x):
            return x * 10

    class Switching(p.optimizable.OptimizableTransformer):
        def __init__(self, threshold=5):
            self.threshold = threshold
            self.optimize_calls = []

        @property
        def default(self):
            return PlusOne()

        def optimize(self, sample):
            self.optimize_calls.append(sample.n)
            return TimesTen() if sample.n >= self.threshold else PlusOne()

    def heavy(weight):
        class Heavy(T):
            def apply(self, x):
                return x

        Heavy.weight = weight
        return Heavy()

    return PlusOne, TimesTen, Switching, heavy


class TestOptimizerRules:
    def test_node_optimization_swaps_on_sample(self, pkg):
        _, _, Switching, _ = _rule_nodes(pkg)
        node = Switching(threshold=2)
        out = node.to_pipeline().apply(pkg.Dataset.of(np.arange(16.0))).get().to_numpy()
        np.testing.assert_allclose(np.asarray(out, np.float64), np.arange(16.0) * 10)
        assert len(node.optimize_calls) == 1

    def test_node_optimization_skips_datum_fed_nodes(self, pkg):
        _, _, Switching, _ = _rule_nodes(pkg)
        node = Switching(threshold=1)
        assert float(node.to_pipeline().apply(3.0).get()) == 4.0
        assert node.optimize_calls == []

    def test_weighted_runs_and_aggressive(self, pkg):
        PlusOne, _, _, heavy = _rule_nodes(pkg)
        g = pkg.graph.Graph()
        g, d = g.add_node(pkg.ops.DatasetOperator(pkg.Dataset.of(np.arange(4.0))), [])
        g, a = g.add_node(PlusOne(), [d])
        g, b = g.add_node(heavy(3), [a])
        g, _ = g.add_sink(b)
        runs = pkg.ac.compute_runs(g, cached=set())
        assert (runs[b], runs[a]) == (1, 3)
        assert pkg.ac.compute_runs(g, cached={a})[a] == 1
        new, _ = pkg.ac.AutoCacheRule(pkg.ac.AggressiveCache()).apply(g, {})
        assert sum(isinstance(op, pkg.util.Cacher) for op in new.operators.values()) >= 1

    def test_greedy_zero_budget_caches_nothing(self, pkg):
        PlusOne, _, _, heavy = _rule_nodes(pkg)
        g = pkg.graph.Graph()
        g, d = g.add_node(pkg.ops.DatasetOperator(pkg.Dataset.of(np.arange(1024.0))), [])
        g, a = g.add_node(PlusOne(), [d])
        g, b = g.add_node(heavy(5), [a])
        g, _ = g.add_sink(b)
        new, _ = pkg.ac.AutoCacheRule(pkg.ac.GreedyCache(max_mem_bytes=0)).apply(g, {})
        assert not any(isinstance(op, pkg.util.Cacher) for op in new.operators.values())
        new2, _ = pkg.ac.AutoCacheRule(pkg.ac.GreedyCache(max_mem_bytes=1 << 30)).apply(g, {})
        assert new2.sinks == g.sinks

    @pytest.mark.parametrize("budget,want", [(0, ""), (150, "a"), (250, "ab"), (1 << 30, "ab")])
    def test_greedy_budget_sweep(self, pkg, budget, want):
        PlusOne, TimesTen, _, heavy = _rule_nodes(pkg)
        g = pkg.graph.Graph()
        g, d = g.add_node(pkg.ops.DatasetOperator(pkg.Dataset.of(np.arange(4.0))), [])
        g, a = g.add_node(PlusOne(), [d])
        g, b = g.add_node(TimesTen(), [a])
        g, h = g.add_node(heavy(5), [b])
        g, h2 = g.add_node(heavy(3), [a])
        g, _ = g.add_sink(h)
        g, _ = g.add_sink(h2)
        P = pkg.ac.Profile
        stub = {d: P(ns=1.0, mem_bytes=1000), a: P(ns=1000.0, mem_bytes=100),
                b: P(ns=10.0, mem_bytes=100)}
        names = {a: "a", b: "b", d: "d"}
        got = "".join(sorted(names[n] for n in pkg.ac.greedy_cache_set(g, stub, budget)))
        assert got == want

    @pytest.mark.parametrize("strategy", ["aggressive", "greedy"])
    def test_auto_caching_end_to_end(self, pkg, strategy):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(32, 4)).astype(np.float32)
        Y = rng.normal(size=(32, 2)).astype(np.float32)
        arr = torch.from_numpy if pkg.torch else (lambda a: a)

        def build():
            return pkg.wf.transformer(lambda x: x * 2.0).and_then(
                pkg.linear.LinearMapEstimator(lam=1e-3),
                pkg.Dataset.of(arr(X)), pkg.Dataset.of(arr(Y)))

        env = pkg.wf.PipelineEnv.get_or_create()
        base = np.asarray(build().apply(pkg.Dataset.of(arr(X))).get().to_numpy())
        env.reset()
        strat = (pkg.ac.AggressiveCache() if strategy == "aggressive"
                 else pkg.ac.GreedyCache(max_mem_bytes=1 << 20))
        env.set_optimizer(pkg.opt.AutoCachingOptimizer(strat))
        cached = np.asarray(build().apply(pkg.Dataset.of(arr(X))).get().to_numpy())
        np.testing.assert_allclose(cached, base, atol=1e-6)


# ---------------------------------------------------------------------------
# Single-datum programs (tests/test_pipeline.py TestDatumApplyCompileCache)
# ---------------------------------------------------------------------------


def _scale(p):
    class CountingScale(p.wf.Transformer):
        """Device-pure x -> 2x; counts how often its device_fn is asked for
        (once a composition)."""

        def __init__(self):
            self.compositions = 0

        def apply(self, x):
            return x * 2.0

        def device_fn(self):
            self.compositions += 1
            return lambda X: X * 2.0

    return CountingScale()


def _fitted(p, t):
    pipe = t.to_pipeline()
    return p.pipeline.FittedPipeline(
        p.pipeline.TransformerGraph.from_graph(pipe.executor.graph), pipe.source, pipe.sink)


class TestDatumPrograms:
    def test_same_shape_one_program(self, port):
        t = _scale(port)
        fitted = _fitted(port, t)
        x = np.arange(6, dtype=np.float32)
        outs = [fitted.apply(x + i) for i in range(4)]
        assert t.compositions == 1 and len(fitted._datum_programs) == 1
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(np.asarray(o), (x + i) * 2.0)
        (program,) = fitted._datum_programs.values()
        assert program.mode == "direct" and program.captures == 0

    def test_one_program_per_shape_and_dtype(self, port):
        fitted = _fitted(port, _scale(port))
        fitted.apply(np.zeros(3, np.float32))
        fitted.apply(np.zeros(5, np.float32))
        fitted.apply(np.zeros(3, np.float32))  # hit
        fitted.apply(torch.zeros(3, dtype=torch.float64))
        assert sorted(fitted._datum_programs) == [((3,), "float32"), ((3,), "torch.float64"),
                                                  ((5,), "float32")]

    def test_cap_evicts_first_in(self, port):
        fitted = _fitted(port, _scale(port))
        cap = fitted._DATUM_PROGRAM_CACHE_MAX
        assert cap == 16
        for d in range(1, cap + 3):
            fitted.apply(np.zeros(d, np.float32))
        keys = list(fitted._datum_programs)
        assert len(keys) == cap
        assert keys[0] == ((3,), "float32") and keys[-1] == ((cap + 2,), "float32")

    def test_walk_for_graphs_that_do_not_compose(self, port):
        class HostOnly(port.wf.Transformer):
            def apply(self, x):
                return np.asarray(x) + 1.0

        fitted = _fitted(port, HostOnly())
        np.testing.assert_array_equal(np.asarray(fitted.apply(np.zeros(4, np.float32))),
                                      np.ones(4))
        assert fitted._batched_fn is False and not fitted._datum_programs

    def test_multi_input_graph_walks(self, port):
        # A gather is multi-input: compose_apply_fn refuses, the walk runs.
        Double, AddOne = _nodes(port)[:2]
        pipe = port.wf.Pipeline.gather([Double().to_pipeline(), AddOne().to_pipeline()])
        fitted = pipe.fit()
        assert port.pipeline.compose_apply_fn(
            fitted.transformer_graph, fitted.source, fitted.sink) is None
        assert [float(v) for v in fitted.apply(torch.tensor(3.0))] == [6.0, 4.0]

    def test_pickling_drops_and_rebuilds(self, port, tmp_path):
        fitted = _fitted(port, PortScale())
        fitted.apply(np.zeros(4, np.float32))
        state = fitted.__getstate__()
        assert not {"_datum_programs", "_batched_fn", "_datum_lock"} & set(state)
        path = str(tmp_path / "fitted.pkl")
        fitted.save(path)
        loaded = port.pipeline.FittedPipeline.load(path)
        assert loaded._datum_programs == {} and loaded._batched_fn is None
        np.testing.assert_array_equal(np.asarray(loaded.apply(np.ones(4, np.float32))),
                                      np.ones(4) * 2.0)
        assert len(loaded._datum_programs) == 1
        clone = pickle.loads(pickle.dumps(loaded))
        np.testing.assert_array_equal(np.asarray(clone.apply(np.ones(4, np.float32))),
                                      np.ones(4) * 2.0)

    def test_eight_threads(self, port):
        t = _scale(port)
        fitted = _fitted(port, t)
        errors, results = [], {}
        barrier = threading.Barrier(8)

        def worker(i):
            try:
                barrier.wait()
                for j in range(50):
                    x = np.full(3 + (i + j) % 5, float(i * 100 + j), np.float32)
                    results[(i, j)] = (x, np.asarray(fitted.apply(x)))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors, errors
        assert len(results) == 400
        for x, y in results.values():
            np.testing.assert_array_equal(y, x * 2.0)
        assert t.compositions == 1 and len(fitted._datum_programs) == 5

    def test_matches_reference_datum_apply(self):
        # The same composed chain in both packages gives the same datum.
        outs = []
        for base in (REF, PORT):
            p = _PKGS.setdefault(base, Pkg(base))
            fitted = _fitted(p, _scale(p))
            outs.append(np.asarray(fitted.apply(np.arange(5, dtype=np.float32))))
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_fitted_timit_datum_equals_batch_rows(self, port):
        # A fused TIMIT-shaped pipeline (gather of cosine branches -> block
        # model -> argmax) composes; its datum program gives the batch
        # apply's rows.
        from keystone_tpu_torch.data.loaders import synthetic_timit
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
        from keystone_tpu_torch.pipelines.timit import TimitConfig, build_featurizer

        config = TimitConfig(num_cosines=2, block_size=64, num_epochs=1)
        train = synthetic_timit(256, seed=0, device="cpu")
        labels = ClassLabelIndicatorsFromIntLabels(147)(train.labels)
        fitted = build_featurizer(config, device="cpu").and_then(
            BlockLeastSquaresEstimator(64, 1, 1e-3), train.data, labels).fit()
        assert fitted._datum_program(train.data.array[0]) is not None
        batch = fitted.apply(port.Dataset(train.data.array[:16])).to_numpy()
        for i in range(16):
            np.testing.assert_allclose(np.asarray(fitted.apply(train.data.array[i])),
                                       batch[i], rtol=1e-6, atol=1e-6)
