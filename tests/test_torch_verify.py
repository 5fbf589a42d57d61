"""The port's static plan verifier (keystone_tpu_torch/workflow/verify.py)
against the JAX package's, on the CPU.

Every seeded violation of tests/test_verify.py is built in both packages
and must give the same findings: the same codes and severities at the same
nodes, naming the same operators. Both packages' dry runs over the five
bundled pipelines must be clean in strict mode and propagate the same
signatures, node for node. The port's own contract follows: the pre-pass
rejects bad plans in ``Pipeline.fit``, ``Optimizer.execute`` and a lazy
apply; runtime errors carry node coordinates and keep their type; and the
meta-tensor interpretation allocates nothing, launches no kernel and never
writes a weight.

No tolerance is involved: findings, signatures and labels compare exactly.
The one stated difference: the reference's synthetic loaders give float64
arrays under tests/conftest.py's x64, the port's give float32 (the port
computes in float32), so the dry-run signatures are compared with float64
read as float32.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops, cuda_images
from keystone_tpu_torch.ops.stats import CosineRandomFeatures as TCosine
from keystone_tpu_torch.workflow import verify as tverify


class Pkg:
    """One package's names, so each case is written once for both."""

    def __init__(self, base: str):
        self.base = base
        self.torch = base == "keystone_tpu_torch"

        def m(mod):
            return importlib.import_module(f"{base}.{mod}")

        self.Dataset = m("data").Dataset
        self.stats = m("ops.stats")
        self.util = m("ops.util")
        self.nlp = m("ops.nlp")
        self.wf = m("workflow")
        self.verify = m("workflow.verify")
        self.operators = m("workflow.operators")
        self.linear = m("ops.learning.linear")
        self.optimizer = m("workflow.optimizer")
        self.dryrun = m("tools.dryrun")

    def cosine(self, d_in, d_out, gamma, seed=0):
        if self.torch:
            return self.stats.CosineRandomFeatures(d_in, d_out, gamma, seed=seed, device="cpu")
        return self.stats.CosineRandomFeatures(d_in, d_out, gamma, seed=seed)

    def signs(self, d):
        if self.torch:
            return self.stats.RandomSignNode.create(d, device="cpu")
        return self.stats.RandomSignNode.create(d)

    def to_bf16(self, X):
        if self.torch:
            return X.to(torch.bfloat16)
        import jax.numpy as jnp

        return X.astype(jnp.bfloat16)

    def array(self, a):
        """numpy for the reference, a CPU tensor for the port (the port's
        device functions take tensors, as its loaders give them)."""
        return torch.from_numpy(a) if self.torch else a

    def data(self, n=4, d=5, dtype=np.float32):
        return self.Dataset(self.array(np.zeros((n, d), dtype)))

    def labels(self, n=4, k=3):
        return self.Dataset(self.array(np.zeros((n, k), np.float32)))


REF = "keystone_tpu"
PORT = "keystone_tpu_torch"


@pytest.fixture(scope="module")
def pkgs():
    return {REF: Pkg(REF), PORT: Pkg(PORT)}


def _helpers(p: Pkg):
    T = p.wf.Transformer

    class _IdentityFit(T):
        def apply(self, x):
            return x

        def _batch_fn(self, X):
            return X

        def device_fn(self):
            return self._batch_fn

    class _MeanEstimator(p.wf.LabelEstimator):
        def fit(self, data, labels):
            return _IdentityFit()

    class _UnaryMeanEstimator(p.wf.Estimator):
        def fit(self, data):
            return _IdentityFit()

    class _CastsToBf16(T):
        """Seeded dtype-drift violation: silently narrows f32 -> bf16."""

        def apply(self, x):
            return p.to_bf16(x)

        def device_fn(self):
            return p.to_bf16

    return _IdentityFit, _MeanEstimator, _UnaryMeanEstimator, _CastsToBf16


# ---------------------------------------------------------------------------
# Seeded violations: each builder returns (graph, strict) for one package
# ---------------------------------------------------------------------------


def _shape_mismatch(p):
    rf = p.cosine(8, 16, 1.0)
    return rf.to_pipeline().apply(p.wf.PipelineDataset.of(p.data(d=5))).executor.graph, False


def _dtype_drift(p):
    cast = _helpers(p)[3]
    chain = p.signs(5).and_then(cast()).and_then(p.stats.LinearRectifier())
    return chain.apply(p.wf.PipelineDataset.of(p.data(d=5))).executor.graph, False


def _declared_dtype_change(p):
    cast = _helpers(p)[3]

    class Declared(cast):
        declares_dtype_change = True

    chain = p.signs(5).and_then(Declared())
    return chain.apply(p.wf.PipelineDataset.of(p.data(d=5))).executor.graph, False


def _estimator_as_data(p):
    unary = _helpers(p)[2]
    g = p.wf.Graph()
    g, data = g.add_node(p.operators.DatasetOperator(p.data()), [])
    g, est = g.add_node(unary(), [data])
    g, bad = g.add_node(p.util.MaxClassifier(), [est])
    g, _ = g.add_sink(bad)
    return g, False


def _cache_splits_chain(p):
    chain = p.signs(5).and_then(p.util.Cacher()).and_then(p.stats.LinearRectifier())
    return chain.apply(p.wf.PipelineDataset.of(p.data(d=5))).executor.graph, False


def _cache_after_multi_consumer(p):
    g = p.wf.Graph()
    g, data = g.add_node(p.operators.DatasetOperator(p.data(d=5)), [])
    g, d = g.add_node(p.signs(5), [data])
    g, cache = g.add_node(p.util.Cacher(), [d])
    g, b = g.add_node(p.stats.LinearRectifier(), [cache])
    g, other = g.add_node(p.util.MaxClassifier(), [d])
    g, _ = g.add_sink(b)
    g, _ = g.add_sink(other)
    return g, False


def _cache_on_boundary(p):
    chain = p.signs(5).and_then(p.stats.LinearRectifier()).and_then(p.util.Cacher())
    return chain.apply(p.wf.PipelineDataset.of(p.data(d=5))).executor.graph, False


def _undeclared_host_op_strict(p):
    chain = p.wf.LambdaTransformer(lambda s: s.split())
    host = p.Dataset(["a b", "c d"])
    return chain.to_pipeline().apply(p.wf.PipelineDataset.of(host)).executor.graph, True


def _undeclared_host_op_default(p):
    return _undeclared_host_op_strict(p)[0], False


def _host_kind_mismatch(p):
    chain = p.nlp.Trim().and_then(p.nlp.NGramsFeaturizer([1, 2]))
    return chain.apply(p.wf.PipelineDataset.of(p.Dataset(["doc one"]))).executor.graph, False


def _estimator_input_sizes(p):
    mean = _helpers(p)[1]
    return mean().with_data(p.data(n=4), p.labels(n=6)).executor.graph, False


def _text_fit_input(p):
    # A raw token stream straight into CommonSparseFeatures: the fit-input
    # contract (check_fit_signature) wants weighted items.
    sparse = importlib.import_module(f"{p.base}.ops.sparse")
    chain = p.nlp.Tokenizer().to_pipeline().and_then(
        sparse.CommonSparseFeatures(8), p.Dataset(["a b c", "b c d"])
    )
    return chain.executor.graph, False


def _text_pipeline_clean(p):
    # Tokenize -> n-grams -> term frequency -> sparse features: every host
    # node declares, so the strict pass propagates and finds nothing.
    sparse = importlib.import_module(f"{p.base}.ops.sparse")
    chain = (
        p.nlp.Trim().and_then(p.nlp.LowerCase()).and_then(p.nlp.Tokenizer())
        .and_then(p.nlp.NGramsFeaturizer([1, 2])).and_then(p.stats.TermFrequency())
    )
    chain = chain.and_then(sparse.CommonSparseFeatures(8), p.Dataset(["a B c", "b c d"]))
    return chain.executor.graph, True


def _label_indicators(p, shape=(4,)):
    chain = p.util.ClassLabelIndicatorsFromIntLabels(3).to_pipeline().and_then(
        p.util.TopKClassifier(2))
    ds = p.Dataset(np.zeros(shape, np.int32))
    return chain.apply(p.wf.PipelineDataset.of(ds)).executor.graph, True


def _label_matrix(p):
    # Indicators want one int label an example, not a row of them.
    return _label_indicators(p, (4, 2))


CASES = {
    "shape_mismatch": _shape_mismatch,
    "dtype_drift": _dtype_drift,
    "declared_dtype_change": _declared_dtype_change,
    "estimator_as_data": _estimator_as_data,
    "cache_splits_chain": _cache_splits_chain,
    "cache_after_multi_consumer": _cache_after_multi_consumer,
    "cache_on_boundary": _cache_on_boundary,
    "undeclared_host_op_strict": _undeclared_host_op_strict,
    "undeclared_host_op_default": _undeclared_host_op_default,
    "host_kind_mismatch": _host_kind_mismatch,
    "estimator_input_sizes": _estimator_input_sizes,
    "text_fit_input": _text_fit_input,
    "text_pipeline_clean": _text_pipeline_clean,
    "label_indicators": _label_indicators,
    "label_matrix": _label_matrix,
}

# What the reference's tests/test_verify.py pins for each case: (code,
# severity, operator label) of every finding.
EXPECTED = {
    "shape_mismatch": [("shape-mismatch", "error", "CosineRandomFeaturesModel")],
    "dtype_drift": [("dtype-drift", "warn", "_CastsToBf16")],
    "declared_dtype_change": [],
    "estimator_as_data": [("estimator-in-apply", "error", "MaxClassifier")],
    "cache_splits_chain": [("cache-splits-fusion", "warn", "Cacher")],
    "cache_after_multi_consumer": [],
    "cache_on_boundary": [],
    "undeclared_host_op_strict": [("undeclared-signature", "error", "Lambda[<lambda>]")],
    "undeclared_host_op_default": [],
    "host_kind_mismatch": [("host-signature-mismatch", "error", "NGramsFeaturizer")],
    "estimator_input_sizes": [("gather-mismatch", "error", "_MeanEstimator")],
    "text_fit_input": [("host-signature-mismatch", "error", "CommonSparseFeatures")],
    "text_pipeline_clean": [],
    "label_indicators": [],
    "label_matrix": [("host-signature-mismatch", "error", "ClassLabelIndicatorsFromIntLabels")],
}


def _findings(report):
    return sorted((f.code, f.severity, repr(f.node), f.operator) for f in report.findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeded_violation_same_findings_in_both_packages(pkgs, case):
    reports = {}
    for base, p in pkgs.items():
        graph, strict = CASES[case](p)
        reports[base] = p.verify.verify_graph(graph, strict=strict)
    assert _findings(reports[PORT]) == _findings(reports[REF])
    got = sorted((f.code, f.severity, f.operator) for f in reports[PORT].findings)
    assert got == sorted(EXPECTED[case])


def test_messages_name_the_parts(pkgs):
    p = pkgs[PORT]
    drift = p.verify.verify_graph(_dtype_drift(p)[0]).by_code(p.verify.DTYPE_DRIFT)
    assert "bfloat16" in drift[0].message and "float32" in drift[0].message
    cut = p.verify.verify_graph(_cache_splits_chain(p)[0]).by_code(p.verify.CACHE_SPLITS_FUSION)
    assert "RandomSignNode" in cut[0].message and "LinearRectifier" in cut[0].message
    kind = p.verify.verify_graph(_host_kind_mismatch(p)[0]).by_code(
        p.verify.HOST_SIGNATURE_MISMATCH)
    assert "tokens" in kind[0].message
    sizes = p.verify.verify_graph(_estimator_input_sizes(p)[0]).by_code(
        p.verify.GATHER_MISMATCH)
    assert "4" in sizes[0].message and "6" in sizes[0].message


# ---------------------------------------------------------------------------
# Dry runs: both packages clean in strict mode, the same signatures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dry_reports(pkgs):
    return {REF: pkgs[REF].dryrun.dryrun(strict=True),
            PORT: pkgs[PORT].dryrun.dryrun(strict=True, device="cpu")}


@pytest.mark.parametrize("name", ["timit", "amazon", "mnist_random_fft", "cifar_krr",
                                  "newsgroups"])
def test_dryrun_clean_strict_and_same_signatures(dry_reports, name):
    ref, port = dry_reports[REF][name], dry_reports[PORT][name]
    assert not ref.findings and not port.findings, "; ".join(map(str, port.findings))
    ref_sigs = {repr(k): v.describe().replace("float64", "float32") for k, v in ref.sigs.items()}
    port_sigs = {repr(k): v.describe() for k, v in port.sigs.items()}
    assert port_sigs == ref_sigs
    assert sum(s != "?" for s in port_sigs.values()) > 5, name


def test_dryrun_cli(capsys):
    from keystone_tpu_torch.tools import dryrun

    assert dryrun.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(": ok (") == 5


# ---------------------------------------------------------------------------
# The pre-pass in fit, optimize and apply; the KEYSTONE_VERIFY knob
# ---------------------------------------------------------------------------


def _bad_fit_pipeline(p):
    """16 cosine features over 8 inputs, composed on d=5 training data."""
    return p.cosine(8, 16, 1.0).and_then(
        p.linear.LinearMapEstimator(lam=1.0), p.data(d=5), p.labels())


class TestPrepass:
    def test_fit_rejects_invalid_plan(self, pkgs):
        p = pkgs[PORT]
        with pytest.raises(p.verify.PlanVerificationError) as exc:
            _bad_fit_pipeline(p).fit()
        assert "shape-mismatch" in str(exc.value)
        assert "CosineRandomFeaturesModel" in str(exc.value)

    def test_optimizer_rejects_invalid_plan(self, pkgs):
        p = pkgs[PORT]
        with pytest.raises(p.verify.PlanVerificationError):
            p.optimizer.DefaultOptimizer().execute(_bad_fit_pipeline(p).executor.graph, {})

    def test_auto_caching_optimizer_rejects_invalid_plan(self, pkgs):
        p = pkgs[PORT]
        with pytest.raises(p.verify.PlanVerificationError):
            p.optimizer.AutoCachingOptimizer().execute(
                _bad_fit_pipeline(p).executor.graph, {})

    def test_apply_rejects_invalid_plan(self, pkgs):
        p = pkgs[PORT]
        result = p.cosine(8, 16, 1.0).to_pipeline().apply(p.wf.PipelineDataset.of(p.data(d=5)))
        with pytest.raises(p.verify.PlanVerificationError):
            result.get()

    def test_env_knob_off_fails_at_runtime_instead(self, pkgs, monkeypatch):
        monkeypatch.setenv("KEYSTONE_VERIFY", "off")
        p = pkgs[PORT]
        assert p.verify.verification_mode() == "off"
        with pytest.raises(Exception) as exc:
            _bad_fit_pipeline(p).fit()
        assert not isinstance(exc.value, p.verify.PlanVerificationError)

    @pytest.mark.parametrize("raw,mode", [("strict", "strict"), ("on", "on"), ("", "on"),
                                          ("0", "off"), ("disabled", "off")])
    def test_env_knob_values(self, monkeypatch, raw, mode):
        monkeypatch.setenv("KEYSTONE_VERIFY", raw)
        assert tverify.verification_mode() == mode

    def test_apply_graph_example_shape(self, pkgs):
        p = pkgs[PORT]
        fitted = p.cosine(8, 16, 1.0).to_pipeline().fit()
        g = fitted.transformer_graph
        with pytest.raises(p.verify.PlanVerificationError):
            p.verify.verify_apply_graph(g, fitted.source, fitted.sink,
                                        example=np.zeros(5, np.float32))
        report = p.verify.verify_apply_graph(g, fitted.source, fitted.sink,
                                             example=torch.zeros(8))
        assert report is not None and not report.findings
        assert report.sigs[fitted.sink].describe() == "batch f[?,16]:float32"

    def test_apply_graph_estimator_leak(self, pkgs):
        p = pkgs[PORT]
        unary = _helpers(p)[2]
        g = p.wf.Graph()
        g, data = g.add_node(p.operators.DatasetOperator(p.data()), [])
        g, est = g.add_node(unary(), [data])
        g, sink = g.add_sink(est)
        g, src = g.add_source()
        with pytest.raises(p.verify.PlanVerificationError) as exc:
            p.verify.verify_apply_graph(g, src, sink)
        assert "estimator-in-apply" in str(exc.value)

    def test_clean_fit_runs(self, pkgs):
        # A valid plan passes the pre-pass and fits.
        p = pkgs[PORT]
        rng = np.random.default_rng(0)
        X = rng.normal(size=(32, 8)).astype(np.float32)
        Y = rng.normal(size=(32, 3)).astype(np.float32)
        fitted = p.cosine(8, 16, 1.0).and_then(
            p.linear.LinearMapEstimator(lam=1.0), p.Dataset(X), p.Dataset(Y)).fit()
        assert tuple(fitted.apply(p.Dataset(X)).to_numpy().shape) == (32, 3)


# ---------------------------------------------------------------------------
# Runtime error coordinates
# ---------------------------------------------------------------------------


def _boom(p):
    class _Boom(p.wf.Transformer):
        def apply(self, x):
            raise ValueError("boom inside node")

        def batch_apply(self, data):
            raise ValueError("boom inside node")

    return _Boom


class TestRuntimeErrorCoordinates:
    @pytest.mark.parametrize("base", [REF, PORT])
    def test_executor_failure_names_node_and_inputs(self, pkgs, base):
        p = pkgs[base]
        result = p.signs(5).and_then(_boom(p)()).apply(p.wf.PipelineDataset.of(p.data(d=5)))
        with pytest.raises(ValueError) as exc:
            result.get()
        msg = str(exc.value)
        for part in ("boom inside node", "keystone node", "_Boom", "Node(", "f[4,5]"):
            assert part in msg

    def test_annotation_applies_once_at_deepest_node(self, pkgs):
        p = pkgs[PORT]
        chain = p.signs(5).and_then(_boom(p)()).and_then(p.stats.LinearRectifier())
        with pytest.raises(ValueError) as exc:
            chain.apply(p.wf.PipelineDataset.of(p.data(d=5))).get()
        assert str(exc.value).count("keystone node") == 1

    def test_fitted_pipeline_walk_failure_names_node(self, pkgs):
        p = pkgs[PORT]
        fitted = _boom(p)().to_pipeline().fit()
        with pytest.raises(ValueError) as exc:
            fitted.apply(p.data(d=5))
        assert "keystone node" in str(exc.value) and "_Boom" in str(exc.value)

    def test_datum_program_failure_names_node(self, pkgs):
        # A composed program (device_fn chain) names its failing node too.
        p = pkgs[PORT]
        fitted = p.cosine(8, 16, 1.0).to_pipeline().fit()
        with pytest.raises(RuntimeError) as exc:
            fitted.apply(torch.zeros(5))
        assert "keystone node" in str(exc.value)
        assert "CosineRandomFeaturesModel" in str(exc.value)

    def test_exception_type_is_preserved(self, pkgs):
        p = pkgs[PORT]

        class Custom(Exception):
            pass

        class RaisesCustom(p.wf.Transformer):
            def batch_apply(self, data):
                raise Custom("custom")

            def apply(self, x):
                raise Custom("custom")

        result = RaisesCustom().to_pipeline().apply(p.wf.PipelineDataset.of(p.data(d=5)))
        with pytest.raises(Custom):
            result.get()


# ---------------------------------------------------------------------------
# Signatures, dtype names
# ---------------------------------------------------------------------------


class TestSignatures:
    def test_describe(self):
        assert tverify.ArraySig((None, 4), "float32").describe() == "batch f[?,4]:float32"
        assert tverify.HostSig("tokens").describe() == "host[tokens]"

    @pytest.mark.parametrize("value,expected", [
        (TDataset(np.zeros((3, 7), np.float32)), "batch f[3,7]:float32"),
        (TDataset(torch.zeros(3, 7, dtype=torch.bfloat16)), "batch f[3,7]:bfloat16"),
        (TDataset(torch.zeros(3, dtype=torch.int64)), "batch f[3]:int64"),
        (TDataset(["a", "b"]), "host[str]"),
        (TDataset({"indices": np.zeros((2, 3), np.int32),
                   "values": np.zeros((2, 3), np.float32)}, n=2), "host[sparse]"),
        (torch.zeros(4, dtype=torch.float64), "datum f[4]:float64"),
        ([["a", "b"]], "host[any]"),
        (["a", "b"], "host[tokens]"),
    ])
    def test_signature_of_value(self, value, expected):
        assert tverify.signature_of_value(value).describe() == expected

    def test_dtype_names_match_the_reference(self, pkgs):
        ref = pkgs[REF].verify
        for t, n in ((torch.float32, np.float32), (torch.float64, np.float64),
                     (torch.int32, np.int32), (torch.int64, np.int64), (torch.bool, np.bool_)):
            a = ref.signature_of_value(pkgs[REF].Dataset(np.zeros((2, 3), n)))
            b = tverify.signature_of_value(TDataset(torch.zeros(2, 3, dtype=t)))
            assert a.describe() == b.describe()

    @pytest.mark.parametrize("a,b,drift", [
        ("float32", "bfloat16", True), ("bfloat16", "float32", True),
        ("float32", "float32", False), ("float64", "float32", False),
        ("int32", "float32", False), ("float16", "float32", True),
    ])
    def test_dtype_drift(self, a, b, drift):
        assert tverify._dtype_drift(a, b) == drift


# ---------------------------------------------------------------------------
# Meta-tensor interpretation: nothing allocated, nothing launched
# ---------------------------------------------------------------------------


class TestMetaInterpretation:
    def test_north_star_width_interprets_without_allocating(self):
        # 50 branches of 4,096 cosine features over 2.2e6 rows: 1.8 TB of
        # features if anything were allocated. Bound as a source signature.
        from keystone_tpu_torch.ops.util import VectorCombiner
        from keystone_tpu_torch.workflow import Pipeline
        from keystone_tpu_torch.workflow.fusion import GatherFusionRule

        branches = [TCosine(440, 4096, 0.0555, seed=i, device="cpu").to_pipeline()
                    for i in range(50)]
        pipe = Pipeline.gather(branches).and_then(VectorCombiner())
        fused, _ = GatherFusionRule().apply(pipe.executor.graph, {})
        weights = [op.W.clone() for op in pipe.executor.graph.operators.values()
                   if hasattr(op, "W")]
        before = dict(cuda_ops.launches)
        report = tverify.verify_graph(
            fused, source_sigs={pipe.source: tverify.ArraySig((2_200_000, 440), "float32")},
            strict=True)
        assert not report.findings
        assert report.sigs[pipe.sink].describe() == "batch f[2200000,204800]:float32"
        assert dict(cuda_ops.launches) == before
        after = [op.W for op in pipe.executor.graph.operators.values() if hasattr(op, "W")]
        assert all(torch.equal(a, b) for a, b in zip(weights, after))

    def test_in_place_op_on_a_weight_lands_on_its_stand_in(self):
        W = torch.ones(3)

        def fn(X):
            W.add_(1.0)  # would corrupt the weight on a real run
            return X * W

        with tverify.MetaInterpretation():
            out = fn(torch.empty(2, 3, device="meta"))
        assert out.device.type == "meta" and torch.equal(W, torch.ones(3))

    def test_host_read_in_a_device_fn_is_a_finding(self):
        from keystone_tpu_torch.workflow import Transformer

        class ReadsHost(Transformer):
            def device_fn(self):
                return lambda X: X * float(X.sum().item())

        chain = ReadsHost().to_pipeline()
        report = tverify.verify_graph(
            chain.executor.graph,
            source_sigs={chain.source: tverify.ArraySig((None, 4), "float32")})
        assert [f.code for f in report.findings] == ["shape-mismatch"]


class TestWrapperMetaBranches:
    def test_cosine_features(self):
        W, b = torch.randn(16, 8), torch.rand(16)
        before = dict(cuda_ops.launches)
        out = cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, b)
        assert out.device.type == "meta" and tuple(out.shape) == (5, 16)
        assert out.dtype == torch.float32
        bf = cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, b,
                                      out_dtype=torch.bfloat16)
        assert bf.dtype == torch.bfloat16
        window = torch.empty(5, 40, device="meta")[:, 8:24]
        assert cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, b,
                                        out=window) is window
        with pytest.raises(ValueError):
            cuda_ops.cosine_features(torch.empty(5, 7, device="meta"), W, b)
        with pytest.raises(ValueError):
            cuda_ops.cosine_features(torch.empty(5, 8, device="meta"), W, b,
                                     out=torch.empty(5, 15, device="meta"))
        assert dict(cuda_ops.launches) == before

    def test_cosine_meta_shape_equals_the_plain_version(self):
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.normal(size=(6, 9)).astype(np.float32))
        W = torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32))
        b = torch.from_numpy(rng.uniform(size=5).astype(np.float32))
        real = cuda_ops.cosine_features(X, W, b)
        meta = cuda_ops.cosine_features(X.to("meta"), W, b)
        assert meta.shape == real.shape and meta.dtype == real.dtype

    def test_conv_featurize(self):
        filters = torch.randn(8, 3 * 3 * 3)
        before = dict(cuda_ops.launches)
        out = cuda_images.conv_featurize(torch.empty(2, 10, 10, 3, device="meta"), filters,
                                         torch.zeros(27), patch_size=3)
        real = cuda_images.conv_featurize(torch.rand(2, 10, 10, 3), filters, torch.zeros(27),
                                          patch_size=3)
        assert out.device.type == "meta" and out.shape == real.shape
        assert out.dtype == real.dtype
        with pytest.raises(ValueError):
            cuda_images.conv_featurize(torch.empty(2, 10, 10, 3, device="meta"), filters,
                                       torch.zeros(26), patch_size=3)
        with pytest.raises(ValueError):
            cuda_images.conv_featurize(torch.empty(2, 10, 10, 4, device="meta"), filters,
                                       patch_size=3)
        assert dict(cuda_ops.launches) == before


def test_verify_module_is_the_references_surface(pkgs):
    names = set(pkgs[REF].verify.__all__)
    assert names <= set(tverify.__all__)
    for name in names:
        assert hasattr(tverify, name), name
    assert os.environ.get("KEYSTONE_VERIFY", "on") != "off"
