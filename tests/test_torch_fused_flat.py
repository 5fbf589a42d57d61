"""The port's fused flat fit against the JAX package, on the CPU: the flat
block solver, the fusion rules and the fit-fusion contract of the block and
linear estimators.

Inputs come from seeded numpy generators (``synthetic_timit`` is
numpy-seeded and bit-identical in both packages); cosine weights drawn by
``jax.random`` are carried into the port through
``keystone_tpu_torch.interop``. tests/conftest.py turns on x64, so where
the JAX side is handed float64 data it computes in float64, a stricter
reference than the port's float32.

Tolerances and why:
  - flat solver, strided branch (float32 on both sides, the reference's
    Pallas kernels in interpret mode): weights within 1e-4 relative
    Frobenius error. Both run the same Gauss-Seidel sweep on well-
    conditioned 256-wide Gaussian blocks; float32 sums in other orders
    move the weights by ~1e-6.
  - flat solver, float64 branch: 1e-9 relative (float64 on both sides;
    the Cholesky implementations differ in rounding only).
  - masked_center: 1e-12 absolute (float64, sums of 7 values).
  - quick start end to end (port float32 against reference float64):
    weights, feature means and intercept within 1e-4 relative (as the
    TIMIT slice test: f32 rounding of well-conditioned 128-wide blocks),
    predicted labels >= 99.5% identical (a label flips only where two class
    scores tie within that error).
  - LinearMapEstimator: 1e-4 relative (one float32 normal-equations solve
    of a 64-wide, λ = 0.1 system against float64).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data.loaders import synthetic_timit as t_synthetic_timit
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning.block import (
    BlockLeastSquaresEstimator as TBlockLS,
    BlockLinearMapper as TBlockLinearMapper,
)
from keystone_tpu_torch.ops.learning.linear import (
    LinearMapEstimator as TLinearMapEstimator,
    LinearMapper as TLinearMapper,
)
from keystone_tpu_torch.ops.stats import CosineRandomFeatures as TCosineRandomFeatures
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
from keystone_tpu_torch.ops.util import MaxClassifier as TMaxClassifier
from keystone_tpu_torch.ops.util import VectorCombiner as TVectorCombiner
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.pipelines import timit as t_timit
from keystone_tpu_torch.workflow import DefaultOptimizer as TDefaultOptimizer
from keystone_tpu_torch.workflow import FittedPipeline as TFittedPipeline
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow import Transformer as TTransformer
from keystone_tpu_torch.workflow import fusion as tfusion

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data.loaders import synthetic_timit as j_synthetic_timit
from keystone_tpu.ops.learning.block import (
    BlockLeastSquaresEstimator as JBlockLS,
    BlockLinearMapper as JBlockLinearMapper,
)
from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinearMapEstimator
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
from keystone_tpu.ops.util import MaxClassifier as JMaxClassifier
from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu.pipelines import timit as j_timit
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow import fusion as jfusion
from keystone_tpu.workflow.optimizer import DefaultOptimizer as JDefaultOptimizer


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture
def window_calls(monkeypatch):
    """Counts of the column-window kernel wrappers' calls (on the CPU they
    launch nothing, so the launch counters stay at 0)."""
    calls = {}
    for name in ("block_gram_sym", "block_corr", "block_residual_update",
                 "gram_corr_sym", "cosine_features"):
        orig = getattr(cuda_ops, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(cuda_ops, name, counted)
    return calls


def _jax_cosine(d_in, d_out, gamma, seed):
    """A reference cosine model and its port twin with the same W, b."""
    j = JCosineRandomFeatures(d_in, d_out, gamma, seed=seed)
    t = interop.params_from_jax({"W": np.asarray(j.W), "b": np.asarray(j.b)}, device="cpu")
    return j, t


def _mapper(fitted, cls):
    (m,) = [o for o in fitted.transformer_graph.operators.values() if isinstance(o, cls)]
    return m


# ---------------------------------------------------------------------------
# The flat solver
# ---------------------------------------------------------------------------


class TestFlatSolver:
    @pytest.mark.parametrize("num_iter", [1, 3])
    def test_strided_branch_against_pallas_interpret(self, window_calls, num_iter):
        rng = np.random.default_rng(0)
        F = rng.normal(size=(1024, 768)).astype(np.float32)
        B = rng.normal(size=(1024, 10)).astype(np.float32)
        want = np.asarray(jlinalg.bcd_least_squares_fused_flat(
            F, B, 256, lam=0.01, num_iter=num_iter, use_pallas=True
        ))
        got = tlinalg.bcd_least_squares_fused_flat(_t(F), _t(B), 256, lam=0.01,
                                                   num_iter=num_iter)
        assert got.shape == want.shape == (3, 256, 10) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-4
        # The window kernels' route: Gramians once (stashed past epoch 1
        # when there is more than one), a correlation and an update per
        # block per epoch, no slice-and-gram_corr_sym fallback.
        assert window_calls.get("block_gram_sym") == 3
        assert window_calls.get("block_corr") == 3 * num_iter
        assert window_calls.get("block_residual_update") == 3 * num_iter
        assert "gram_corr_sym" not in window_calls

    def test_float64_takes_the_sliced_branch(self, window_calls):
        rng = np.random.default_rng(1)
        F = rng.normal(size=(600, 192))
        B = rng.normal(size=(600, 4))
        want, want_R = jlinalg.bcd_least_squares_fused_flat(
            F, B, 64, lam=0.5, num_iter=3, return_residual=True
        )
        got, got_R = tlinalg.bcd_least_squares_fused_flat(
            _t(F, torch.float64), _t(B, torch.float64), 64, lam=0.5, num_iter=3,
            return_residual=True,
        )
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-9
        assert _rel(got_R.numpy(), np.asarray(want_R)) <= 1e-9
        assert not window_calls  # f64 accumulates in f64: no kernel fits

    def test_flat_equals_stacked_on_the_same_blocks(self):
        rng = np.random.default_rng(2)
        F = _t(rng.normal(size=(400, 192)))
        B = _t(rng.normal(size=(400, 5)))
        flat = tlinalg.bcd_least_squares_fused_flat(F, B, 64, lam=0.1, num_iter=2)
        stacked = tlinalg.bcd_least_squares_fused(
            torch.stack([F[:, i * 64:(i + 1) * 64] for i in range(3)]), B, lam=0.1, num_iter=2
        )
        assert _rel(flat.numpy(), stacked.numpy()) <= 1e-5

    def test_block_must_divide_the_width(self):
        with pytest.raises(ValueError, match="not divisible"):
            tlinalg.bcd_least_squares_fused_flat(torch.zeros((8, 10)), torch.zeros((8, 2)), 4)


class TestMaskedCenter:
    def test_padding_rows_against_reference(self):
        rng = np.random.default_rng(3)
        F = rng.normal(size=(10, 4))
        Y = rng.normal(size=(10, 3))
        F[7:] = 5.0  # padding rows hold featurize(0), not zero
        Y[7:] = -2.0
        want = jfusion.masked_center(jnp.asarray(F), jnp.asarray(Y), 7)
        Ft, Yt = _t(F, torch.float64), _t(Y, torch.float64)
        got = tfusion.masked_center(Ft, Yt, 7)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
        assert torch.equal(got[0][7:], torch.zeros((3, 4), dtype=torch.float64))
        assert torch.equal(got[1][7:], torch.zeros((3, 3), dtype=torch.float64))
        # F is centred in place; Y is not touched.
        assert got[0].data_ptr() == Ft.data_ptr()
        assert torch.equal(Yt, _t(Y, torch.float64))


# ---------------------------------------------------------------------------
# Estimators through the fused fit
# ---------------------------------------------------------------------------


class TestQuickStartComposition:
    """README quick start: cosine features -> BlockLeastSquares -> MaxClassifier."""

    @pytest.fixture(scope="class")
    def fits(self):
        TPipelineEnv.get_or_create().reset()
        JPipelineEnv.get_or_create().reset()
        j_train, j_test = j_synthetic_timit(1024, seed=11), j_synthetic_timit(512, seed=12)
        t_train = t_synthetic_timit(1024, seed=11, device="cpu")
        t_test = t_synthetic_timit(512, seed=12, device="cpu")
        j_rf, t_rf = _jax_cosine(440, 512, 0.05, seed=5)
        j_pipe = j_rf.and_then(
            JBlockLS(block_size=128, num_iter=3, lam=1e-4), j_train.data,
            JLabels(147)(j_train.labels),
        ).and_then(JMaxClassifier())
        t_pipe = t_rf.and_then(
            TBlockLS(block_size=128, num_iter=3, lam=1e-4), t_train.data,
            TLabels(147)(t_train.labels),
        ).and_then(TMaxClassifier())
        # The plan before fitting (afterwards the fit loads from the state table).
        t_labels = [op.label for op in TDefaultOptimizer().execute(
            t_pipe.executor.graph, {})[0].operators.values()]
        j_fitted, t_fitted = j_pipe.fit(), t_pipe.fit()
        out = dict(
            j_mapper=_mapper(j_fitted, JBlockLinearMapper),
            t_mapper=_mapper(t_fitted, TBlockLinearMapper),
            j_pred=np.asarray(j_fitted.apply(j_test.data).to_numpy()),
            t_pred=t_fitted.apply(t_test.data).to_numpy(),
            t_feats=t_rf.batch_apply(t_test.data),
            j_feats=j_rf.batch_apply(j_test.data),
            t_labels=t_labels,
        )
        TPipelineEnv.get_or_create().reset()
        JPipelineEnv.get_or_create().reset()
        return out

    def test_fit_is_fused(self, fits):
        assert "FusedFit[CosineRandomFeaturesModel -> BlockLeastSquaresEstimator]" in (
            fits["t_labels"]
        )

    def test_block_weights_means_and_intercept(self, fits):
        j, t = fits["j_mapper"], fits["t_mapper"]
        assert len(t.xs) == len(j.xs) == 4 and t.block_size == 128
        t_W = np.concatenate([x.numpy() for x in t.xs])
        j_W = np.concatenate([np.asarray(x) for x in j.xs])
        assert t_W.shape == (512, 147)
        assert _rel(t_W, j_W) <= 1e-4
        t_mean = np.concatenate([s.mean.numpy() for s in t.feature_scalers])
        j_mean = np.concatenate([np.asarray(s.mean) for s in j.feature_scalers])
        assert _rel(t_mean, j_mean) <= 1e-4
        assert _rel(t.b_opt.numpy(), np.asarray(j.b_opt)) <= 1e-4

    def test_predicted_labels(self, fits):
        assert fits["t_pred"].shape == fits["j_pred"].shape == (512,)
        assert np.mean(fits["t_pred"] == fits["j_pred"]) >= 0.995

    def test_interop_carries_the_fused_fit_model(self, fits):
        # The reference's fitted model (mean-only scaler per block, label
        # means as intercept), carried into the port, scores the port's
        # features as the reference scores its own.
        j = fits["j_mapper"]
        t = interop.params_from_jax({
            "xs": [np.asarray(x) for x in j.xs], "block_size": j.block_size,
            "b_opt": np.asarray(j.b_opt),
            "feature_scalers": [{"mean": np.asarray(s.mean), "std": None}
                                for s in j.feature_scalers],
        }, device="cpu")
        got = t.batch_apply(fits["t_feats"]).to_numpy()
        want = np.asarray(j.batch_apply(fits["j_feats"]).array)
        assert _rel(got, want) <= 1e-4


class TestLinearMapEstimator:
    @pytest.fixture(scope="class")
    def problem(self):
        rng = np.random.default_rng(4)
        X = rng.normal(size=(300, 440)).astype(np.float32)
        Y = rng.normal(size=(300, 3)).astype(np.float32)
        j_rf, t_rf = _jax_cosine(440, 64, 0.05, seed=6)
        F = np.asarray(j_rf.batch_apply(JDataset.of(X)).array)
        j_model = JLinearMapEstimator(lam=0.1).fit(JDataset.of(F), JDataset.of(Y))
        return dict(X=X, Y=Y, F=F, t_rf=t_rf, want_x=np.asarray(j_model.x),
                    want_b=np.asarray(j_model.b_opt),
                    want_pred=np.asarray(j_model.batch_apply(JDataset.of(F)).array))

    def _check(self, model, p, pred):
        assert isinstance(model, TLinearMapper)
        assert _rel(model.x.numpy(), p["want_x"]) <= 1e-4
        assert _rel(model.b_opt.numpy(), p["want_b"]) <= 1e-4
        assert _rel(pred, p["want_pred"]) <= 1e-4

    def test_unfused(self, problem):
        F = TDataset.of(_t(problem["F"]))
        model = TLinearMapEstimator(lam=0.1).fit(F, TDataset.of(_t(problem["Y"])))
        self._check(model, problem, model.batch_apply(F).to_numpy())

    def test_fused(self, problem):
        X = _t(problem["X"])
        pipe = problem["t_rf"].and_then(TLinearMapEstimator(lam=0.1), TDataset.of(X),
                                        TDataset.of(_t(problem["Y"])))
        labels = [op.label for op in TDefaultOptimizer().execute(
            pipe.executor.graph, {})[0].operators.values()]
        assert "FusedFit[CosineRandomFeaturesModel -> LinearMapEstimator]" in labels
        fitted = pipe.fit()
        model = _mapper(fitted, TLinearMapper)
        self._check(model, problem, fitted.apply(TDataset.of(X)).to_numpy())

    def test_interop_carries_the_linear_mapper(self, problem):
        rng = np.random.default_rng(5)
        x, b, mean = rng.normal(size=(64, 3)), rng.normal(size=3), rng.normal(size=64)
        t = interop.params_from_jax(
            {"x": x, "b_opt": b, "feature_scaler": {"mean": mean, "std": None}}, device="cpu"
        )
        F = problem["F"]
        np.testing.assert_allclose(t.batch_apply(TDataset.of(_t(F))).to_numpy(),
                                   (F - mean) @ x + b, rtol=1e-5, atol=1e-5)


class TestFusedFitContract:
    def test_unsupported_width_falls_back_on_the_features_made(self, window_calls):
        # 96 features do not split into 64-wide blocks: the estimator's own
        # fit runs on the features the fused fit already made.
        train = t_synthetic_timit(256, seed=1, device="cpu")
        rf = TCosineRandomFeatures(440, 96, 0.05555, seed=1, device="cpu")
        est = TBlockLS(64, 2)
        fused = tfusion.FusedFitEstimator([rf], est)
        labels = TLabels(147)(train.labels)
        model = fused.fit(train.data, labels)
        assert window_calls.get("cosine_features") == 1
        assert "block_corr" not in window_calls
        want = est.fit(rf.batch_apply(train.data), labels)
        for g, w in zip(model.xs, want.xs):
            torch.testing.assert_close(g, w)

    def test_fit_never_overwrites_the_callers_data(self):
        # A member whose device_fn returns a view of its input: the fit may
        # centre its features in place, so it must copy them first.
        class FirstColumns(TTransformer):
            def apply(self, x):
                return x[:4]

            def device_fn(self):
                return lambda X: X[:, :4]

        rng = np.random.default_rng(6)
        X = _t(rng.normal(3.0, 1.0, size=(50, 8)))
        X_before = X.clone()
        Y = TDataset.of(_t(rng.normal(size=(50, 2))))
        model = tfusion.FusedFitEstimator([FirstColumns()], TLinearMapEstimator(0.0)).fit(
            TDataset.of(X), Y
        )
        assert torch.equal(X, X_before)
        want = TLinearMapEstimator(0.0).fit(TDataset.of(X[:, :4].clone()), Y)
        torch.testing.assert_close(model.x, want.x, rtol=1e-4, atol=1e-5)

    def test_gather_writes_branches_into_one_matrix(self, window_calls):
        rfs = [TCosineRandomFeatures(440, 32, 0.05555, seed=s, device="cpu") for s in (1, 2)]
        fused = tfusion.FusedGatherTransformer([[rf] for rf in rfs], TVectorCombiner())
        X = t_synthetic_timit(40, seed=3, device="cpu").data.array
        got = fused.device_fn()(X)
        want = torch.cat([rf.batch_apply(TDataset.of(X)).array for rf in rfs], dim=1)
        assert torch.equal(got, want)
        # An identity branch cannot write into a window: plain concatenation.
        mixed = tfusion.FusedGatherTransformer([[rfs[0]], []], TVectorCombiner())
        assert torch.equal(mixed.device_fn()(X), torch.cat([want[:, :32], X], dim=1))

    def test_fitted_timit_pipeline_save_load(self, tmp_path):
        config = t_timit.TimitConfig(num_cosines=2, block_size=64, synthetic_n=256,
                                     num_epochs=2)
        result = t_timit.run(config, device="cpu")
        ops = result.fitted.transformer_graph.operators.values()
        assert any(isinstance(op, tfusion.FusedGatherTransformer) for op in ops)
        path = str(tmp_path / "fitted.pkl")
        result.fitted.save(path)
        data = t_synthetic_timit(64, seed=9, device="cpu").data
        np.testing.assert_array_equal(TFittedPipeline.load(path).apply(data).to_numpy(),
                                      result.fitted.apply(data).to_numpy())


# ---------------------------------------------------------------------------
# Plan parity: the port's optimizer makes the reference's rewrite
# ---------------------------------------------------------------------------


def _plan(optimizer, graph):
    plan, _ = optimizer.execute(graph, {})
    return {
        node.id: (
            plan.get_operator(node).label,
            tuple((type(d).__name__, d.id) for d in plan.get_dependencies(node)),
        )
        for node in plan.nodes
    }


def _compositions(package):
    """The three plans, built the same way with either package's API."""
    if package == "jax":
        synth, labels_of, timit, BlockLS, Max = (
            j_synthetic_timit, JLabels, j_timit, JBlockLS, JMaxClassifier)
        quick_rf = JCosineRandomFeatures(440, 128, 0.05, seed=1)
        featurizer = j_timit.build_featurizer(j_timit.TimitConfig(num_cosines=3, block_size=64))
        train = synth(128, seed=2)
    else:
        synth, labels_of, timit, BlockLS, Max = (
            t_synthetic_timit, TLabels, t_timit, TBlockLS, TMaxClassifier)
        quick_rf = TCosineRandomFeatures(440, 128, 0.05, seed=1, device="cpu")
        featurizer = t_timit.build_featurizer(
            t_timit.TimitConfig(num_cosines=3, block_size=64), device="cpu")
        train = synth(128, seed=2, device="cpu")
    labels = labels_of(147)(train.labels)
    quick = quick_rf.and_then(BlockLS(32, 3, 1e-4), train.data, labels).and_then(Max())
    tim = featurizer.and_then(BlockLS(64, 3, 0.0), train.data, labels).and_then(Max())
    return {
        "quick start under fit()": quick.executor.graph,
        "TIMIT under fit()": tim.executor.graph,
        "TIMIT under apply-first": tim.apply(train.data).executor.graph,
    }


class TestPlanParity:
    @pytest.fixture(scope="class")
    def plans(self):
        TPipelineEnv.get_or_create().reset()
        JPipelineEnv.get_or_create().reset()
        j = {k: _plan(JDefaultOptimizer(), g) for k, g in _compositions("jax").items()}
        t = {k: _plan(TDefaultOptimizer(), g) for k, g in _compositions("torch").items()}
        return j, t

    @pytest.mark.parametrize("which", ["quick start under fit()", "TIMIT under fit()",
                                       "TIMIT under apply-first"])
    def test_same_rewrite_node_for_node(self, plans, which):
        j, t = plans
        assert t[which] == j[which]

    def test_routes(self, plans):
        _, t = plans
        labels = {k: [label for label, _ in plan.values()] for k, plan in t.items()}
        gather = "FusedGather[" + " | ".join(["CosineRandomFeaturesModel"] * 3) + \
            " -> VectorCombiner]"
        assert "FusedFit[CosineRandomFeaturesModel -> BlockLeastSquaresEstimator]" in (
            labels["quick start under fit()"])
        assert f"FusedFit[{gather} -> BlockLeastSquaresEstimator]" in labels["TIMIT under fit()"]
        # Apply-first: the merged featurization has two consumers, so the
        # estimator stays unfused (the stacked route) behind a fused gather.
        assert "BlockLeastSquaresEstimator" in labels["TIMIT under apply-first"]
        assert gather in labels["TIMIT under apply-first"]

    def test_reoptimizing_returns_the_same_fused_wrappers(self):
        graph = _compositions("torch")["TIMIT under fit()"]
        opt = TDefaultOptimizer()
        first, _ = opt.execute(graph, {})
        second, _ = opt.execute(graph, {})
        fused = [n for n, op in first.operators.items() if tfusion.fused_members(op) != [op]]
        assert len(fused) == 2  # the apply's gather and the fused fit
        assert all(second.get_operator(n) is first.get_operator(n) for n in fused)
        assert second == first
