"""The port's TIMIT ``--solver block`` slice against the JAX package, on the
CPU.

Both sides fit the same synthetic TIMIT data (numpy-seeded, bit-identical
in both packages) with the same cosine weights: the JAX draws are carried
into the port through ``keystone_tpu_torch.interop`` because ``jax.random``
and ``torch.Generator`` give different numbers from one seed. Under
tests/conftest.py's x64 the JAX side runs the fit in float64 through XLA
(its Pallas path is skipped for f64), a stricter reference than the
port's float32.

Tolerances and why:
  - block weights, relative Frobenius error <= 1e-4 for Gaussian features:
    two epochs of block coordinate descent on 2048 rows in float32 against
    float64; the 256-wide block Gramians are well conditioned, so f32
    rounding moves the weights by ~1e-6 (measured 7.7e-7).
  - <= 1e-3 for Cauchy features: the heavy-tailed weights give
    pre-activations in the hundreds, where float32's argument rounding of
    the cosine alone is ~1e-5 per feature, and the fit amplifies it
    (measured 1.5e-4).
  - predicted labels >= 99.5% identical: a label flips only where two class
    scores tie to within the weight error above.
  - train/test error within 0.5 points: follows from the label agreement.
Module-level pieces (scaler, featurizer, solvers, evaluator) are held to
their own tolerances below, each with its reason.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import one_hot_pm1 as t_one_hot_pm1
from keystone_tpu_torch.data.loaders import TimitFeaturesDataLoader as TTimitLoader
from keystone_tpu_torch.data.loaders import synthetic_timit as t_synthetic_timit
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator as TEvaluator
from keystone_tpu_torch.ops.learning.block import (
    BlockLeastSquaresEstimator as TBlockLS,
    BlockLinearMapper as TBlockLinearMapper,
)
from keystone_tpu_torch.ops.stats import CosineRandomFeatures as TCosineRandomFeatures
from keystone_tpu_torch.ops.stats import StandardScaler as TStandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.pipelines import timit as t_timit
from keystone_tpu_torch.workflow import FittedPipeline as TFittedPipeline
from keystone_tpu_torch.workflow import OptimizableLabelEstimator as TOptimizableLabelEstimator
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow import transformer as t_transformer

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import one_hot_pm1 as j_one_hot_pm1
from keystone_tpu.data.loaders import TimitFeaturesDataLoader as JTimitLoader
from keystone_tpu.data.loaders import synthetic_timit as j_synthetic_timit
from keystone_tpu.evaluation import MulticlassClassifierEvaluator as JEvaluator
from keystone_tpu.ops.learning.block import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.stats import CosineRandomFeatures as JCosineRandomFeatures
from keystone_tpu.ops.stats import StandardScaler as JStandardScaler
from keystone_tpu.parallel import linalg as jlinalg
from keystone_tpu.pipelines import timit as j_timit
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

SLICE = dict(num_cosines=2, block_size=256, synthetic_n=2048, num_epochs=2)
WEIGHT_TOL = {"gaussian": 1e-4, "cauchy": 1e-3}


@pytest.fixture(autouse=True)
def clean_port_env():
    TPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)


def _mapper(fitted, cls):
    (m,) = [o for o in fitted.transformer_graph.operators.values() if isinstance(o, cls)]
    return m


def _run_both(rf_type):
    """Fit the slice on both packages; returns numpy results of each."""
    config = dict(SLICE, rf_type=rf_type)
    JPipelineEnv.get_or_create().reset()
    j_cfg = j_timit.TimitConfig(solver="block", **config)
    pipe, j_train, j_test = j_timit.run(j_cfg)
    j_mapper = _mapper(pipe.fit(), JBlockLinearMapper)
    j_test_data = j_synthetic_timit(max(j_cfg.synthetic_n // 4, 256), seed=j_cfg.seed + 1)
    j_pred = np.asarray(pipe.apply(j_test_data.data).get().to_numpy())
    models = []
    for i in range(j_cfg.num_cosines):
        rf = JCosineRandomFeatures(
            440, j_cfg.block_size, j_cfg.gamma, seed=j_cfg.seed + i,
            cauchy=(rf_type == "cauchy"),
        )
        models.append(interop.params_from_jax(
            {"W": np.asarray(rf.W), "b": np.asarray(rf.b)}, device="cpu"
        ))
    JPipelineEnv.get_or_create().reset()

    TPipelineEnv.get_or_create().reset()
    result = t_timit.run(t_timit.TimitConfig(**config), device="cpu", cosine_models=models)
    t_mapper = _mapper(result.fitted, TBlockLinearMapper)
    t_test_data = t_synthetic_timit(max(j_cfg.synthetic_n // 4, 256), seed=j_cfg.seed + 1,
                                    device="cpu")
    t_pred = result.fitted.apply(t_test_data.data).to_numpy()
    TPipelineEnv.get_or_create().reset()
    return dict(
        j_W=np.concatenate([np.asarray(x) for x in j_mapper.xs]),
        t_W=np.concatenate([x.numpy() for x in t_mapper.xs]),
        j_pred=j_pred, t_pred=t_pred,
        j_err=(j_train.total_error, j_test.total_error),
        t_err=(result.train_eval.total_error, result.test_eval.total_error),
        fit_seconds=result.fit_seconds, apply_seconds=result.apply_seconds,
    )


@pytest.fixture(scope="module", params=["gaussian", "cauchy"])
def slice_runs(request):
    # The two packages reach the same model by different routes: the
    # port's run() fits first, so its fit takes the fused flat route
    # (FusedFitEstimator -> bcd_least_squares_fused_flat), while the
    # reference's run() applies before it fits, so its fit takes the
    # stacked route (fit_blocks -> bcd_least_squares_fused). Both centre
    # the features by their column means and run the same Gauss-Seidel
    # sweep, so the tolerances stay those of the module docstring.
    return request.param, _run_both(request.param)


class TestTimitSliceAgainstJax:
    def test_block_weights(self, slice_runs):
        rf_type, r = slice_runs
        assert r["t_W"].shape == r["j_W"].shape == (512, 147)
        rel = np.linalg.norm(r["t_W"] - r["j_W"]) / np.linalg.norm(r["j_W"])
        assert rel <= WEIGHT_TOL[rf_type], rel

    def test_predicted_labels(self, slice_runs):
        _, r = slice_runs
        assert r["t_pred"].shape == r["j_pred"].shape == (512,)
        assert np.mean(r["t_pred"] == r["j_pred"]) >= 0.995

    def test_train_and_test_error(self, slice_runs):
        _, r = slice_runs
        for t_err, j_err in zip(r["t_err"], r["j_err"]):
            assert abs(t_err - j_err) <= 0.005
        assert r["fit_seconds"] > 0 and r["apply_seconds"] > 0


class TestSliceModulesAgainstJax:
    def test_synthetic_timit_rows_are_bit_identical(self):
        j = j_synthetic_timit(300, seed=7)
        t = t_synthetic_timit(300, seed=7, device="cpu")
        np.testing.assert_array_equal(
            t.data.to_numpy(), np.asarray(j.data.array, dtype=np.float32)
        )
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))

    def test_timit_csv_loader(self, tmp_path):
        rng = np.random.default_rng(9)
        X = rng.normal(size=(6, 440))
        feats, labs = tmp_path / "feats.csv", tmp_path / "labels.txt"
        np.savetxt(feats, X, delimiter=",")
        labs.write_text("0 5\n3 146\n5 7\n")
        j = JTimitLoader(str(feats), str(labs)).labeled
        t = TTimitLoader(str(feats), str(labs), device="cpu").labeled
        np.testing.assert_array_equal(
            t.data.to_numpy(), np.asarray(j.data.array, dtype=np.float32)
        )
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))

    def test_one_hot_pm1_and_label_indicators(self):
        labels = np.array([0, 3, 146, 7])
        np.testing.assert_array_equal(t_one_hot_pm1(labels, 147), j_one_hot_pm1(labels, 147))
        got = TLabels(147)(TDataset.of(_t(labels, torch.int64))).to_numpy()
        np.testing.assert_array_equal(got, j_one_hot_pm1(labels, 147))

    def test_standard_scaler(self):
        # f32 column sums over 500 rows against f64: 1e-5 relative.
        X = np.random.default_rng(0).normal(2.0, 3.0, size=(500, 40))
        for normalize in (False, True):
            j = JStandardScaler(normalize_std_dev=normalize).fit(JDataset.of(X))
            t = TStandardScaler(normalize_std_dev=normalize).fit(TDataset.of(_t(X)))
            np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), rtol=1e-5, atol=1e-5)
            if normalize:
                np.testing.assert_allclose(t.std.numpy(), np.asarray(j.std), rtol=1e-5)

    def test_cosine_featurizer_with_reference_weights(self):
        # The port's batch path (the kernel's plain version here) against
        # the reference's XLA cos on the same W, b: 1e-5 absolute.
        rf = JCosineRandomFeatures(440, 96, 0.05555, seed=3)
        X = np.random.default_rng(1).normal(size=(70, 440))
        want = np.asarray(rf.batch_apply(JDataset.of(X)).array)
        port = interop.params_from_jax(
            {"W": np.asarray(rf.W), "b": np.asarray(rf.b)}, device="cpu"
        )
        got = port.batch_apply(TDataset.of(_t(X))).to_numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            port.apply(_t(X[0])).numpy(), want[0], rtol=0, atol=1e-5
        )

    def test_fused_bcd_against_reference(self):
        # Three 64-wide blocks, 400 rows, 3 epochs; f32 against f64 on
        # well-conditioned Gaussian blocks: 1e-4 relative.
        rng = np.random.default_rng(2)
        A = rng.normal(size=(3, 400, 64))
        B = rng.normal(size=(400, 5))
        want = np.asarray(jlinalg.bcd_least_squares_fused(A, B, lam=0.5, num_iter=3))
        got = tlinalg.bcd_least_squares_fused(_t(A), _t(B), lam=0.5, num_iter=3)
        assert got.shape == (3, 64, 5)
        assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-4

    def test_stepwise_bcd_against_reference(self):
        rng = np.random.default_rng(3)
        blocks = [rng.normal(size=(300, 32)) for _ in range(3)]
        B = rng.normal(size=(300, 4))
        want = jlinalg.bcd_least_squares(blocks, B, lam=0.1, num_iter=2)
        got = tlinalg.bcd_least_squares([_t(b) for b in blocks], _t(B), lam=0.1, num_iter=2)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)

    def test_normal_equations_against_lstsq(self):
        rng = np.random.default_rng(4)
        A = rng.normal(size=(200, 20))
        B = rng.normal(size=(200, 3))
        got = tlinalg.normal_equations_solve(_t(A), _t(B)).numpy()
        want = np.linalg.lstsq(A, B, rcond=None)[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_rank_deficient_solve_takes_the_rescue(self):
        # 10 rows, 40 columns, lam = 0: the exact factorization fails and
        # both packages rescue through the jittered Cholesky. Both solves
        # are then finite and agree to 1e-3 relative (the jitter fixes the
        # system; the remaining gap is f32 against f64).
        A = np.random.default_rng(5).normal(size=(10, 40))
        gram, rhs = A.T @ A, A.T @ np.ones((10, 2))
        want = np.asarray(jlinalg._solve_psd(jnp.asarray(gram), jnp.asarray(rhs), 0.0))
        got = tlinalg._solve_psd(_t(gram), _t(rhs), 0.0).numpy()
        assert np.all(np.isfinite(got))
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3

    def test_evaluator_confusion(self):
        rng = np.random.default_rng(6)
        preds, labels = rng.integers(0, 7, size=300), rng.integers(0, 7, size=300)
        j = JEvaluator(7).evaluate(JDataset.of(preds), JDataset.of(labels))
        t = TEvaluator(7).evaluate(TDataset.of(_t(preds, torch.int64)),
                                   TDataset.of(_t(labels, torch.int64)))
        np.testing.assert_array_equal(t.confusion, j.confusion)
        assert t.total_error == j.total_error


class TestPortPipelineBehaviour:
    def test_fit_is_reused_across_applies(self):
        # The fitted estimator is published to the prefix table once; a
        # second apply of the lazy pipeline loads it instead of refitting.
        calls = []

        class Counting(TBlockLS):
            def fit(self, data, labels):
                calls.append(1)
                return super().fit(data, labels)

        train = t_synthetic_timit(256, seed=1, device="cpu")
        labels = TLabels(147)(train.labels)
        feats = TCosineRandomFeatures(440, 64, 0.05555, seed=1, device="cpu")
        pipe = feats.to_pipeline().and_then(Counting(64, 1), train.data, labels)
        first = pipe.apply(train.data).get().to_numpy()
        second = pipe.apply(train.data).get().to_numpy()
        np.testing.assert_array_equal(first, second)
        assert len(calls) == 1

    def test_fitted_pipeline_save_load(self, tmp_path):
        train = t_synthetic_timit(256, seed=2, device="cpu")
        labels = TLabels(147)(train.labels)
        pipe = TCosineRandomFeatures(440, 64, 0.05555, seed=2, device="cpu").to_pipeline() \
            .and_then(TBlockLS(32, 2), train.data, labels)
        fitted = pipe.fit()
        path = str(tmp_path / "fitted.pkl")
        fitted.save(path)
        loaded = TFittedPipeline.load(path)
        np.testing.assert_array_equal(
            loaded.apply(train.data).to_numpy(), fitted.apply(train.data).to_numpy()
        )
        # A single datum walks the same graph.
        np.testing.assert_allclose(
            loaded.apply(train.data.array[0]).numpy(),
            fitted.apply(train.data).to_numpy()[0], rtol=1e-5, atol=1e-5,
        )

    def test_padding_rows_stay_zero(self):
        # 5 true rows in a 8-row buffer: a non-zero-preserving node must
        # leave the 3 padding rows at zero (they would pollute Gramians).
        X = torch.zeros((8, 3))
        X[:5] = torch.arange(15, dtype=torch.float32).reshape(5, 3)
        out = TLabels(4)(TDataset(torch.tensor([0, 1, 2, 3, 0, 0, 0, 0]), n=5))
        assert out.n == 5 and torch.equal(out.data[5:], torch.zeros((3, 4)))
        res = TDataset(X, n=5).map_batch(lambda a: a + 1.0)
        assert torch.equal(res.data[5:], torch.zeros((3, 3)))
        assert torch.equal(res.data[:5], X[:5] + 1.0)

    def test_lambda_transformer_on_datum_and_host_data(self):
        double = t_transformer(lambda x: 2 * x)
        assert double(21) == 42
        assert double(TDataset.of(["a", "b"])).to_list() == ["aa", "bb"]
        assert double.to_pipeline().apply(TDataset.of([1, 2])).get().to_list() == [2, 4]

    def test_node_optimization_sees_a_sample_and_the_full_size(self):
        # An optimizable estimator is handed a few sampled rows plus the
        # true row count, and the concrete estimator it picks is fitted.
        seen = {}

        class Choice(TOptimizableLabelEstimator):
            @property
            def default(self):
                return TBlockLS(16, 1)

            def optimize(self, sample, labels_sample):
                seen["rows"], seen["total_n"] = sample.n, sample.total_n
                return TBlockLS(8, 2)

        train = t_synthetic_timit(64, seed=3, device="cpu")
        labels = TLabels(147)(train.labels)
        feats = TCosineRandomFeatures(440, 16, 0.05555, seed=3, device="cpu")
        fitted = feats.to_pipeline().and_then(Choice(), train.data, labels).fit()
        assert seen == {"rows": 3, "total_n": 64}
        assert _mapper(fitted, TBlockLinearMapper).block_size == 8

    def test_cli_runs_on_the_cpu(self, capsys):
        from keystone_tpu_torch import run

        assert run.main(["TimitPipeline", "--numCosines", "1", "--blockSize", "64",
                         "--syntheticN", "256", "--numEpochs", "1", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "TRAIN Error is" in out and "TEST Error is" in out
        with pytest.raises(SystemExit):
            run.main(["NoSuchPipeline"])

    def test_cauchy_draws_are_cauchy(self):
        # Standard Cauchy: the median of |W|/gamma is tan(pi/4) = 1.
        rf = TCosineRandomFeatures(440, 512, 0.5, seed=4, cauchy=True, device="cpu")
        med = float(torch.median(rf.W.abs() / 0.5))
        assert abs(med - 1.0) < 0.02
        assert float(rf.b.min()) >= 0.0 and float(rf.b.max()) <= 2 * np.pi

    def test_draws_follow_the_seed(self):
        a = TCosineRandomFeatures(440, 16, 0.1, seed=9, device="cpu")
        b = TCosineRandomFeatures(440, 16, 0.1, seed=9, device="cpu")
        c = TCosineRandomFeatures(440, 16, 0.1, seed=10, device="cpu")
        assert torch.equal(a.W, b.W) and torch.equal(a.b, b.b)
        assert not torch.equal(a.W, c.W)

    @pytest.mark.parametrize("solver", ["auto", "streaming"])
    def test_unported_solvers_name_their_slice(self, solver):
        with pytest.raises(NotImplementedError, match="slice 3"):
            t_timit.run(t_timit.TimitConfig(solver=solver, **SLICE), device="cpu")

    def test_interop_builds_the_block_mapper(self):
        rng = np.random.default_rng(8)
        xs = [rng.normal(size=(4, 3)) for _ in range(2)]
        scalers = [{"mean": rng.normal(size=4), "std": None} for _ in range(2)]
        j = JBlockLinearMapper([jnp.asarray(x) for x in xs], 4, b_opt=jnp.ones(3))
        t = interop.params_from_jax(
            {"xs": xs, "block_size": 4, "b_opt": np.ones(3), "feature_scalers": None},
            device="cpu",
        )
        X = rng.normal(size=(6, 8))
        np.testing.assert_allclose(
            t.batch_apply(TDataset.of(_t(X))).to_numpy(),
            np.asarray(j.batch_apply(JDataset.of(X)).array), rtol=1e-5, atol=1e-5,
        )
        t2 = interop.params_from_jax(
            {"xs": xs, "block_size": 4, "feature_scalers": scalers}, device="cpu"
        )
        want = sum((X[:, 4 * i:4 * i + 4] - scalers[i]["mean"]) @ xs[i] for i in range(2))
        np.testing.assert_allclose(
            t2.batch_apply(TDataset.of(_t(X))).to_numpy(), want, rtol=1e-5, atol=1e-5
        )
