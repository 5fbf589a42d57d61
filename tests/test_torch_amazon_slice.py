"""The port's Amazon reviews text front end against the JAX package, on the
CPU: the tokenizer nodes, TermFrequency, the logistic regression's L-BFGS
(optax's, ported step for step without optax), the binary evaluator, the
loaders and the pipeline end to end.

Inputs are float32 on both sides. Under tests/conftest.py's x64 the
reference's L-BFGS runs on float32 operands, but some of optax's line-search
scalars are float64 (its weakly typed constants), so the two differ by
rounding in the line search's interpolation as well as in the sums.

Tolerances and why:
  - tokens, n-grams, term counts, feature spaces, loader output, binary
    counts: exact.
  - L-BFGS loss after each step and final weights: 1e-5 relative (measured
    up to 2.9e-7 and 6.9e-7 on 480 masked rows of 60 features, 20 steps):
    float32 products in other orders, and no step decision flips.
  - the L-BFGS losses on the pipeline's own features (2,000 synthetic
    documents, 1,000 common features): 2e-4 relative (measured 9.96e-5 at
    the last step). The documents are separable, so the loss falls 5,000x
    in 14 steps and the same absolute rounding is a growing share of it;
    ``chip_smoke.py`` holds the card's run to the CPU's at this tolerance.
  - the zoom line search's stepsize and value: 1e-5 relative on
    directions that make it search, zoom and fail.
  - the pipeline's weights: 1e-4 relative (measured 1.5e-6), its accuracy
    equal.
"""

import json

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import loaders as t_loaders
from keystone_tpu_torch.evaluation import BinaryClassifierEvaluator as TBinaryEvaluator
from keystone_tpu_torch.ops import nlp as t_nlp
from keystone_tpu_torch.ops.learning import classifiers as t_cls
from keystone_tpu_torch.ops.sparse import CommonSparseFeatures as TCommonSparseFeatures
from keystone_tpu_torch.ops.stats import TermFrequency as TTermFrequency
from keystone_tpu_torch.pipelines import amazon_reviews as t_amazon
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

import jax
import jax.numpy as jnp
import optax

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import loaders as j_loaders
from keystone_tpu.evaluation import BinaryClassifierEvaluator as JBinaryEvaluator
from keystone_tpu.ops import nlp as j_nlp
from keystone_tpu.ops.learning import classifiers as j_cls
from keystone_tpu.ops.sparse import CommonSparseFeatures as JCommonSparseFeatures
from keystone_tpu.ops.sparse import densify_dataset as j_densify
from keystone_tpu.ops.stats import TermFrequency as JTermFrequency
from keystone_tpu.pipelines import amazon_reviews as j_amazon
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

LBFGS_TOL = 1e-5
AMAZON_TRAJECTORY_TOL = 2e-4
PIPELINE_WEIGHT_TOL = 1e-4

TEXTS = [
    "The quick brown fox",
    "  leading and trailing spaces  ",
    ",,leading separators kept, trailing dropped,,",
    "",
    "...",
    "MiXeD CaSe, punctuation! and\ttabs\nnewlines",
    "naïve café über",
    "a",
]


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


class TestTextNodes:
    @pytest.mark.parametrize("sep", [None, r"\s+", ","])
    def test_tokenizer_follows_java_split(self, sep):
        kw = {} if sep is None else {"sep": sep}
        for text in TEXTS:
            assert t_nlp.Tokenizer(**kw).apply(text) == j_nlp.Tokenizer(**kw).apply(text)
        assert t_nlp.Tokenizer().apply(",,a b,,") == ["", "a", "b"]
        assert t_nlp.Tokenizer().apply("...") == []

    def test_trim_and_lowercase(self):
        for text in TEXTS:
            assert t_nlp.Trim().apply(text) == j_nlp.Trim().apply(text)
            assert t_nlp.LowerCase().apply(text) == j_nlp.LowerCase().apply(text)

    @pytest.mark.parametrize("orders", [[1], [1, 2], [2, 3], [1, 2, 3]])
    def test_ngrams(self, orders):
        for text in TEXTS:
            tokens = j_nlp.Tokenizer().apply(text.lower())
            assert (t_nlp.NGramsFeaturizer(orders).apply(tokens)
                    == j_nlp.NGramsFeaturizer(orders).apply(tokens))

    @pytest.mark.parametrize("orders", [[0, 1], [1, 3]])
    def test_ngram_orders_are_checked(self, orders):
        with pytest.raises(ValueError):
            t_nlp.NGramsFeaturizer(orders)

    def test_ngram_value_type(self):
        a, b = t_nlp.NGram(["x", "y"]), t_nlp.NGram(("x", "y"))
        assert a == b and hash(a) == hash(b) and len(a) == 2
        assert repr(a) == repr(j_nlp.NGram(["x", "y"])) == "[x,y]"
        assert a != t_nlp.NGram(["y", "x"])

    @pytest.mark.parametrize("binary", [False, True])
    def test_term_frequency(self, binary):
        weighting = (lambda x: 1) if binary else (lambda x: x)
        items = ["a", "b", "a", ("a", "b"), "a", ("a", "b")]
        want = JTermFrequency(weighting=weighting).apply(items)
        assert TTermFrequency(weighting=weighting).apply(items) == want
        docs = [items, [], ["z"]]
        got = TTermFrequency(weighting=weighting).batch_apply(TDataset(docs)).to_list()
        assert got == JTermFrequency(weighting=weighting).batch_apply(JDataset(docs)).to_list()

    def test_featurizer_and_common_features_match(self):
        docs = j_loaders.synthetic_documents(120, 2, seed=4).data.to_list()
        t_cfg, j_cfg = t_amazon.AmazonReviewsConfig(), j_amazon.AmazonReviewsConfig()
        t_tf = t_amazon.build_featurizer(t_cfg).apply(TDataset(list(docs))).get().to_list()
        j_tf = j_amazon.build_featurizer(j_cfg).apply(JDataset(list(docs))).get().to_list()
        assert t_tf == j_tf
        t_space = TCommonSparseFeatures(50).fit(TDataset(t_tf)).feature_space
        j_space = JCommonSparseFeatures(50).fit(JDataset(j_tf)).feature_space
        assert t_space == j_space


def _problem(seed, scale=1.0, n=500, pad=20, d=60, k=3):
    """A float32 logistic problem with ``pad`` padding rows of garbage
    features (mask 0, no one-hot)."""
    rng = np.random.default_rng(seed)
    X = (scale * rng.normal(size=(n, d))).astype(np.float32)
    y = np.argmax(X[:, :k] + 0.5 * rng.normal(size=(n, k)), axis=1)
    onehot = np.eye(k, dtype=np.float32)[y]
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0
    onehot[n - pad:] = 0
    return X, onehot, mask, np.zeros((d, k), np.float32), float(n - pad)


def _ref_lbfgs(X, onehot, mask, W0, n, lam, iters, tol):
    W, loss = j_cls._logistic_lbfgs(
        *(jnp.asarray(a) for a in (X, onehot, mask, W0)),
        jnp.float32(n), jnp.float32(lam), jnp.asarray(iters), jnp.float32(tol))
    return np.asarray(W), float(loss)


def _port_lbfgs(X, onehot, mask, W0, n, lam, iters, tol):
    operands = (torch.from_numpy(np.array(a)) for a in (X, onehot, mask, W0))
    return t_cls.logistic_lbfgs(*operands, n, lam, iters, tol)


class TestLogisticLBFGS:
    @pytest.mark.parametrize("seed,lam", [(0, 0.0), (1, 1e-2)])
    def test_loss_after_each_step_and_weights(self, seed, lam):
        X, onehot, mask, W0, n = _problem(seed)
        got = _port_lbfgs(X, onehot, mask, W0, n, lam, 20, 1e-4)
        assert 10 <= got.iterations <= 20 and len(got.losses) == got.iterations
        for step, loss in enumerate(got.losses, start=1):
            want = _ref_lbfgs(X, onehot, mask, W0, n, lam, step, 1e-4)[1]
            assert loss == pytest.approx(want, rel=LBFGS_TOL), step
        W, loss = _ref_lbfgs(X, onehot, mask, W0, n, lam, 20, 1e-4)
        assert np.linalg.norm(got.W.numpy() - W) / np.linalg.norm(W) <= LBFGS_TOL
        assert got.loss == pytest.approx(loss, rel=LBFGS_TOL)
        assert got.losses == sorted(got.losses, reverse=True)

    def test_stops_at_num_iters(self):
        X, onehot, mask, W0, n = _problem(2)
        for iters in (0, 1, 3):
            got = _port_lbfgs(X, onehot, mask, W0, n, 0.0, iters, 1e-9)
            assert got.iterations == iters
            W, _ = _ref_lbfgs(X, onehot, mask, W0, n, 0.0, iters, 1e-9)
            if iters == 0:
                assert np.array_equal(got.W.numpy(), W0) and np.array_equal(W, W0)
            else:
                assert np.linalg.norm(got.W.numpy() - W) / np.linalg.norm(W) <= LBFGS_TOL

    def test_stops_at_tol_on_the_carried_gradient(self):
        # The reference tests the gradient its last step started from, one
        # step behind the iterate: both stop after the same step.
        X, onehot, mask, W0, n = _problem(3)
        tol = 1e-2
        got = _port_lbfgs(X, onehot, mask, W0, n, 0.0, 100, tol)
        assert 1 < got.iterations < 100
        W, _ = _ref_lbfgs(X, onehot, mask, W0, n, 0.0, 100, tol)
        assert np.linalg.norm(got.W.numpy() - W) / np.linalg.norm(W) <= LBFGS_TOL
        one_less = _ref_lbfgs(X, onehot, mask, W0, n, 0.0, got.iterations - 1, tol)[0]
        assert np.linalg.norm(one_less - W) / np.linalg.norm(W) > 10 * LBFGS_TOL

    def test_padding_rows_are_masked_out(self):
        X, onehot, mask, W0, n = _problem(4)
        live = mask > 0
        padded = _port_lbfgs(X, onehot, mask, W0, n, 1e-3, 15, 1e-6)
        trimmed = _port_lbfgs(X[live], onehot[live], mask[live], W0, n, 1e-3, 15, 1e-6)
        np.testing.assert_allclose(padded.losses, trimmed.losses, rtol=LBFGS_TOL)
        np.testing.assert_allclose(padded.W.numpy(), trimmed.W.numpy(), rtol=1e-4, atol=1e-6)
        W, _ = _ref_lbfgs(X, onehot, mask, W0, n, 1e-3, 15, 1e-6)
        assert np.linalg.norm(padded.W.numpy() - W) / np.linalg.norm(W) <= LBFGS_TOL

    def test_loss_and_gradient_are_the_references(self):
        X, onehot, mask, _, n = _problem(5)
        W = (0.1 * np.random.default_rng(5).normal(size=(60, 3))).astype(np.float32)

        def loss_fn(W):
            logits = jnp.asarray(X) @ W
            lse = jax.nn.logsumexp(logits, axis=1)
            ll = jnp.sum(logits * onehot, axis=1) - lse * mask
            return -jnp.sum(ll) / n + 0.5 * 0.3 * jnp.sum(W * W)

        want_v, want_g = jax.value_and_grad(loss_fn)(jnp.asarray(W))
        v, g = t_cls.logistic_loss_and_grad(*(torch.from_numpy(a) for a in (X, onehot, mask, W)),
                                            n, 0.3)
        assert float(v) == pytest.approx(float(want_v), rel=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("scale", [-1.0, -30.0, -300.0, -1e-4, 1.0])
    def test_zoom_linesearch_is_optaxs(self, scale):
        # -1: the first guess; -30, -300: an interval, then zoom steps;
        # -1e-4: doubling; +1, an ascent direction: 20 steps, then failure.
        X, onehot, mask, _, n = _problem(6, n=300, pad=0, d=20)
        W = (0.1 * np.random.default_rng(6).normal(size=(20, 3))).astype(np.float32)

        def loss_fn(W):
            logits = jnp.asarray(X) @ W
            lse = jax.nn.logsumexp(logits, axis=1)
            ll = jnp.sum(logits * onehot, axis=1) - lse * mask
            return -jnp.sum(ll) / n + 0.5 * 0.01 * jnp.sum(W * W)

        value, grad = jax.value_and_grad(loss_fn)(jnp.asarray(W))
        ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
                                            initial_guess_strategy="one")
        updates, state = ls.update(scale * grad, ls.init(jnp.asarray(W)), jnp.asarray(W),
                                   value=value, grad=grad, value_fn=loss_fn)
        want_step = float(updates.reshape(-1)[0] / (scale * grad).reshape(-1)[0])

        def value_and_grad(Wt):
            return t_cls.logistic_loss_and_grad(
                *(torch.from_numpy(a) for a in (X, onehot, mask)), Wt, n, 0.01)

        Wt = torch.from_numpy(W)
        v, g = value_and_grad(Wt)
        step, new_value, _, trials = t_cls.zoom_linesearch(value_and_grad, Wt, scale * g, v, g)
        assert trials == int(state.info.num_linesearch_steps)
        assert float(step) == pytest.approx(want_step, rel=LBFGS_TOL)
        assert float(new_value) == pytest.approx(float(state.value), rel=LBFGS_TOL)


def _coo_dataset(n, d, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(d, size=(n, 6)), axis=1).astype(np.int32)
    idx[:, 1:][idx[:, 1:] == idx[:, :-1]] = -1
    vals = np.ones((n, 6), np.float32)
    labels = (np.isin(idx, np.arange(d // 2)).sum(1) > 3).astype(np.int64)
    return idx, vals, labels


class TestEstimatorAndEvaluator:
    def test_estimator_on_sparse_rows(self):
        idx, vals, labels = _coo_dataset(400, 40, 7)
        j_model = j_cls.LogisticRegressionEstimator(2, num_iters=12).fit(
            JDataset({"indices": idx, "values": vals}), JDataset.of(labels))
        est = t_cls.LogisticRegressionEstimator(2, num_iters=12)
        t_model = est.fit(TDataset({"indices": idx, "values": vals}),
                          TDataset(torch.from_numpy(labels)))
        W = np.asarray(j_model.weights)
        assert t_model.weights.shape == W.shape == (int(idx.max()) + 1, 2)
        assert np.linalg.norm(t_model.weights.numpy() - W) / np.linalg.norm(W) <= LBFGS_TOL
        assert est.last_fit.iterations <= 12
        test = TDataset({"indices": idx[:50], "values": vals[:50]})
        want = np.asarray(j_model.batch_apply(
            JDataset({"indices": idx[:50], "values": vals[:50]})).array)
        assert np.array_equal(t_model.batch_apply(test).array.numpy(), want)

    def test_interop_carries_the_model(self):
        W = np.random.default_rng(8).normal(size=(10, 2)).astype(np.float32)
        model = interop.params_from_jax({"weights": W}, device="cpu")
        assert isinstance(model, t_cls.LogisticRegressionModel)
        X = np.random.default_rng(9).normal(size=(30, 10)).astype(np.float32)
        want = np.asarray(j_cls.LogisticRegressionModel(jnp.asarray(W)).batch_apply(
            JDataset.of(X)).array)
        assert np.array_equal(model.batch_apply(TDataset(torch.from_numpy(X))).array.numpy(),
                              want)

    def test_binary_evaluator(self):
        rng = np.random.default_rng(10)
        preds, labels = rng.integers(0, 2, 97), rng.integers(0, 2, 97)
        want = JBinaryEvaluator().evaluate(JDataset.of(preds), JDataset.of(labels))
        got = TBinaryEvaluator().evaluate(TDataset(torch.from_numpy(preds)),
                                          TDataset(torch.from_numpy(labels)))
        assert (got.tp, got.fp, got.tn, got.fn) == (want.tp, want.fp, want.tn, want.fn)
        for name in ("accuracy", "error", "precision", "recall", "specificity", "f1"):
            assert getattr(got, name) == getattr(want, name)
        assert got.tp + got.fp + got.tn + got.fn == 97


class TestLoadersAndPipeline:
    def test_synthetic_documents_are_the_references(self):
        j = j_loaders.synthetic_documents(80, 3, seed=2)
        t = t_loaders.synthetic_documents(80, 3, seed=2, device="cpu")
        assert t.data.to_list() == j.data.to_list()
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))

    def test_amazon_reviews_loader(self, tmp_path):
        recs = [{"overall": 5.0, "reviewText": "great"}, {"overall": 3.0, "reviewText": "meh"},
                {"overall": 3.5, "reviewText": "ok"}, {"overall": 1.0}]
        (tmp_path / "a.json").write_text("\n".join(json.dumps(r) for r in recs[:2]) + "\n\n")
        (tmp_path / "b.json").write_text("\n".join(json.dumps(r) for r in recs[2:]))
        for path in (tmp_path, tmp_path / "a.json"):
            j = j_loaders.load_amazon_reviews(str(path))
            t = t_loaders.load_amazon_reviews(str(path), device="cpu")
            assert t.data.to_list() == j.data.to_list()
            np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))
        assert t_loaders.load_amazon_reviews(str(tmp_path), device="cpu").labels.to_numpy(
            ).tolist() == [1, 0, 1, 0]

    def test_run_end_to_end_against_the_reference(self):
        cfg = dict(synthetic_n=300, common_features=200, num_iters=10)
        pipe, j_train, j_test = j_amazon.run(j_amazon.AmazonReviewsConfig(**cfg))
        (j_model,) = [o for o in pipe.fit().transformer_graph.operators.values()
                      if isinstance(o, j_cls.LogisticRegressionModel)]
        r = t_amazon.run(t_amazon.AmazonReviewsConfig(**cfg), device="cpu")
        W = np.asarray(j_model.weights)
        got = r.estimator.last_fit.W.numpy()
        assert got.shape == W.shape == (200, 2)
        assert np.linalg.norm(got - W) / np.linalg.norm(W) <= PIPELINE_WEIGHT_TOL
        assert r.train_eval.accuracy == j_train.accuracy
        assert r.test_eval.accuracy == j_test.accuracy
        assert r.estimator.last_fit.iterations == 10
        assert r.fit_seconds > 0 and r.apply_seconds > 0

    def test_loss_trajectory_on_the_pipelines_features(self):
        # The reference's featurization of 2,000 synthetic documents, then
        # both L-BFGS runs on the same float32 rows, step by step.
        train = j_loaders.synthetic_documents(2000, 2, seed=0)
        tf = j_amazon.build_featurizer(j_amazon.AmazonReviewsConfig()).apply(train.data).get()
        coo = JCommonSparseFeatures(1000).fit(tf).batch_apply(tf)
        X = np.asarray(j_densify(coo).array, dtype=np.float32)
        y = np.asarray(train.labels.array)
        onehot = np.eye(2, dtype=np.float32)[y]
        mask = np.ones(len(y), np.float32)
        W0 = np.zeros((X.shape[1], 2), np.float32)
        got = _port_lbfgs(X, onehot, mask, W0, float(len(y)), 0.0, 20, 1e-4)
        assert X.shape == (2000, 1000) and 10 <= got.iterations < 20
        for step, loss in enumerate(got.losses, start=1):
            want = _ref_lbfgs(X, onehot, mask, W0, len(y), 0.0, step, 1e-4)[1]
            assert loss == pytest.approx(want, rel=AMAZON_TRAJECTORY_TOL), step

    def test_run_raises_without_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            t_amazon.run(t_amazon.AmazonReviewsConfig(synthetic_n=64))

    def test_cli_runs_on_the_cpu(self, capsys):
        from keystone_tpu_torch import run as t_run

        t_run.main(["AmazonReviewsPipeline", "--syntheticN", "200", "--commonFeatures", "100",
                    "--numIters", "5", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "TRAIN accuracy is" in out and "TEST accuracy is" in out
