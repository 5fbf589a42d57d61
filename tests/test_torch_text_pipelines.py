"""The text slice of the port against the JAX package on the CPU:
NewsgroupsPipeline (keystone_tpu_torch/pipelines/newsgroups.py) and its
NaiveBayesEstimator, LinearDiscriminantAnalysis, the rest of
keystone_tpu_torch/ops/nlp.py (hashing TF, frequency encoding, n-gram
indexers, Stupid Backoff, sharded scoring), the lemmatizer,
StupidBackoffPipeline (pipelines/stupid_backoff.py), the samplers of
ops/stats.py, utils/stats.about_eq and the loaders of the slice.

The text work is host Python in both packages and must give the same
integers and strings; the scores are float64 host arithmetic in both and
are held to 1e-12. Naive Bayes and LDA are held to 1e-6 in float64 (LDA's
eigenvectors up to the sign of each column); the pipelines' errors are
equal.
"""

import math

import numpy as np
import pytest
import torch

from keystone_tpu_torch import run as trun
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import loaders as tloaders
from keystone_tpu_torch.ops import lemmatizer as tlemma
from keystone_tpu_torch.ops import nlp as tnlp
from keystone_tpu_torch.ops import stats as tstats
from keystone_tpu_torch.ops.learning import classifiers as tcls
from keystone_tpu_torch.pipelines import newsgroups as tnews
from keystone_tpu_torch.pipelines import stupid_backoff as tsb
from keystone_tpu_torch.utils import stats as tustats
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import loaders as jloaders
from keystone_tpu.ops import nlp as jnlp
from keystone_tpu.ops import stats as jstats
from keystone_tpu.ops.learning import classifiers as jcls
from keystone_tpu.pipelines import newsgroups as jnews
from keystone_tpu.pipelines import stupid_backoff as jsb
from keystone_tpu.utils import stats as justats
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sentences(n=300, seed=0):
    return jloaders.synthetic_sentences(n, seed=seed).to_list()


# ---------------------------------------------------------------------------
# Loaders, samplers, about_eq
# ---------------------------------------------------------------------------


class TestLoaders:
    def test_synthetic_sentences_are_the_references(self):
        assert tloaders.synthetic_sentences(50, seed=4).to_list() == _sentences(50, 4)

    def test_load_newsgroups(self, tmp_path):
        rng = np.random.default_rng(0)
        for cls in ("sci.space", "alt.atheism", "comp.graphics"):
            (tmp_path / cls).mkdir()
            for i in range(int(rng.integers(1, 4))):
                (tmp_path / cls / f"{i:03d}").write_text(f"{cls} document {i}\nline two")
        (tmp_path / "README").write_text("not a class")
        j = jloaders.load_newsgroups(str(tmp_path))
        t = tloaders.load_newsgroups(str(tmp_path), device="cpu")
        assert t.data.to_list() == j.data.to_list()
        np.testing.assert_array_equal(_np(t.labels.array), np.asarray(j.labels.array))
        order = ["sci.space", "alt.atheism"]
        j = jloaders.load_newsgroups(str(tmp_path), class_dirs=order)
        t = tloaders.load_newsgroups(str(tmp_path), class_dirs=order, device="cpu")
        assert t.data.to_list() == j.data.to_list()
        np.testing.assert_array_equal(_np(t.labels.array), np.asarray(j.labels.array))


class TestSamplersAndAboutEq:
    def test_host_sample_is_the_references(self):
        items = [f"item{i}" for i in range(40)]
        for k, seed in ((5, 0), (40, 3), (100, 1)):
            want = jstats.sample_dataset(JDataset(items), k, seed).to_list()
            assert tstats.sample_dataset(TDataset(items), k, seed).to_list() == want
            assert tstats.Sampler(k, seed)(TDataset(items)).to_list() == want

    def test_array_sample_is_a_seeded_subset_of_rows(self):
        X = torch.arange(60.0).reshape(20, 3)
        a = tstats.sample_dataset(TDataset(X), 7, seed=2)
        b = tstats.sample_dataset(TDataset(X), 7, seed=2)
        assert a.n == 7 and torch.equal(a.array, b.array)
        rows = {tuple(r) for r in X.tolist()}
        picked = [tuple(r) for r in a.array.tolist()]
        assert set(picked) <= rows and len(set(picked)) == 7

    def test_column_sampler(self):
        x = torch.arange(24.0).reshape(4, 6)
        got = tstats.ColumnSampler(10, seed=1).apply(x)
        assert tuple(got.shape) == (4, 10)
        cols = {tuple(c) for c in x.T.tolist()}
        assert all(tuple(c) in cols for c in got.T.tolist())
        assert torch.equal(got, tstats.ColumnSampler(10, seed=1).apply(x))

    @pytest.mark.parametrize("a,b,thr", [
        (1.0, 1.0 + 1e-9, 1e-8), (1.0, 1.0 + 1e-7, 1e-8), ([1.0, 2.0], [1.0, 2.5], 1.0),
        (np.zeros((2, 2)), np.full((2, 2), 1e-3), 1e-3), ([[1, 2]], [[1, 2]], 1e-8)])
    def test_about_eq(self, a, b, thr):
        want = justats.about_eq(a, b, thr)
        assert tustats.about_eq(a, b, thr) is want
        assert tustats.about_eq(torch.tensor(a, dtype=torch.float64), b, thr) is want

    def test_about_eq_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="same shape"):
            tustats.about_eq([1.0, 2.0], [1.0])


# ---------------------------------------------------------------------------
# ops/nlp.py and the lemmatizer
# ---------------------------------------------------------------------------


TERMS = ["", "a", "word", "naïve", "c3term7", ("w1", "w2"), 17, ("x",)]


class TestHashing:
    @pytest.mark.parametrize("term", TERMS)
    def test_stable_hash(self, term):
        assert tnlp.stable_hash(term) == jnlp.stable_hash(term)
        if isinstance(term, tuple):
            assert tnlp._ngram_hash(term) == jnlp._ngram_hash(term)

    @pytest.mark.parametrize("num_features", [1, 7, 1 << 20])
    def test_hashing_tf(self, num_features):
        docs = [s.split() for s in _sentences(20)]
        j, t = jnlp.HashingTF(num_features), tnlp.HashingTF(num_features)
        for doc in docs + [[("a", "b"), ("a", "b"), "a"]]:
            assert t.apply(doc) == j.apply(doc)

    @pytest.mark.parametrize("orders", [[1], [1, 2], [2, 3], [1, 2, 3]])
    def test_ngrams_hashing_tf(self, orders):
        docs = [s.split() for s in _sentences(20)] + [[], ["one"]]
        j, t = jnlp.NGramsHashingTF(orders, 1000), tnlp.NGramsHashingTF(orders, 1000)
        for doc in docs:
            got = t.apply(doc)
            assert got == j.apply(doc)
            # It is HashingTF over NGramsFeaturizer's n-grams (the fused form).
            grams = tnlp.NGramsFeaturizer(orders).apply(doc)
            assert got == tnlp.HashingTF(1000).apply(grams)

    def test_orders_are_validated(self):
        with pytest.raises(ValueError, match="consecutive"):
            tnlp.NGramsHashingTF([1, 3], 10)


class TestCountsAndEncoding:
    def test_word_frequency_encoder(self):
        tokens = [s.split() for s in _sentences(100)] + [["unseen", "w1"]]
        j = jnlp.WordFrequencyEncoder().fit(JDataset(tokens))
        t = tnlp.WordFrequencyEncoder().fit(TDataset(tokens))
        assert t.word_index == j.word_index and t.unigram_counts == j.unigram_counts
        probe = [["w0", "nope", "w3"], []]
        assert t.batch_apply(TDataset(probe)).to_list() == j.batch_apply(JDataset(probe)).to_list()
        assert t.apply(["nope"]) == [tnlp.WordFrequencyTransformer.OOV_INDEX] == [-1]

    @pytest.mark.parametrize("mode", ["default", "no_add"])
    def test_ngrams_counts(self, mode):
        grams = [tnlp.NGramsFeaturizer([1, 2]).apply(s.split()) for s in _sentences(30)]
        j = jnlp.NGramsCounts(mode).batch_apply(JDataset(grams)).to_list()
        t = tnlp.NGramsCounts(mode).batch_apply(TDataset(grams)).to_list()
        if mode == "default":
            assert [(g.words, c) for g, c in t] == [(g.words, c) for g, c in j]
        else:
            assert [[(g.words, c) for g, c in item] for item in t] == \
                [[(g.words, c) for g, c in item] for item in j]
        with pytest.raises(ValueError):
            tnlp.NGramsCounts("sum")

    def test_corenlp_feature_extractor(self):
        sentences = ["The children were running to the shelves", "She studied matrices",
                     "  Leaves fell; wolves howled  "]
        j, t = jnlp.CoreNLPFeatureExtractor([1, 2]), tnlp.CoreNLPFeatureExtractor([1, 2])
        for s in sentences:
            assert t.apply(s) == j.apply(s)
        upper = tnlp.CoreNLPFeatureExtractor([1], lemmatizer=str.upper)
        assert upper.apply("a b") == [("A",), ("B",)]


class TestLemmatizer:
    def test_golden_ledger(self):
        from lemma_golden import GOLDEN

        assert len(GOLDEN) >= 200
        wrong = [(w, tlemma.lemmatize(w), want) for w, want in GOLDEN
                 if tlemma.lemmatize(w) != want]
        assert not wrong, wrong[:20]

    def test_same_lemmas_as_the_reference(self):
        from keystone_tpu.ops.lemmatizer import lemmatize

        from lemma_golden import GOLDEN
        words = [w for w, _ in GOLDEN] + [g for _, g in GOLDEN] + [
            "", "a", "is", "BUSES", "hoping", "ringing", "news", "glasses", "boxes", "potatoes"]
        assert [tlemma.lemmatize(w) for w in words] == [lemmatize(w) for w in words]


class TestIndexers:
    NGRAMS = [(5,), (0,), (3, 9), ((1 << 20) - 1, 0), (1, 2, 3), (7, 0, (1 << 20) - 1)]

    @pytest.mark.parametrize("ngram", NGRAMS)
    def test_bit_pack(self, ngram):
        j, t = jnlp.NaiveBitPackIndexer(), tnlp.NaiveBitPackIndexer()
        packed = t.pack(ngram)
        assert packed == j.pack(ngram)
        order = t.ngram_order(packed)
        assert order == j.ngram_order(packed) == len(ngram)
        assert tuple(t.unpack(packed, p) for p in range(order)) == ngram
        if order > 1:
            assert t.remove_farthest_word(packed) == j.remove_farthest_word(packed)
            assert t.remove_current_word(packed) == j.remove_current_word(packed)
            assert t.remove_farthest_word(packed) == t.pack(ngram[1:])
            assert t.remove_current_word(packed) == t.pack(ngram[:-1])

    def test_bit_pack_raises(self):
        t = tnlp.NaiveBitPackIndexer()
        with pytest.raises(ValueError):
            t.pack((1 << 20,))
        with pytest.raises(ValueError):
            t.pack((1, 2, 3, 4))
        with pytest.raises(ValueError):
            t.unpack(0, 3)

    def test_tuple_indexer(self):
        t = tnlp.NGramIndexerImpl()
        g = t.pack(("a", "b", "c"))
        assert g == tnlp.NGram(("a", "b", "c")) and t.ngram_order(g) == 3
        assert t.remove_farthest_word(g).words == ("b", "c")
        assert t.remove_current_word(g).words == ("a", "b")
        assert t.unpack(g, 1) == "b"

    def test_pack_and_unpack_pairs(self):
        pairs = [(tnlp.NGram(g), i + 1) for i, g in enumerate(self.NGRAMS)]
        arr = tnlp.pack_ngram_pairs(pairs)
        want = jnlp.pack_ngram_pairs([(jnlp.NGram(g.words), c) for g, c in pairs])
        np.testing.assert_array_equal(arr, want)
        assert arr.dtype == np.int64
        assert [(g.words, c) for g, c in tnlp.unpack_ngram_pairs(arr)] == \
            [(g.words, c) for g, c in pairs]


def _lm(n=400, seed=0, order=3, alpha=0.4):
    """Both packages' StupidBackoffPipeline models on the same sentences."""
    jm, jenc = jsb.run(jsb.StupidBackoffConfig(n=order, alpha=alpha, synthetic_n=n, seed=seed))
    tm, tenc = tsb.run(tsb.StupidBackoffConfig(n=order, alpha=alpha, synthetic_n=n, seed=seed))
    return jm, tm, jenc, tenc


def _queries(model, vocab, count=400, seed=1):
    rng = np.random.default_rng(seed)
    observed = list(model.ngram_counts)
    picked = [observed[i] for i in rng.choice(len(observed), count // 2, replace=False)]
    orders = rng.integers(1, 4, size=count - len(picked))
    return picked + [tnlp.NGram(tuple(int(w) for w in rng.integers(0, vocab, size=o)))
                     for o in orders]


class TestStupidBackoff:
    @pytest.mark.parametrize("order,alpha", [(2, 0.4), (3, 0.4), (3, 0.7)])
    def test_pipeline_scores_are_the_references(self, order, alpha):
        jm, tm, jenc, tenc = _lm(order=order, alpha=alpha)
        assert tenc.word_index == jenc.word_index
        want = {g.words: s for g, s in jm.scores.items()}
        got = {g.words: s for g, s in tm.scores.items()}
        assert got.keys() == want.keys()
        for key, s in got.items():
            assert abs(s - want[key]) <= 1e-12
            assert 0.0 < s <= 1.0
        assert tm.num_tokens == jm.num_tokens

    def test_queries_single_batch_and_sharded(self):
        jm, tm, _, tenc = _lm()
        queries = _queries(tm, len(tenc.word_index))
        want = [jm.score(jnlp.NGram(g.words)) for g in queries]
        single = [tm.score(g) for g in queries]
        batch = tm.batch_score(queries)
        assert single == pytest.approx(want, rel=0, abs=1e-12)
        np.testing.assert_array_equal(batch, np.array(single))
        parts = tnlp.partition_ngram_pairs(list(tm.ngram_counts.items()), 4)
        shards = [tnlp.StupidBackoffModel({}, dict(p), tm.indexer, tm.unigram_counts,
                                          tm.num_tokens, tm.alpha) for p in parts]
        sharded = tnlp.ShardedStupidBackoffModel.from_partitioned(shards)
        assert [sharded.score(g) for g in queries] == single
        packer = tnlp.NaiveBitPackIndexer()
        packed = np.array([packer.pack(g.words) for g in queries], dtype=np.int64)
        np.testing.assert_array_equal(sharded.batch_score_packed(packed), np.array(single))
        jparts = jnlp.partition_ngram_pairs(list(jm.ngram_counts.items()), 4)
        assert [sorted((g.words, c) for g, c in p) for p in parts] == \
            [sorted((g.words, c) for g, c in p) for p in jparts]

    def test_large_batches_take_the_sorted_path(self):
        # Over 4,096 queries the scorer sorts them first: the same scores.
        _, tm, _, tenc = _lm(n=2000)
        queries = _queries(tm, len(tenc.word_index), count=5000, seed=3)
        np.testing.assert_array_equal(tm.batch_score(queries),
                                      np.array([tm.score(g) for g in queries]))

    def test_sharded_overlap_is_refused(self):
        _, tm, _, _ = _lm()
        shard = tnlp.StupidBackoffModel({}, dict(tm.ngram_counts), tm.indexer,
                                        tm.unigram_counts, tm.num_tokens)
        for validate in (True, "full"):
            with pytest.raises(ValueError, match="overlap"):
                tnlp.ShardedStupidBackoffModel([shard, shard], validate=validate)

    def test_zero_context_raises_in_both_scorers(self):
        unigrams = {1: 3, 2: 5}
        counts = {tnlp.NGram((3, 4)): 2}  # its context (3) was never counted
        model = tnlp.StupidBackoffModel({}, counts, tnlp.NGramIndexerImpl(), unigrams, 8)
        with pytest.raises(ZeroDivisionError):
            model.score(tnlp.NGram((3, 4)))
        with pytest.raises(ZeroDivisionError):
            model.batch_score([(3, 4)])

    def test_model_is_not_chainable(self):
        _, tm, _, _ = _lm(n=20)
        with pytest.raises(NotImplementedError):
            tm.apply(None)


# ---------------------------------------------------------------------------
# NaiveBayes, LDA and NewsgroupsPipeline
# ---------------------------------------------------------------------------


def _counts(n=200, d=30, k=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    rates = rng.uniform(0.1, 3.0, size=(k, d))
    X = rng.poisson(rates[y]).astype(np.float64)
    return X, y


class TestNaiveBayesAndLDA:
    @pytest.mark.parametrize("lam", [1.0, 0.5])
    def test_naive_bayes_model(self, lam):
        X, y = _counts()
        j = jcls.NaiveBayesEstimator(4, lam).fit(JDataset(X), JDataset(y))
        t = tcls.NaiveBayesEstimator(4, lam).fit(TDataset(torch.from_numpy(X)),
                                                 TDataset(torch.from_numpy(y)))
        assert t.pi.dtype == t.theta.dtype == torch.float64
        np.testing.assert_allclose(_np(t.pi), np.asarray(j.pi), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.theta), np.asarray(j.theta), rtol=0, atol=1e-6)
        Xt = torch.from_numpy(X[:25])
        np.testing.assert_allclose(_np(t.batch_apply(TDataset(Xt)).array),
                                   np.asarray(j.batch_apply(JDataset(X[:25])).array),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.apply(Xt[0])), np.asarray(j.apply(X[0])), atol=1e-6)

    def test_naive_bayes_masks_padding_rows(self):
        X, y = _counts()
        X[180:], y[180:] = 0.0, 0
        j = jcls.NaiveBayesEstimator(4).fit(JDataset(X, n=180), JDataset(y, n=180))
        t = tcls.NaiveBayesEstimator(4).fit(TDataset(torch.from_numpy(X), n=180),
                                            TDataset(torch.from_numpy(y), n=180))
        np.testing.assert_allclose(_np(t.pi), np.asarray(j.pi), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.theta), np.asarray(j.theta), rtol=0, atol=1e-6)

    def test_naive_bayes_on_sparse_rows(self):
        docs = [{"a": 1.0, "b": 2.0}, {"b": 1.0, "c": 3.0}, {"a": 2.0}, {"c": 1.0}]
        from keystone_tpu.ops.sparse import AllSparseFeatures as JAll
        from keystone_tpu_torch.ops.sparse import AllSparseFeatures as TAll

        y = np.array([0, 1, 0, 1])
        jv = JAll().fit(JDataset(docs)).batch_apply(JDataset(docs))
        tv = TAll().fit(TDataset(docs)).batch_apply(TDataset(docs))
        j = jcls.NaiveBayesEstimator(2).fit(jv, JDataset(y))
        t = tcls.NaiveBayesEstimator(2).fit(tv, TDataset(torch.from_numpy(y)))
        assert t.theta.dtype == torch.float32
        np.testing.assert_allclose(_np(t.theta), np.asarray(j.theta), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.batch_apply(tv).array),
                                   np.asarray(j.batch_apply(jv).array), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("dims", [1, 3])
    def test_lda_projection(self, dims):
        rng = np.random.default_rng(5)
        y = rng.integers(0, 4, 300)
        X = rng.normal(size=(300, 6)) + 2.0 * rng.normal(size=(4, 6))[y]
        j = jcls.LinearDiscriminantAnalysis(dims).fit(JDataset(X), JDataset(y))
        t = tcls.LinearDiscriminantAnalysis(dims).fit(TDataset(torch.from_numpy(X)),
                                                      TDataset(torch.from_numpy(y)))
        want, got = np.asarray(j.x), _np(t.x)
        assert got.shape == want.shape == (6, dims)
        signs = np.sign(np.sum(got * want, axis=0))
        np.testing.assert_allclose(got * signs, want, rtol=0, atol=1e-6)


NEWS = dict(synthetic_n=240, synthetic_classes=6)


class TestNewsgroups:
    @pytest.mark.parametrize("n_grams", [1, 2])
    def test_errors_and_model(self, n_grams):
        jpipe, jtrain, jtest = jnews.run(jnews.NewsgroupsConfig(n_grams=n_grams, **NEWS))
        run = tnews.run(tnews.NewsgroupsConfig(n_grams=n_grams, **NEWS), device="cpu")
        assert run.train_eval.total == 240 and run.test_eval.total == 64
        assert run.train_eval.total_error == jtrain.total_error
        assert run.test_eval.total_error == jtest.total_error
        (jm,) = [o for o in jpipe.fit().transformer_graph.operators.values()
                 if isinstance(o, jcls.NaiveBayesModel)]
        (tm,) = [o for o in run.pipeline.fit().transformer_graph.operators.values()
                 if isinstance(o, tcls.NaiveBayesModel)]
        assert tm.theta.shape == jm.theta.shape
        np.testing.assert_allclose(_np(tm.pi), np.asarray(jm.pi), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(tm.theta), np.asarray(jm.theta), rtol=0, atol=1e-6)

    def test_log_term_frequency(self):
        tf = tnews.build_featurizer(tnews.NewsgroupsConfig())
        out = tf.apply(TDataset(["a b a", "  B c  "])).get().to_list()
        assert out[0][("a",)] == math.log1p(2) and out[0][("a", "b")] == math.log1p(1)
        assert ("b",) in out[1] and ("b", "c") in out[1]


class TestEntryPoints:
    def test_newsgroups_cli(self, capsys):
        trun.main(["NewsgroupsPipeline", "--device", "cpu", "--syntheticN", "80"])
        out = capsys.readouterr().out
        assert "TRAIN error is" in out and "TEST error is" in out

    def test_stupid_backoff_cli(self, capsys):
        trun.main(["StupidBackoffPipeline", "--syntheticN", "50", "--n", "2"])
        assert "ngrams" in capsys.readouterr().out.split("Scored")[1]

    def test_names_resolve(self):
        for name in ("NewsgroupsPipeline", "StupidBackoffPipeline"):
            assert callable(trun.resolve(name))
