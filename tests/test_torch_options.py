"""The reference modules no default route takes, ported: HOG and DAISY
(``ops/images/{hog,daisy}.py``), the streamed ZCA whitener
(``StreamedZCAWhitenerEstimator`` in ``ops/learning/pca.py``) and the
per-class weighted solvers (``ops/learning/rwls.py``), each against the
JAX package's. Twins of tests/test_rwls.py, the HOG and DAISY cases of
tests/test_images.py and tests/test_zca_stream.py, plus direct parity.

Inputs come from the reference tests' seeded numpy generators: float32
images and patches, float64 RWLS problems (the reference test runs them
in x64; the port keeps float64 tensors float64).

Tolerances:
  - HOG and DAISY against the reference: 1e-5 absolute (float32 sums in
    other orders: the histogram scatter-add, the blurs); the reference
    test's own bounds as they are;
  - streamed ZCA: means 1e-5, whitener and whitened rows 5e-3 against the
    batch estimator (covariance eigh against centred SVD, the reference
    test's); against the reference's streamed fit 1e-5 (means) and 5e-4
    (whitener: two float32 eigensolves); a resumed fit bit for bit;
  - RWLS: the reference tests' 1e-8 / 1e-6 / 1e-7 in float64; against the
    reference's estimator 1e-9 in float64.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data.shards import DiskDenseShards as JDiskDenseShards
from keystone_tpu.ops.images import DaisyExtractor as JDaisy
from keystone_tpu.ops.images import HogExtractor as JHog
from keystone_tpu.ops.learning import pca as jpca
from keystone_tpu.ops.learning import rwls as jrwls
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data.durable import CheckpointSpec
from keystone_tpu_torch.data.prefetch import ShardSource
from keystone_tpu_torch.data.shards import DiskDenseShards
from keystone_tpu_torch.ops.images import DaisyExtractor, HogExtractor
from keystone_tpu_torch.ops.learning import pca as tpca
from keystone_tpu_torch.ops.learning.rwls import (
    PerClassWeightedLeastSquaresEstimator,
    ReWeightedLeastSquaresSolver,
)
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def rand_image(rng, x=10, y=12, c=3):
    return rng.random((x, y, c)).astype(np.float32)


# ---------------------------------------------------------------------------
# HOG and DAISY (tests/test_images.py:173-195)
# ---------------------------------------------------------------------------


class TestExtractors:
    def test_hog_shape_and_bounds(self):
        img = rand_image(np.random.default_rng(10), 24, 24, 3)
        feats = HogExtractor(bin_size=4).apply(_t(img)).numpy()
        assert feats.shape == (16, 32)  # 6 x 6 cells -> 4 x 4 feature cells
        assert np.all(feats >= 0.0)
        assert np.all(feats[:, :18] <= 0.4 + 1e-6)  # 0.5 * 4 * clip(0.2)
        np.testing.assert_allclose(feats[:, 31], 0.0)
        assert feats.sum() > 0
        np.testing.assert_allclose(feats, np.asarray(JHog(bin_size=4).apply(img)), atol=1e-5)

    def test_hog_flat_image_is_zero(self):
        img = np.full((16, 16, 3), 0.5, dtype=np.float32)
        np.testing.assert_allclose(HogExtractor(bin_size=4).apply(_t(img)).numpy(), 0.0,
                                   atol=1e-5)

    @pytest.mark.parametrize("bin_size,shape", [(4, (37, 41, 3)), (6, (30, 44, 1)),
                                                (8, (12, 12, 3))])
    def test_hog_batch_against_the_reference(self, bin_size, shape):
        imgs = np.random.default_rng(20).random((3,) + shape).astype(np.float32)
        got = HogExtractor(bin_size).batch_apply(TDataset(_t(imgs)))
        want = np.asarray(JHog(bin_size).batch_apply(JDataset.of(imgs)).array)
        assert got.n == 3 and tuple(got.array.shape) == want.shape
        np.testing.assert_allclose(got.array.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(HogExtractor(bin_size).apply(_t(imgs[1])).numpy(), want[1],
                                   atol=1e-5)

    def test_daisy_shape_and_normalization(self):
        img = rand_image(np.random.default_rng(11), 40, 44, 1)
        d = DaisyExtractor()
        feats = d.apply(_t(img)).numpy()
        nx, ny = len(range(16, 40 - 16, 4)), len(range(16, 44 - 16, 4))
        assert feats.shape == (d.H * (d.T * d.Q + 1), nx * ny)
        assert np.all(np.linalg.norm(feats[: d.H, :], axis=0) < 1.0 + 1e-4)
        np.testing.assert_allclose(feats, np.asarray(JDaisy().apply(img)), atol=1e-5)

    def test_daisy_batch_against_the_reference(self):
        imgs = np.random.default_rng(21).random((2, 48, 52, 3)).astype(np.float32)
        ext, jext = DaisyExtractor(daisy_t=6, daisy_q=2, daisy_h=4), JDaisy(6, 2, 7, 4)
        got = ext.batch_apply(TDataset(_t(imgs)))
        want = np.asarray(jext.batch_apply(JDataset.of(imgs)).array)
        assert tuple(got.array.shape) == want.shape == (2, 4 * 13, 4 * 5)
        np.testing.assert_allclose(got.array.numpy(), want, atol=1e-5)
        np.testing.assert_array_equal(ext.offsets, jext.offsets)


# ---------------------------------------------------------------------------
# Streamed ZCA (tests/test_zca_stream.py)
# ---------------------------------------------------------------------------


def _zca_problem(tmp_path, n=700, d=12, tile=64, tps=2, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) * 2.0 + 0.5
    Y = np.zeros((n, 1), dtype=np.float32)
    shards = DiskDenseShards.write(str(tmp_path / "dense"), X, Y, tile_rows=tile,
                                   tiles_per_segment=tps)
    return X, shards


def _zca(**kw):
    return tpca.StreamedZCAWhitenerEstimator(device="cpu", **kw)


class TestStreamedParity:
    def test_matches_batch_estimator(self, tmp_path):
        X, shards = _zca_problem(tmp_path)
        batch = tpca.ZCAWhitenerEstimator(eps=0.1).fit_single(_t(X))
        streamed = _zca(eps=0.1).fit_source(shards.as_source())
        np.testing.assert_allclose(streamed.means.numpy(), batch.means.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(streamed.whitener.numpy(), batch.whitener.numpy(),
                                   rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(streamed.apply(_t(X[:50])).numpy(),
                                   batch.apply(_t(X[:50])).numpy(), rtol=5e-3, atol=5e-3)

    def test_against_the_reference_streamed_fit(self, tmp_path):
        X, shards = _zca_problem(tmp_path, seed=8)
        jshards = JDiskDenseShards(shards.directory)  # the reference reads the port's shards
        want = jpca.StreamedZCAWhitenerEstimator(eps=0.1).fit_source(jshards.as_source())
        got = _zca(eps=0.1).fit_source(shards.as_source())
        np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), atol=1e-5)
        np.testing.assert_allclose(got.whitener.numpy(), np.asarray(want.whitener), atol=5e-4)

    def test_resident_dataset_falls_back_to_batch_path(self):
        X = np.random.default_rng(0).normal(size=(80, 6)).astype(np.float32)
        got = _zca(eps=0.2).fit(TDataset(_t(X)))
        want = tpca.ZCAWhitenerEstimator(eps=0.2).fit_single(_t(X))
        np.testing.assert_array_equal(got.whitener.numpy(), want.whitener.numpy())

    def test_too_few_rows_raises(self):
        with pytest.raises(ValueError, match="n >= 2"):
            _zca()._finalize(torch.zeros(3), torch.zeros(3, 3), 1)

    def test_shard_backed_dataset_view_ignores_pad_rows(self, tmp_path):
        X, shards = _zca_problem(tmp_path, n=700, d=12, tile=64, tps=2)
        labeled = shards.as_labeled_data()
        view = labeled.data.shard_source
        padded = sum(view.load(s).shape[0] for s in range(view.num_segments))
        assert padded > view.n_true  # the fixture really has pad rows
        got = _zca(eps=0.1).fit(labeled.data)
        want = tpca.ZCAWhitenerEstimator(eps=0.1).fit_single(_t(X))
        np.testing.assert_allclose(got.means.numpy(), want.means.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.whitener.numpy(), want.whitener.numpy(), rtol=5e-3,
                                   atol=5e-3)

    def test_fit_source_loads_each_segment_exactly_once(self, tmp_path):
        X, shards = _zca_problem(tmp_path, n=200, d=6, tile=32, tps=2)
        inner = shards.as_source()
        calls = []

        class Counting(ShardSource):
            num_segments = inner.num_segments
            n_true = inner.n_true
            d_in = inner.d_in

            def load(self, s):
                calls.append(s)
                return inner.load(s)

        got = _zca(eps=0.1, prefetch_depth=0).fit_source(Counting())
        assert sorted(calls) == list(range(inner.num_segments))
        want = tpca.ZCAWhitenerEstimator(eps=0.1).fit_single(_t(X))
        np.testing.assert_allclose(got.whitener.numpy(), want.whitener.numpy(), rtol=5e-3,
                                   atol=5e-3)

    def test_fit_source_falls_back_to_load0_without_metadata(self, tmp_path):
        X, shards = _zca_problem(tmp_path, n=150, d=5, tile=32, tps=2)
        inner = shards.as_source()

        class Bare(ShardSource):
            num_segments = inner.num_segments
            n_true = inner.n_true

            def load(self, s):
                return inner.load(s)

        got = _zca(eps=0.1, prefetch_depth=0).fit_source(Bare())
        want = tpca.ZCAWhitenerEstimator(eps=0.1).fit_single(_t(X))
        np.testing.assert_allclose(got.whitener.numpy(), want.whitener.numpy(), rtol=5e-3,
                                   atol=5e-3)

    def test_entry_point_needs_a_device(self, tmp_path, monkeypatch):
        _, shards = _zca_problem(tmp_path, n=100, d=4)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpca.StreamedZCAWhitenerEstimator().fit_source(shards.as_source())


@pytest.mark.chaos
class TestZCAKillResume:
    def test_killed_and_resumed_bit_identical(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KEYSTONE_RETRY_BASE_S", "0.001")
        X, shards = _zca_problem(tmp_path)
        assert shards.num_segments >= 5

        def fit(**kw):
            return _zca(eps=0.1, **kw).fit_source(shards.as_source())

        ref = fit()
        ck = CheckpointSpec(str(tmp_path / "ck"), every_segments=2)
        # Exhaust the 3-attempt retry budget on a mid-run segment load.
        with FaultPlan([FaultRule("prefetch.read", "error", calls=[4, 5, 6])]):
            with pytest.raises(OSError):
                fit(checkpoint=ck)
        assert ck.has_snapshot(), "the killed ZCA fit left no snapshot to resume from"
        resumed = fit(checkpoint=ck)
        np.testing.assert_array_equal(ref.means.numpy(), resumed.means.numpy())
        np.testing.assert_array_equal(ref.whitener.numpy(), resumed.whitener.numpy())
        assert not ck.has_snapshot()  # completion cleared it


# ---------------------------------------------------------------------------
# RWLS (tests/test_rwls.py)
# ---------------------------------------------------------------------------


def _closed_form(X, mu, w, Y_zm, lam):
    Xzm = X - mu[None, :]
    G = Xzm.T @ (Xzm * w[:, None])
    return np.linalg.solve(G + lam * np.eye(X.shape[1]), Xzm.T @ (Y_zm * w[:, None]))


class TestReWeightedLS:
    def test_single_block_exact(self):
        rng = np.random.default_rng(0)
        n, d, k = 60, 8, 3
        X, Y = rng.normal(size=(n, d)), rng.normal(size=(n, k))
        w = rng.uniform(0.1, 2.0, size=n)
        mu, lam = X.mean(axis=0), 1e-2
        models, residual = ReWeightedLeastSquaresSolver.train_with_l2([_t(X)], _t(Y), w, mu,
                                                                       lam, num_iter=1)
        W_ref = _closed_form(X, mu, w, Y, lam)
        np.testing.assert_allclose(models[0].numpy(), W_ref, atol=1e-8)
        np.testing.assert_allclose(residual.numpy(), w[:, None] * ((X - mu) @ W_ref), atol=1e-8)

    def test_multi_block_converges_to_exact(self):
        rng = np.random.default_rng(1)
        n, d, k = 80, 12, 2
        X, Y = rng.normal(size=(n, d)), rng.normal(size=(n, k))
        w = rng.uniform(0.2, 1.5, size=n)
        mu, lam = X.mean(axis=0), 1e-1
        blocks = [_t(X[:, :4]), _t(X[:, 4:8]), _t(X[:, 8:])]
        models, _ = ReWeightedLeastSquaresSolver.train_with_l2(blocks, _t(Y), w, mu, lam,
                                                               num_iter=60)
        W = torch.cat(models).numpy()
        np.testing.assert_allclose(W, _closed_form(X, mu, w, Y, lam), atol=1e-6)
        want, _ = jrwls.ReWeightedLeastSquaresSolver.train_with_l2(
            [X[:, :4], X[:, 4:8], X[:, 8:]], Y, w, mu, lam, num_iter=60)
        np.testing.assert_allclose(W, np.concatenate([np.asarray(m) for m in want]), atol=1e-9)


def _pcwls_reference(X, Y, block_size, num_iter, lam, mw):
    """The reference's per-class driver, literally: for each class, the
    weighted solver with that class's weights, mixed feature mean and
    zero-meaned labels (PerClassWeightedLeastSquares.scala:63-121)."""
    n, d = X.shape
    k = Y.shape[1]
    cls = Y.argmax(axis=1)
    counts = np.bincount(cls, minlength=k)
    pop_mean = X.mean(axis=0)
    jlm = (counts / n) * 2.0 * (1.0 - mw) - 1.0 + 2.0 * mw
    blocks = [_t(X[:, s:s + block_size]) for s in range(0, d, block_size)]
    W_cols, bias = [], []
    for c in range(k):
        class_mean = X[cls == c].mean(axis=0) if counts[c] else np.zeros(d)
        jfm_c = mw * class_mean + (1 - mw) * pop_mean if counts[c] else pop_mean
        w_c = np.full(n, (1.0 - mw) / n)
        if counts[c]:
            w_c[cls == c] += mw / counts[c]
        y_zm = _t((Y[:, c] - jlm[c])[:, None])
        models, _ = ReWeightedLeastSquaresSolver.train_with_l2(blocks, y_zm, w_c, jfm_c, lam,
                                                               num_iter)
        W_c = torch.cat(models)[:, 0].numpy()
        W_cols.append(W_c)
        bias.append(jlm[c] - jfm_c @ W_c)
    return np.stack(W_cols, axis=1), np.asarray(bias)


def _weights(model):
    return torch.cat([x.cpu() for x in model.xs]).numpy(), model.b_opt.cpu().numpy()


class TestPerClassWeightedLS:
    @pytest.mark.parametrize("num_iter", [1, 3])
    def test_matches_per_class_reference_structure(self, num_iter):
        rng = np.random.default_rng(2)
        n, d, k = 48, 8, 4
        X = rng.normal(size=(n, d))
        Y = 2.0 * np.eye(k)[rng.integers(0, k, size=n)] - 1.0
        lam, mw = 1e-2, 0.4
        W, b = _weights(PerClassWeightedLeastSquaresEstimator(4, num_iter, lam, mw).fit(
            TDataset(_t(X)), TDataset(_t(Y))))
        W_ref, b_ref = _pcwls_reference(X, Y, 4, num_iter, lam, mw)
        np.testing.assert_allclose(W, W_ref, atol=1e-7)
        np.testing.assert_allclose(b, b_ref, atol=1e-7)
        jm = jrwls.PerClassWeightedLeastSquaresEstimator(4, num_iter, lam, mw).fit(
            JDataset.of(X), JDataset.of(Y))
        np.testing.assert_allclose(W, np.concatenate([np.asarray(x) for x in jm.xs]), atol=1e-9)
        np.testing.assert_allclose(b, np.asarray(jm.b_opt), atol=1e-9)

    def test_absent_class_is_finite(self):
        rng = np.random.default_rng(3)
        n, d, k = 32, 6, 5
        X = rng.normal(size=(n, d))
        Y = 2.0 * np.eye(k)[rng.integers(0, k - 1, size=n)] - 1.0  # class k-1 absent
        model = PerClassWeightedLeastSquaresEstimator(6, 2, 1e-2, 0.5).fit(TDataset(_t(X)),
                                                                          TDataset(_t(Y)))
        preds = model.batch_apply(TDataset(_t(X))).array.numpy()
        assert np.isfinite(preds).all()
        jm = jrwls.PerClassWeightedLeastSquaresEstimator(6, 2, 1e-2, 0.5).fit(
            JDataset.of(X), JDataset.of(Y))
        np.testing.assert_allclose(preds, np.asarray(jm.batch_apply(JDataset.of(X)).array),
                                   atol=1e-9)

    def test_classifies_separable_data(self):
        rng = np.random.default_rng(4)
        n, d, k = 120, 10, 3
        centers = rng.normal(size=(k, d)) * 4.0
        labels = rng.integers(0, k, size=n)
        X = centers[labels] + rng.normal(size=(n, d))
        Y = 2.0 * np.eye(k)[labels] - 1.0
        model = PerClassWeightedLeastSquaresEstimator(5, 3, 1e-3, 0.5).fit(TDataset(_t(X)),
                                                                          TDataset(_t(Y)))
        preds = model.batch_apply(TDataset(_t(X))).array.numpy()
        assert (preds.argmax(axis=1) == labels).mean() > 0.95

    def test_float32_more_classes_than_a_chunk(self):
        # 20 classes: a full chunk of 16 and a padded one of 4 (VOC's count).
        rng = np.random.default_rng(5)
        n, d, k = 400, 24, 20
        X = rng.normal(size=(n, d)).astype(np.float32)
        Y = (2.0 * np.eye(k)[rng.integers(0, k, size=n)] - 1.0).astype(np.float32)
        W, b = _weights(PerClassWeightedLeastSquaresEstimator(8, 2, 1e-1, 0.3).fit(
            TDataset(_t(X)), TDataset(_t(Y))))
        jm = jrwls.PerClassWeightedLeastSquaresEstimator(8, 2, 1e-1, 0.3).fit(
            JDataset.of(jnp.asarray(X)), JDataset.of(jnp.asarray(Y)))
        want = np.concatenate([np.asarray(x) for x in jm.xs])
        assert np.linalg.norm(W - want) / np.linalg.norm(want) < 1e-4
        np.testing.assert_allclose(b, np.asarray(jm.b_opt), atol=1e-5)

    def test_weight_property(self):
        assert PerClassWeightedLeastSquaresEstimator(4, 3, 1e-2, 0.5).weight == 10
