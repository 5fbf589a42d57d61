"""The port's image featurizers and Fisher-vector chain against the JAX
package, on the CPU: the image filters of ``utils/images.py``, dense SIFT,
LCS, Fisher vectors and their estimators, the normalization nodes, the
vectorizer, the label indicators, top-k and the mean average precision.

Inputs are numpy-seeded. Tolerances and why:
  - filters, LCS: 1e-5 absolute on pixels in [0, 1] (float32 sums in other
    orders: XLA's convolutions against PyTorch's).
  - SIFT: before quantization, 1e-5 absolute on each normalized, clipped
    descriptor entry v (the reference's ``floor`` replaced by the identity
    on the descriptor matrix only); after it,
    ⌊512·v⌋ turns a last-bit difference into one step, so no entry is more
    than one step off and at most 0.1% of the entries differ (the
    reference's own suite allows 0.5% off by more than one,
    tests/test_sift_fv_golden.py).
  - Fisher vectors: 1e-5 absolute in float32 (both encode in float64
    against a float64 GMM and round to float32).
  - NormalizeRows, SignedHellingerMapper, MatrixVectorizer, FloatToDouble,
    mean average precision: 1e-6.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator as TMAP
from keystone_tpu_torch.ops import stats as t_stats
from keystone_tpu_torch.ops import util as t_util
from keystone_tpu_torch.ops.images import fisher as t_fisher
from keystone_tpu_torch.ops.images import lcs as t_lcs
from keystone_tpu_torch.ops.images import sift as t_sift
from keystone_tpu_torch.utils import images as t_images

import jax
import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.evaluation import MeanAveragePrecisionEvaluator as JMAP
from keystone_tpu.ops import stats as j_stats
from keystone_tpu.ops import util as j_util
from keystone_tpu.ops.images import fisher as j_fisher
from keystone_tpu.ops.images import lcs as j_lcs
from keystone_tpu.ops.images import sift as j_sift
from keystone_tpu.ops.learning import clustering as j_clu
from keystone_tpu.utils import images as j_images

ATOL = 1e-5
FV_ATOL = 1e-5
NODE_ATOL = 1e-6


def _images(n, size=48, channels=3, seed=0):
    return np.random.default_rng(seed).random((n, size, size, channels)).astype(np.float32)


def _textures(n, size=48, seed=0):
    """Smooth oriented textures plus noise, in [0, 1]: images with real
    gradients (and low-contrast corners) for SIFT."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = []
    for _ in range(n):
        f = rng.uniform(0.2, 1.5, size=2)
        img = 0.5 + 0.35 * np.sin(f[0] * xx + f[1] * yy) + 0.08 * rng.normal(size=(size, size))
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)[..., None].repeat(3, axis=-1)


class TestImageFilters:
    @pytest.mark.parametrize("fx,fy", [
        (np.ones(4), np.ones(4)),  # even: the same-size pad is 1 before, 2 after
        (np.arange(5.0), np.array([1.0, 2.0, 3.0])),  # asymmetric: convolution flips
        (np.full(6, 1 / 6), np.full(6, 1 / 6)),
    ])
    def test_separable_conv2d_same(self, fx, fy):
        img = _images(1, 13)[0][:, :11]
        want = np.asarray(j_images.separable_conv2d_same(img, fx, fy))
        got = t_images.separable_conv2d_same(torch.from_numpy(img), fx, fy).numpy()
        assert got.shape == want.shape == img.shape
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("sigma", [0.0, 0.5, 4 / 6, 10 / 6])
    def test_gaussian_blur(self, sigma):
        img = _images(1, 17, seed=1)[0]
        want = np.asarray(j_images.gaussian_blur(img, sigma))
        got = t_images.gaussian_blur(torch.from_numpy(img), sigma).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_batched_filters_match_one_image(self):
        batch = _images(6, 15, channels=2, seed=2).reshape(2, 3, 15, 15, 2)
        blurred = t_images.gaussian_blur(torch.from_numpy(batch), 1.0).numpy()
        boxed = t_images.separable_conv2d_same(torch.from_numpy(batch), np.ones(3),
                                               np.ones(3)).numpy()
        for i, j in ((0, 0), (1, 2)):
            np.testing.assert_allclose(blurred[i, j],
                                       np.asarray(j_images.gaussian_blur(batch[i, j], 1.0)),
                                       atol=ATOL)
            np.testing.assert_allclose(
                boxed[i, j], np.asarray(j_images.separable_conv2d_same(
                    batch[i, j], np.ones(3), np.ones(3))), atol=ATOL)

    def test_conv2d_valid(self):
        img = _images(1, 12, seed=3)[0]
        kernel = np.random.default_rng(4).random((3, 4)).astype(np.float32)
        want = np.asarray(j_images.conv2d_valid(img, kernel))
        got = t_images.conv2d_valid(torch.from_numpy(img), kernel).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("shape", [(50, 37, 3), (48, 48, 1), (7, 20, 3), (5, 6, 2)])
    def test_crop_to_multiple(self, shape):
        img = np.random.default_rng(5).random(shape)
        np.testing.assert_array_equal(t_images.crop_to_multiple(img),
                                      j_images.crop_to_multiple(img))


class _UnquantizedJnp:
    """jax.numpy with ``floor`` the identity on a (descriptors, 128) matrix:
    the reference's SIFT before its ⌊512·v⌋, everything else unchanged."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def floor(x):
        return x if x.ndim == 2 and x.shape[1] == 128 else jnp.floor(x)


class TestSIFT:
    SCALES = [(4, 3), (6, 4), (8, 5), (10, 6), (6, 3)]  # (bin, step)

    @pytest.mark.parametrize("bin_size,step", SCALES)
    def test_unquantized_descriptors(self, monkeypatch, bin_size, step):
        imgs = _textures(3, seed=bin_size)
        gray = np.array(jax.vmap(lambda im: j_images.to_grayscale(im)[:, :, 0])(imgs))
        monkeypatch.setattr(j_sift, "jnp", _UnquantizedJnp())
        want = np.stack([np.asarray(j_sift._scale_descriptors(jnp.asarray(g), bin_size, step))
                         for g in gray]) / 512.0
        got = torch.clamp_max(t_sift._scale_values(torch.from_numpy(gray), bin_size, step),
                              255.0).numpy() / 512.0
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("scale_step", [1, 2])
    def test_quantized_descriptors(self, scale_step):
        imgs = _textures(4, seed=10 + scale_step)
        want = np.asarray(j_sift.SIFTExtractor(scale_step=scale_step).batch_apply(
            JDataset(imgs)).array)
        got = t_sift.SIFTExtractor(scale_step=scale_step).batch_apply(
            TDataset(torch.from_numpy(imgs))).array.numpy()
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 1e-3
        assert want.max() <= 255 and (want > 0).mean() > 0.3

    def test_per_image_and_chunks(self, monkeypatch):
        imgs = _textures(5, seed=20)
        monkeypatch.setattr(t_sift, "SIFT_CHUNK_IMAGES", 2)
        ext = t_sift.SIFTExtractor()
        batch = ext.batch_apply(TDataset(torch.from_numpy(imgs))).array
        np.testing.assert_array_equal(ext.apply(torch.from_numpy(imgs[3])).numpy(),
                                      batch[3].numpy())
        gray = t_images.to_grayscale(torch.from_numpy(imgs[1]))[:, :, 0]
        np.testing.assert_array_equal(ext.apply(gray).numpy(), batch[1].numpy())
        host = ext.batch_apply(TDataset([torch.from_numpy(im) for im in imgs[:2]]))
        np.testing.assert_array_equal(np.stack(host.to_list()), batch[:2].numpy())

    def test_descriptor_count(self):
        # 64 x 64: 289 + 121 + 64 + 25 keypoints over the four scales.
        out = t_sift.SIFTExtractor().apply(torch.zeros(64, 64))
        assert out.shape == (128, 499) and not out.any()  # no contrast: zeroed


class TestLCS:
    @pytest.mark.parametrize("stride,start,patch", [(4, 16, 6), (3, 10, 5), (5, 12, 4)])
    def test_matches(self, stride, start, patch):
        imgs = _images(3, seed=stride)
        want = np.asarray(j_lcs.LCSExtractor(stride, start, patch).batch_apply(
            JDataset(imgs)).array)
        ext = t_lcs.LCSExtractor(stride, start, patch)
        got = ext.batch_apply(TDataset(torch.from_numpy(imgs))).array.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(ext.apply(torch.from_numpy(imgs[1])).numpy(), want[1],
                                   atol=ATOL)

    def test_border_check(self):
        with pytest.raises(ValueError):
            t_lcs.LCSExtractor(4, 9, 6)


def _descriptor_sets(n, d, cols, seed):
    """(n, d, cols) float32 descriptors drawn around three centres."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(3, d))
    pick = rng.integers(0, 3, size=(n, cols))
    return (centres[pick] + rng.normal(size=(n, cols, d))).transpose(0, 2, 1).astype(np.float32)


class TestFisher:
    def test_encode_against_the_reference_gmm(self):
        train = _descriptor_sets(6, 5, 40, 0)
        cols = train.transpose(0, 2, 1).reshape(-1, 5).astype(np.float64)
        gmm = j_clu.GaussianMixtureModelEstimator(3, seed=0).fit_array(cols)
        params = {"gmm": {"means": np.asarray(gmm.means), "variances": np.asarray(gmm.variances),
                          "weights": np.asarray(gmm.weights)}}
        fv = interop.params_from_jax(params, device="cpu")
        assert isinstance(fv, t_fisher.FisherVector)
        test = _descriptor_sets(4, 5, 30, 1)
        want = np.asarray(j_fisher.FisherVector(gmm).batch_apply(JDataset(test)).array)
        got = fv.batch_apply(TDataset(torch.from_numpy(test))).array
        assert got.dtype == torch.float32 and got.shape == (4, 5, 6)
        np.testing.assert_allclose(got.numpy(), want, atol=FV_ATOL)
        np.testing.assert_allclose(fv.apply(torch.from_numpy(test[2])).numpy(), want[2],
                                   atol=FV_ATOL)

    def test_estimator(self, monkeypatch):
        train = _descriptor_sets(8, 4, 50, 2)
        test = _descriptor_sets(3, 4, 20, 3)
        want_fv = j_fisher.ScalaGMMFisherVectorEstimator(3, gmm_seed=1).fit(
            JDataset.of(list(train)))
        est = t_fisher.GMMFisherVectorEstimator(3, gmm_seed=1)
        assert est.optimize(TDataset(torch.from_numpy(train[:2]))) is est.default
        monkeypatch.setattr(t_fisher, "FISHER_CHUNK_ITEMS", 2)
        for data in (TDataset(torch.from_numpy(train)),
                     TDataset([torch.from_numpy(m) for m in train])):
            fv = est.fit(data)
            assert est.default.gmm_estimator.restarts == 0
            for name in ("means", "variances", "weights"):
                np.testing.assert_allclose(getattr(fv.gmm, name).numpy(),
                                           np.asarray(getattr(want_fv.gmm, name)), rtol=1e-6)
            want = np.asarray(want_fv.batch_apply(JDataset(test)).array)
            got = fv.batch_apply(TDataset(torch.from_numpy(test))).array.numpy()
            np.testing.assert_allclose(got, want, atol=FV_ATOL)


class TestNodes:
    def _rows(self, shape, seed=0):
        return np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def test_normalize_rows(self):
        X = self._rows((7, 33))
        X[3] = 0.0
        want = np.asarray(j_stats.NormalizeRows().device_fn()(jnp.asarray(X)))
        got = t_stats.NormalizeRows().device_fn()(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, atol=NODE_ATOL)
        np.testing.assert_allclose(t_stats.NormalizeRows().apply(X[1]).numpy(), want[1],
                                   atol=NODE_ATOL)

    def test_signed_hellinger(self):
        X = self._rows((5, 12), 1)
        want = np.asarray(j_stats.SignedHellingerMapper().device_fn()(jnp.asarray(X)))
        got = t_stats.SignedHellingerMapper().device_fn()(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, atol=NODE_ATOL)
        np.testing.assert_allclose(t_stats.SignedHellingerMapper().apply(X[0]).numpy(), want[0],
                                   atol=NODE_ATOL)

    def test_matrix_vectorizer_is_column_major(self):
        X = self._rows((4, 3, 5), 2)
        want = np.asarray(j_util.MatrixVectorizer().device_fn()(jnp.asarray(X)))
        got = t_util.MatrixVectorizer().device_fn()(torch.from_numpy(X)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], X[0].T.reshape(-1))
        np.testing.assert_array_equal(t_util.MatrixVectorizer().apply(X[2]).numpy(), want[2])

    @pytest.mark.parametrize("strict", [False, True])
    def test_float_to_double(self, strict):
        X = self._rows((3, 4), 3)
        want = np.asarray(j_util.FloatToDouble(strict).device_fn()(jnp.asarray(X)))
        got = t_util.FloatToDouble(strict).device_fn()(torch.from_numpy(X))
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_fv_chain_fuses_to_the_reference(self):
        X = self._rows((6, 4, 8), 4)
        j_nodes = [j_util.FloatToDouble(), j_util.MatrixVectorizer(), j_stats.NormalizeRows(),
                   j_stats.SignedHellingerMapper(), j_stats.NormalizeRows()]
        t_nodes = [t_util.FloatToDouble(), t_util.MatrixVectorizer(), t_stats.NormalizeRows(),
                   t_stats.SignedHellingerMapper(), t_stats.NormalizeRows()]
        want, got = jnp.asarray(X), torch.from_numpy(X)
        for j, t in zip(j_nodes, t_nodes):
            want, got = j.device_fn()(want), t.device_fn()(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NODE_ATOL)

    def test_label_indicators_from_arrays(self):
        labels = [np.array([0, 3]), np.array([2]), np.array([1, 2, 4])]
        want = np.asarray(j_util.ClassLabelIndicatorsFromIntArrayLabels(5).batch_apply(
            JDataset.of(labels)).array)
        got = t_util.ClassLabelIndicatorsFromIntArrayLabels(5).batch_apply(
            TDataset.of(labels)).array
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        with pytest.raises(ValueError):
            t_util.ClassLabelIndicatorsFromIntArrayLabels(5).apply(np.array([5]))
        with pytest.raises(ValueError):
            t_util.ClassLabelIndicatorsFromIntArrayLabels(1)

    @pytest.mark.parametrize("k", [1, 3, 9])
    def test_top_k(self, k):
        X = self._rows((6, 7), 5)
        want = np.asarray(j_util.TopKClassifier(k).batch_apply(JDataset(X)).array)
        got = t_util.TopKClassifier(k).batch_apply(TDataset(torch.from_numpy(X))).array.numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_util.TopKClassifier(k).apply(X[4]).numpy(), want[4])


class TestMeanAveragePrecision:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches(self, seed):
        rng = np.random.default_rng(seed)
        n, c = 40, 6
        scores = rng.normal(size=(n, c)).astype(np.float32)
        scores[5, :] = scores[6, :]  # ties keep the stable order
        labels = [np.sort(rng.choice(c, size=rng.integers(1, 3), replace=False))
                  for _ in range(n)]
        want = np.asarray(JMAP(c).evaluate(JDataset(scores), JDataset.of(labels)))
        got = TMAP(c).evaluate(TDataset(torch.from_numpy(scores)), TDataset.of(labels))
        np.testing.assert_allclose(got, want, atol=NODE_ATOL)
        assert got.shape == (c,)

    def test_class_without_positives_scores_zero(self):
        scores = np.array([[0.9, 0.1, 0.0], [0.2, 0.8, 0.1]], dtype=np.float32)
        labels = [np.array([0]), np.array([1])]
        got = TMAP(3).evaluate(TDataset(torch.from_numpy(scores)), TDataset.of(labels))
        np.testing.assert_allclose(got, [1.0, 1.0, 0.0])
