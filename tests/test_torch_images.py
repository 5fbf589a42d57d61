"""The port's image nodes (keystone_tpu_torch/ops/images/, utils/images.py,
ops/cuda_images.py, ops/learning/pca.py's ZCA) against the JAX package.

Inputs are numpy draws from a seeded generator, float32 on both sides
(tests/conftest.py turns on x64, so the reference would otherwise compute
float64 images in float64). The featurizer's kernel is held against the
reference's Pallas kernel in interpret mode and against its XLA branch;
on the CPU the port's wrapper computes its plain version.

Tolerances, with their reasons:
  - data movement (im2col, patches, crops, flips, windows, the rectifier,
    max pooling): exact;
  - reductions in float32 (patch normalisation, sum pooling, the filter
    product): rtol 1e-5, atol 1e-5 — the two packages sum in different
    orders, each term rounded at 2**-24;
  - the ZCA whitener: atol 1e-4 on entries of order 1 — two float32 SVDs
    of a 300 x 108 sample agree to about 1e-6 of the largest singular
    value, and the whitener scales that by at most (s² + ε)^-1/2 ≤ 3.2.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_images
from keystone_tpu_torch.ops.images import conv as tconv
from keystone_tpu_torch.ops.images import core as tcore
from keystone_tpu_torch.ops.learning.pca import ZCAWhitenerEstimator as TZCA
from keystone_tpu_torch.utils import images as timg

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops import pallas_images
from keystone_tpu.ops.images import conv as jconv
from keystone_tpu.ops.images import core as jcore
from keystone_tpu.ops.learning.pca import ZCAWhitenerEstimator as JZCA
from keystone_tpu.utils import images as jimg


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images(shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


# (n, X, Y, C, p, k): ragged sizes as tests/test_pallas_images.py has them,
# one with two filter passes of the kernel (k > 128), and CIFAR's own.
CONV_SHAPES = [(3, 12, 10, 3, 5, 5), (2, 9, 9, 2, 3, 4), (2, 12, 11, 3, 6, 130),
               (2, 32, 32, 3, 6, 100)]


def _xla_branch(images, filters, means, *, patch_size, normalize_patches):
    patches = jconv.im2col(jnp.asarray(images, jnp.float32), patch_size)
    if normalize_patches:
        patches = jconv.normalize_patch_rows(patches, 10.0)
    if means is not None:
        patches = patches - jnp.asarray(means, jnp.float32)
    return np.asarray(jnp.einsum("nxyd,kd->nxyk", patches, jnp.asarray(filters, jnp.float32),
                                 preferred_element_type=jnp.float32))


class TestPatches:
    @pytest.mark.parametrize("shape,p", [((3, 12, 10, 3), 5), ((2, 9, 9, 2), 3),
                                         ((1, 4, 4, 3), 2), ((2, 32, 32, 3), 6)])
    def test_im2col(self, shape, p):
        images = _images(shape)
        want = np.asarray(jconv.im2col(jnp.asarray(images), p))
        got = _np(tconv.im2col(_t(images), p))
        np.testing.assert_array_equal(got, want)

    def test_normalize_patch_rows(self):
        patches = _images((4, 5, 6, 75), seed=1) * 30 + 100
        want = np.asarray(jconv.normalize_patch_rows(jnp.asarray(patches), 10.0))
        got = _np(tconv.normalize_patch_rows(_t(patches), 10.0))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_random_patcher_takes_the_same_patches(self):
        images = _images((7, 12, 11, 3), seed=2)
        want = np.asarray(jcore.RandomPatcher(3, 5, 4, seed=19).batch_apply(
            JDataset.of(images)).array)
        got = tcore.RandomPatcher(3, 5, 4, seed=19).batch_apply(TDataset(_t(images)))
        assert got.n == 21
        np.testing.assert_array_equal(_np(got.array), want)
        single = tcore.RandomPatcher(3, 5, 4, seed=19).apply(_t(images[0]))
        np.testing.assert_array_equal(
            _np(single), np.asarray(jcore.RandomPatcher(3, 5, 4, seed=19).apply(images[0])))

    @pytest.mark.parametrize("flips", [False, True])
    def test_center_corner_patcher(self, flips):
        images = _images((3, 10, 9, 2), seed=3)
        j = jcore.CenterCornerPatcher(6, 5, horizontal_flips=flips)
        t = tcore.CenterCornerPatcher(6, 5, horizontal_flips=flips)
        want = np.asarray(j.batch_apply(JDataset.of(images)).array)
        got = t.batch_apply(TDataset(_t(images)))
        assert t.patches_per_image == j.patches_per_image
        np.testing.assert_array_equal(_np(got.array), want)

    def test_windower(self):
        images = _images((2, 11, 10, 3), seed=4)
        want = np.asarray(jconv.Windower(3, 4).batch_apply(JDataset.of(images)).array)
        got = tconv.Windower(3, 4).batch_apply(TDataset(_t(images)))
        np.testing.assert_array_equal(_np(got.array), want)
        np.testing.assert_array_equal(
            _np(tconv.Windower(3, 4).apply(_t(images[1]))),
            np.asarray(jconv.Windower(3, 4).apply(images[1])),
        )


class TestPixelNodes:
    def test_cropper(self):
        images = _images((3, 10, 9, 2), seed=5)
        want = np.asarray(jcore.Cropper(1, 2, 8, 7).batch_apply(JDataset.of(images)).array)
        got = tcore.Cropper(1, 2, 8, 7).batch_apply(TDataset(_t(images)))
        np.testing.assert_array_equal(_np(got.array), want)

    @pytest.mark.parametrize("channels", [1, 3, 4])
    def test_grayscaler(self, channels):
        img = _rng(6).uniform(0, 255, size=(5, 4, channels)).astype(np.float32)
        want = np.asarray(jcore.GrayScaler().apply(img))
        got = _np(tcore.GrayScaler().apply(_t(img)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)

    def test_pixel_scaler_and_vectorizer(self):
        img = _rng(7).integers(0, 256, size=(2, 4, 3, 3)).astype(np.uint8)
        want = np.asarray(jcore.PixelScaler().apply(img))
        got = tcore.PixelScaler().apply(_t(img))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-7)
        vec = tcore.ImageVectorizer()
        np.testing.assert_array_equal(
            _np(vec.device_fn()(got)), np.asarray(jcore.ImageVectorizer()._batch_fn(want))
        )
        np.testing.assert_array_equal(_np(vec.apply(got[0])), want[0].reshape(-1))

    def test_flips(self):
        img = _images((4, 5, 3), seed=8)
        np.testing.assert_array_equal(_np(timg.flip_image(_t(img))),
                                      np.asarray(jimg.flip_image(img)))
        np.testing.assert_array_equal(_np(timg.flip_horizontal(_t(img))),
                                      np.asarray(jimg.flip_horizontal(img)))
        np.testing.assert_array_equal(_np(timg.crop(_t(img), 1, 0, 3, 4)),
                                      np.asarray(jimg.crop(img, 1, 0, 3, 4)))

    @pytest.mark.parametrize("max_val,alpha", [(0.0, 0.25), (0.1, 0.0)])
    def test_symmetric_rectifier(self, max_val, alpha):
        x = _images((2, 5, 4, 3), seed=9)
        want = np.asarray(jconv.SymmetricRectifier(max_val, alpha).apply(x))
        got = tconv.SymmetricRectifier(max_val, alpha)
        np.testing.assert_array_equal(_np(got.device_fn()(_t(x))), want)
        assert got.device_fn()(_t(x)).shape == (2, 5, 4, 6)


class TestPooler:
    # (shape, stride, pool): CIFAR's 27 x 27 grid (pads to 28), a ragged one,
    # and one whose windows tile the image exactly.
    @pytest.mark.parametrize("shape,stride,pool", [((2, 27, 27, 4), 9, 10),
                                                   ((3, 13, 11, 2), 3, 4),
                                                   ((1, 8, 8, 1), 2, 2)])
    @pytest.mark.parametrize("fn", ["sum", "max"])
    def test_against_reference(self, shape, stride, pool, fn):
        x = _images(shape, seed=10)
        want = np.asarray(jconv.Pooler(stride, pool, pool_function=fn).apply(x))
        got = _np(tconv.Pooler(stride, pool, pool_function=fn).device_fn()(_t(x)))
        assert got.shape == want.shape
        if fn == "max":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_pixel_function_runs_first(self):
        x = _images((2, 9, 9, 2), seed=11)
        want = np.asarray(jconv.Pooler(3, 4, pixel_function=jnp.abs).apply(x))
        got = _np(tconv.Pooler(3, 4, pixel_function=torch.abs).apply(_t(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_pool_function_is_checked(self):
        with pytest.raises(TypeError):
            tconv.Pooler(2, 2, pool_function=np.sum)
        with pytest.raises(ValueError):
            tconv.Pooler(2, 2, pool_function="mean")


class TestConvFeaturize:
    @pytest.mark.parametrize("n,X,Y,C,p,k", CONV_SHAPES)
    @pytest.mark.parametrize("normalize", [True, False])
    def test_plain_version_against_pallas_interpret(self, n, X, Y, C, p, k, normalize):
        rng = _rng(12)
        images = (rng.uniform(0, 255, size=(n, X, Y, C))).astype(np.float32)
        filters = rng.normal(size=(k, p * p * C)).astype(np.float32)
        means = rng.normal(size=(p * p * C,)).astype(np.float32)
        want = np.asarray(pallas_images.conv_featurize(
            images, filters, means, patch_size=p, normalize_patches=normalize,
            interpret=True))
        got = _np(cuda_images.conv_featurize_ref(
            _t(images), _t(filters), _t(means), patch_size=p,
            normalize_patches=normalize))
        assert got.shape == (n, X - p + 1, Y - p + 1, k)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    @pytest.mark.parametrize("n,X,Y,C,p,k", CONV_SHAPES[:2])
    def test_plain_version_against_xla_branch(self, n, X, Y, C, p, k):
        rng = _rng(13)
        images = rng.normal(size=(n, X, Y, C)).astype(np.float32)
        filters = rng.normal(size=(k, p * p * C)).astype(np.float32)
        for means in (None, rng.normal(size=(p * p * C,)).astype(np.float32)):
            want = _xla_branch(images, filters, means, patch_size=p, normalize_patches=True)
            got = _np(cuda_images.conv_featurize(
                _t(images), _t(filters), None if means is None else _t(means),
                patch_size=p))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        from keystone_tpu_torch.ops import cuda_ops

        rng = _rng(14)
        images = _t(rng.normal(size=(2, 9, 9, 2)).astype(np.float32))
        filters = _t(rng.normal(size=(4, 18)).astype(np.float32))
        before = dict(cuda_ops.launches)
        got = cuda_images.conv_featurize(images, filters, patch_size=3)
        assert torch.equal(got, cuda_images.conv_featurize_ref(images, filters, patch_size=3))
        assert cuda_ops.launches == before

    def test_convolver_against_reference(self):
        rng = _rng(15)
        images = rng.uniform(0, 255, size=(3, 12, 10, 3))  # float64, as loaders give it
        filters = rng.normal(size=(5, 75)).astype(np.float32)
        j = jconv.Convolver(filters, 12, 10, 3)
        t = tconv.Convolver(_t(filters), 12, 10, 3)
        assert t.patch_size == j.patch_size == 5
        want = np.asarray(j.apply(images))
        got = t.apply(_t(images))
        assert got.dtype == torch.float32  # float64 images are narrowed first
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(t.apply(_t(images[0]))), want[0], rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("flip", [False, True])
    def test_convolver_build_folds_the_whitener(self, flip):
        rng = _rng(16)
        filter_images = rng.normal(size=(6, 3, 3, 2)).astype(np.float32)
        sample = rng.normal(size=(200, 18)).astype(np.float32)
        jw, tw = JZCA(0.1).fit_single(jnp.asarray(sample)), TZCA(0.1).fit_single(_t(sample))
        j = jconv.Convolver.build(filter_images, whitener=jw, flip_filters=flip)
        t = tconv.Convolver.build(_t(filter_images), whitener=tw, flip_filters=flip)
        assert t.patch_size == j.patch_size == 3
        np.testing.assert_allclose(_np(t.filters), np.asarray(j.filters), atol=1e-4)
        images = rng.normal(size=(2, 7, 8, 2)).astype(np.float32)
        np.testing.assert_allclose(_np(t.apply(_t(images))), np.asarray(j.apply(images)),
                                   rtol=1e-4, atol=1e-3)


class TestZCA:
    def test_whitener_against_reference(self):
        sample = _images((300, 108), seed=17)
        sample[:, :10] *= 5.0  # an uneven spectrum
        j = JZCA(eps=0.1).fit_single(jnp.asarray(sample))
        t = TZCA(eps=0.1).fit_single(_t(sample))
        np.testing.assert_allclose(_np(t.means), np.asarray(j.means), atol=1e-6)
        np.testing.assert_allclose(_np(t.whitener), np.asarray(j.whitener), atol=1e-4)
        x = _images((5, 108), seed=18)
        np.testing.assert_allclose(_np(t.apply(_t(x))), np.asarray(j.apply(x)), atol=1e-3)

    def test_fit_takes_the_first_item(self):
        sample = _images((2, 40, 9), seed=19)
        t = TZCA(eps=0.1).fit(TDataset(_t(sample)))
        j = JZCA(eps=0.1).fit(JDataset.of(sample))
        np.testing.assert_allclose(_np(t.whitener), np.asarray(j.whitener), atol=1e-4)
        out = t.batch_apply(TDataset(_t(sample[0])))
        np.testing.assert_allclose(_np(out.array), np.asarray(j.apply(sample[0])), atol=1e-3)
