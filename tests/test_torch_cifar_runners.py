"""The CIFAR runners the port adds (keystone_tpu_torch/pipelines/cifar.py:
LinearPixels, RandomCifar, RandomPatchCifar, RandomPatchCifarAugmented),
their nodes (RandomImageTransformer, AugmentedExamplesEvaluator) and the
CLI's 13 pipeline names, against the JAX package on the CPU.

Both packages load the same numpy-seeded synthetic images (float64 in the
reference, float32 in the port; the featurizers compute in float32 in
both) and make the same numpy draws: patch corners, training crops,
Gaussian filters, the filter subsample and the coin flips. The reference
runs its XLA paths, its default on the CPU; the port its kernels' plain
versions.

Tolerances, with their reasons:
  - images, crops and RandomCifar's filters: equal, bit for bit (the same
    draws in float64, narrowed to float32 once on both sides);
  - whitened filters and whitener: 1e-4 absolute on entries of order 1,
    two float32 SVDs of the same sample (tests/test_torch_cifar_slice.py);
  - scores from the reference's filters carried across: 1e-3 of the
    largest score (float32 sums of the featurizer through the scaler and a
    block solve);
  - train and test errors and the augmented vote: equal;
  - LinearPixels' weights: 1e-4 relative, float32 normal equations of
    1,024 grayscale features;
  - the evaluators on hand-built scores: the reference's metrics exactly.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch import run as trun
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.evaluation import AggregationPolicy as TPolicy
from keystone_tpu_torch.evaluation import AugmentedExamplesEvaluator as TAugmented
from keystone_tpu_torch.ops.images.core import RandomImageTransformer as TRandomImage
from keystone_tpu_torch.ops.learning.linear import LinearMapper as TLinearMapper
from keystone_tpu_torch.pipelines import cifar as tcifar
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

from keystone_tpu import run as jrun
from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.evaluation import AggregationPolicy as JPolicy
from keystone_tpu.evaluation import AugmentedExamplesEvaluator as JAugmented
from keystone_tpu.ops.images.core import RandomImageTransformer as JRandomImage
from keystone_tpu.ops.learning.linear import LinearMapper as JLinearMapper
from keystone_tpu.pipelines import cifar as jcifar
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv

# 256 training and 128 test images, 16 filters (d = 288; 128 for the
# augmented runner's 24 x 24 crops): blocks of 128 make the ragged,
# stepwise block fit the full-width runners take (288 = 128 + 128 + 32);
# blocks of 512 one block.
CFG = dict(synthetic_n=256, num_filters=16, whitener_size=300, block_size=128)
CONFIGS = {"ragged blocks": CFG, "one block": dict(CFG, block_size=512)}
BLOCK_RUNNERS = ["RandomCifar", "RandomPatchCifar"]


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _data(cfg):
    jtrain, jtest, jsyn = jcifar._load(jcifar.CifarConfig(**cfg))
    ttrain, ttest, tsyn = tcifar._load(tcifar.CifarConfig(**cfg), torch.device("cpu"))
    assert jsyn and tsyn
    return (jtrain, jtest), (ttrain, ttest)


def _j_augment(cfg, jtrain, jtest):
    """The reference runner's crops (cifar.py:274-295), as it makes them."""
    from keystone_tpu.ops.images.core import CenterCornerPatcher, RandomPatcher

    c = jcifar.CifarConfig(**cfg)
    aug = c.augment_patch_size
    train = RandomPatcher(c.augment_patches, aug, aug, seed=c.seed).batch_apply(jtrain.data)
    test = CenterCornerPatcher(aug, aug, horizontal_flips=False).batch_apply(jtest.data)
    labels = np.repeat(np.asarray(jtrain.labels.array)[: jtrain.labels.n], c.augment_patches)
    return np.asarray(train.array), np.asarray(test.array), labels


class TestDraws:
    def test_random_filters_are_the_references(self):
        cfg = tcifar.CifarConfig(**CFG)
        rng = np.random.default_rng(cfg.seed)
        want = rng.normal(size=(16, 6, 6, 3))
        want /= np.linalg.norm(want.reshape(16, -1), axis=1)[:, None, None, None]
        np.testing.assert_array_equal(tcifar.random_filters(cfg), want)

    def test_augmented_crops_are_the_references(self):
        (jtrain, jtest), (ttrain, ttest) = _data(CFG)
        jtr, jte, jlab = _j_augment(CFG, jtrain, jtest)
        ttr, tte, names, per_image = tcifar.augment(tcifar.CifarConfig(**CFG), ttrain, ttest,
                                                    True)
        assert per_image == 5 and ttr.data.n == 256 * 8 and tte.data.n == 128 * 5
        np.testing.assert_array_equal(_np(ttr.data.array), jtr.astype(np.float32))
        np.testing.assert_array_equal(_np(tte.data.array), jte.astype(np.float32))
        np.testing.assert_array_equal(_np(ttr.labels.array), jlab)
        np.testing.assert_array_equal(_np(tte.labels.array),
                                      np.repeat(np.asarray(jtest.labels.array), 5))
        assert names == list(np.repeat(np.arange(128), 5))

    @pytest.mark.parametrize("flips,want", [(None, 5), (True, 10), (False, 5)])
    def test_flips_follow_the_data_source(self, flips, want):
        (_, _), (ttrain, ttest) = _data(dict(CFG, synthetic_n=16))
        cfg = tcifar.CifarConfig(**dict(CFG, synthetic_n=16), horizontal_flips=flips)
        assert tcifar.augment(cfg, ttrain, ttest, True)[3] == want
        if flips is None:  # real data: flips on, as the reference decides
            assert tcifar.augment(cfg, ttrain, ttest, False)[3] == 10

    def test_augmented_filters_from_the_crops(self):
        (jtrain, jtest), (ttrain, ttest) = _data(CFG)
        jtr, _, jlab = _j_augment(CFG, jtrain, jtest)
        from keystone_tpu.data import LabeledData as JLabeled
        jf, jw = jcifar._sample_whitened_filters(JLabeled(jtr, jlab), jcifar.CifarConfig(**CFG))
        ttr, _, _, _ = tcifar.augment(tcifar.CifarConfig(**CFG), ttrain, ttest, True)
        tf, tw = tcifar._sample_whitened_filters(ttr, tcifar.CifarConfig(**CFG))
        np.testing.assert_allclose(_np(tw.means), np.asarray(jw.means), atol=1e-6)
        np.testing.assert_allclose(_np(tw.whitener), np.asarray(jw.whitener), atol=1e-4)
        np.testing.assert_allclose(_np(tf), jf, atol=1e-4)


class TestRandomImageTransformer:
    @pytest.mark.parametrize("chance", [0.0, 0.3, 1.0])
    def test_same_flips_batch(self, chance):
        images = np.random.default_rng(1).uniform(0, 255, size=(9, 5, 4, 3))
        j = JRandomImage(chance, seed=4).batch_apply(JDataset(images.astype(np.float32)))
        t = TRandomImage(chance, seed=4).batch_apply(
            TDataset(torch.from_numpy(images.astype(np.float32))))
        np.testing.assert_array_equal(_np(t.array), np.asarray(j.array))

    def test_same_flips_one_image_at_a_time(self):
        images = np.random.default_rng(2).uniform(0, 255, size=(6, 5, 4, 3)).astype(np.float32)
        jt, tt = JRandomImage(0.5, seed=7), TRandomImage(0.5, seed=7)
        for img in images:
            np.testing.assert_array_equal(_np(tt.apply(torch.from_numpy(img))),
                                          np.asarray(jt.apply(img)))

    def test_custom_transform(self):
        images = np.arange(2 * 3 * 3 * 1, dtype=np.float32).reshape(2, 3, 3, 1)
        t = TRandomImage(1.0, transform=lambda img: img * 2.0, seed=0)
        np.testing.assert_array_equal(_np(t.batch_apply(TDataset(torch.from_numpy(images)))
                                          .array), images * 2.0)


def _scores(n=12, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, k))


class TestAugmentedExamplesEvaluator:
    @pytest.mark.parametrize("policy", ["average", "borda"])
    @pytest.mark.parametrize("names", [
        [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3],
        ["b", "a", "b", "a", "c", "c", "d", "d", "b", "a", "c", "d"],
    ])
    def test_reference_metrics(self, policy, names):
        scores = _scores()
        labels_of = {name: i % 4 for i, name in enumerate(dict.fromkeys(names))}
        labels = np.array([labels_of[name] for name in names])
        j = JAugmented(names, 4, policy).evaluate(JDataset(scores), JDataset(labels))
        t = TAugmented(names, 4, policy).evaluate(TDataset(torch.from_numpy(scores)),
                                                  TDataset(torch.from_numpy(labels)))
        np.testing.assert_array_equal(t.confusion, np.asarray(j.confusion))
        assert t.total_error == j.total_error and t.total == 4

    def test_ties_vote_like_the_reference(self):
        # Copies that tie on average (and on Borda rank) break to the lowest
        # class, as numpy's argmax does in both.
        scores = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
        names, labels = [0, 0, 1, 1], np.array([1, 1, 2, 2])
        for policy in (TPolicy.AVERAGE, TPolicy.BORDA):
            j = JAugmented(names, 3, policy).evaluate(JDataset(scores), JDataset(labels))
            t = TAugmented(names, 3, policy).evaluate(TDataset(torch.from_numpy(scores)),
                                                      TDataset(torch.from_numpy(labels)))
            np.testing.assert_array_equal(t.confusion, np.asarray(j.confusion))
        assert TPolicy.AVERAGE == JPolicy.AVERAGE and TPolicy.BORDA == JPolicy.BORDA

    def test_raises_as_the_reference_does(self):
        scores = torch.from_numpy(_scores(4, 3))
        with pytest.raises(AssertionError, match="conflicting labels"):
            TAugmented([0, 0, 1, 1], 3).evaluate(TDataset(scores),
                                                 TDataset(torch.tensor([0, 1, 2, 2])))
        with pytest.raises(ValueError, match="align"):
            TAugmented([0, 0, 1], 3).evaluate(TDataset(scores), TDataset(torch.zeros(4)))
        with pytest.raises(ValueError, match="policy"):
            TAugmented([0], 3, policy="median")


def _run_both(name, cfg):
    jresult = getattr(jcifar, jcifar.RUNNERS[name].__name__)(jcifar.CifarConfig(**cfg))
    JPipelineEnv.get_or_create().reset()
    tresult = tcifar.RUNNERS[name](tcifar.CifarConfig(**cfg), device="cpu")
    return jresult, tresult


class TestRunsAgainstReference:
    @pytest.mark.parametrize("which", list(CONFIGS))
    @pytest.mark.parametrize("name", BLOCK_RUNNERS + ["LinearPixels"])
    def test_errors(self, name, which):
        (_, jtrain_eval, jtest_eval), run = _run_both(name, CONFIGS[which])
        assert run.train_eval.total == 256 and run.test_eval.total == 128
        assert run.train_eval.total_error == jtrain_eval.total_error
        assert run.test_eval.total_error == jtest_eval.total_error
        assert run.fit_seconds > 0 and run.apply_seconds > 0

    @pytest.mark.parametrize("which", list(CONFIGS))
    def test_augmented_vote(self, which):
        (_, jtest_eval), run = _run_both("RandomPatchCifarAugmented", CONFIGS[which])
        assert run.test_eval.total == 128 and run.train_eval.total == 256 * 8
        np.testing.assert_array_equal(run.test_eval.confusion, np.asarray(jtest_eval.confusion))
        assert run.test_eval.total_error < 0.5  # chance is 0.9

    def test_linear_pixels_weights(self):
        # 2,048 images (the system is singular below 1,024): each package's
        # float32 weights sit about 2.4e-4 from the float64 solve of the same
        # grayscale features (condition number 1.3e4), so the port's are held
        # to at most 1.25x the reference's distance from that solve, and
        # within 4x that distance of the reference's weights.
        cfg = dict(CFG, synthetic_n=2048)
        (jpipe, _, _), run = _run_both("LinearPixels", cfg)
        (jm,) = [o for o in jpipe.fit().transformer_graph.operators.values()
                 if isinstance(o, JLinearMapper)]
        (tm,) = [o for o in run.fitted.transformer_graph.operators.values()
                 if isinstance(o, TLinearMapper)]
        want, got = np.asarray(jm.x, np.float64), _np(tm.x).astype(np.float64)
        assert got.shape == want.shape == (1024, 10)
        A, Y = _gray_rows(cfg)
        w64 = np.linalg.solve(A.T @ A, A.T @ Y)

        def rel(a, b):
            return np.linalg.norm(a - b) / np.linalg.norm(b)

        assert rel(got, w64) <= 1.25 * rel(want, w64)
        assert rel(got, want) <= 4 * rel(want, w64)

    def test_linear_pixels_estimator_in_float64(self):
        # The exact least-squares fit itself, on the same float64 grayscale
        # rows in both packages: the weights and intercept within 1e-4
        # relative (they agree to rounding, about 1e-12).
        from keystone_tpu.ops.learning.linear import LinearMapEstimator as JEstimator
        from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator as TEstimator

        A, Y = _gray_rows(dict(CFG, synthetic_n=2048), centre=False)
        j = JEstimator(lam=None).fit(JDataset(A), JDataset(Y))
        t = TEstimator(lam=None).fit(TDataset(torch.from_numpy(A)), TDataset(torch.from_numpy(Y)))
        assert _np(t.x).dtype == np.float64
        np.testing.assert_allclose(_np(t.x), np.asarray(j.x), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(j.x)).max())
        np.testing.assert_allclose(_np(t.b_opt), np.asarray(j.b_opt), rtol=0, atol=1e-10)


def _gray_rows(cfg, centre=True):
    """The port's float32 grayscale training rows as float64 (n, 1,024) and
    the ±1 labels, mean-centred unless ``centre`` is False."""
    from keystone_tpu_torch.ops.images.core import GrayScaler, PixelScaler

    train, _, _ = tcifar._load(tcifar.CifarConfig(**cfg), torch.device("cpu"))
    X = PixelScaler().device_fn()(train.data.array)
    A = _np(GrayScaler().device_fn()(X)).reshape(train.data.n, -1).astype(np.float64)
    Y = 2.0 * np.eye(10)[_np(train.labels.array)] - 1.0
    if centre:
        A, Y = A - A.mean(0), Y - Y.mean(0)
    return A, Y


def _block_pipelines(name, cfg):
    """Both packages' block pipelines of ``name`` built on the reference's
    filters (and whitener) carried across, with their test rows."""
    (jtrain, jtest), (ttrain, ttest) = _data(cfg)
    jcfg, tcfg = jcifar.CifarConfig(**cfg), tcifar.CifarConfig(**cfg)
    if name == "RandomCifar":
        jf, jw = tcifar.random_filters(tcfg), None
        tw = None
    else:
        if name == "RandomPatchCifarAugmented":
            from keystone_tpu.data import LabeledData as JLabeled
            jtr, jte, jlab = _j_augment(cfg, jtrain, jtest)
            jtrain, jtest = JLabeled(jtr, jlab), JLabeled(jte, np.repeat(
                np.asarray(jtest.labels.array), 5))
            ttrain, ttest, _, _ = tcifar.augment(tcfg, ttrain, ttest, True)
        jf, jw = jcifar._sample_whitened_filters(jtrain, jcfg)
        tw = interop.zca_whitener(np.asarray(jw.whitener), np.asarray(jw.means), "cpu")
    size = jcfg.augment_patch_size if name == "RandomPatchCifarAugmented" else 32
    tf = torch.from_numpy(np.asarray(jf, np.float32))
    from keystone_tpu.ops.images.conv import Convolver as JConvolver
    from keystone_tpu.ops.images.conv import Pooler as JPooler
    from keystone_tpu.ops.images.conv import SymmetricRectifier as JRectifier
    from keystone_tpu.ops.images.core import ImageVectorizer as JVectorizer
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
    from keystone_tpu.ops.stats import StandardScaler as JScaler
    from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
    from keystone_tpu.ops.util import Cacher as JCacher
    import jax.numpy as jnp

    jfeat = (JConvolver(jnp.asarray(jf, jnp.float32).reshape(len(jf), -1), img_x=size,
                        img_y=size, img_channels=3, whitener=jw, normalize_patches=True)
             .to_pipeline().and_then(JRectifier(alpha=jcfg.alpha))
             .and_then(JPooler(jcfg.pool_stride, jcfg.pool_size, pool_function="sum"))
             .and_then(JVectorizer()).and_then(JCacher()))
    jlabels = JLabels(10)(JDataset.of(np.asarray(jtrain.labels.array)))
    jpipe = jfeat.and_then(JScaler(), jtrain.data).and_then(
        JBlock(jcfg.block_size, 1, jcfg.lam), jtrain.data, jlabels)
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator as TBlock
    from keystone_tpu_torch.ops.stats import StandardScaler as TScaler
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
    tlabels = TLabels(10)(ttrain.labels)
    tpipe = tcifar._conv_featurizer(tf, tw, tcfg, img_size=size).and_then(
        TScaler(), ttrain.data).and_then(TBlock(tcfg.block_size, 1, tcfg.lam), ttrain.data,
                                         tlabels)
    return jpipe, tpipe, jtest, ttest


class TestScoresFromTheSameFilters:
    @pytest.mark.parametrize("which", list(CONFIGS))
    @pytest.mark.parametrize("name", BLOCK_RUNNERS + ["RandomPatchCifarAugmented"])
    def test_scores(self, name, which):
        jpipe, tpipe, jtest, ttest = _block_pipelines(name, CONFIGS[which])
        want = np.asarray(jpipe.apply(jtest.data).get().array)
        got = _np(tpipe.apply(ttest.data).get().array)
        assert got.shape == want.shape and want.shape[1] == 10
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


class TestEntryPoints:
    def test_thirteen_names(self):
        assert set(trun.PIPELINES) == set(jrun.PIPELINES)
        assert len(trun.PIPELINES) == 13
        for name in jrun.PIPELINES:
            assert callable(trun.resolve(name))
            assert trun.resolve(f"keystone_tpu.pipelines.{name}") is trun.resolve(name)

    @pytest.mark.parametrize("name", ["LinearPixels", "RandomCifar", "RandomPatchCifar",
                                      "RandomPatchCifarAugmented"])
    def test_cli(self, name, capsys):
        trun.main([name, "--device", "cpu", "--syntheticN", "48", "--numFilters", "4",
                   "--whitenerSize", "60", "--blockSize", "32"])
        out = capsys.readouterr().out
        assert "TRAIN Error is" in out and "TEST Error is" in out
