"""The port's VOCSIFTFisher and ImageNetSiftLcsFV slices against the JAX
package, on the CPU.

Both packages run their pipelines on the same numpy-seeded synthetic
images (``synthetic_voc`` and ``synthetic_imagenet`` are copied draw for
draw). VOC runs at sizes that keep its route: 12 images of 48 × 48,
descDim 16 and vocab 4, so d = 2·16·4 = 128 in two equal blocks of 64,
and the fit takes the stacked block solver through ``gram_corr_sym``'s
plain version (counted here). ImageNet runs 16 images of 4 classes, PCA 16
and vocab 4 in each branch: d = 2·(2·16·4) = 256, blocks of 128.

Tolerances and why:
  - VOC from the reference's SIFT descriptors, with its fitted PCA and GMM
    carried across (``interop``): block weights 1e-4 relative Frobenius
    (measured 8.7e-7), scores 1e-4 absolute. This holds everything after
    the two fits: the projection, the Fisher vectors, the fused
    normalization chain, the block solve.
  - VOC from one package's SIFT descriptors (the reference's, then the
    port's), every estimator after SIFT fitted in its own package with the
    column PCA in float64: weights 1e-4 relative (measured 4.1e-6 and
    5.7e-6), scores 1e-4 absolute (1.5e-6, 3.8e-6). This holds the whole
    pipeline but SIFT, which test_torch_sift_fisher.py holds (quantised
    descriptors at most one step apart, on at most 0.1% of entries).
  - Each package's own run end to end: the same APs (VOC) and the same
    top-5 predictions (ImageNet). Their weights are held looser, to a
    bound from their measured gap. On VOC the gap is the reference's own
    sensitivity to SIFT's quantisation: the port's descriptors differ
    from the reference's by one step in 7 of 334,848 entries, and the
    reference's own fits (column PCA in float64) on the port's
    descriptors move its weights by 5.7e-3, through a GMM whose means
    move by 4e-2; float32 column PCA adds about 4e-4 (on the same
    descriptors the two packages' float32 directions differ by 4e-6,
    each within 4.1e-6 of float64). VOC weights measured 6.6e-3 apart
    (held to 2e-2), scores 3.6e-3 (held to 1e-2); ImageNet weights
    1.3e-3 (held to 5e-3), where λ = 6e-5 also leaves the float32 class
    systems with condition numbers near 1e4 — BWLS fed the reference's
    own float32 features measured 6.3e-4 from its weights, so the solver
    is held at the pipeline's shape and λ in float64, 1e-6.
  (BWLS alone is held in test_torch_clustering_pca.py.)
"""

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu_torch import run as t_run
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch import interop
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops import stats as t_stats
from keystone_tpu_torch.ops import util as t_util
from keystone_tpu_torch.ops.images.core import GrayScaler as TGrayScaler
from keystone_tpu_torch.ops.images.core import PixelScaler as TPixelScaler
from keystone_tpu_torch.ops.images.fisher import GMMFisherVectorEstimator as TGMMFisherVector
from keystone_tpu_torch.ops.images.sift import SIFTExtractor as TSIFTExtractor
from keystone_tpu_torch.ops.learning import pca as t_pca
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator as TBlockLS
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper as TBlockLinearMapper
from keystone_tpu_torch.ops.learning.bwls import BlockWeightedLeastSquaresEstimator as TBWLS
from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv as t_inet
from keystone_tpu_torch.pipelines import voc_sift_fisher as t_voc
from keystone_tpu_torch.utils.images import stack_images
from keystone_tpu_torch.workflow import DefaultOptimizer as TDefaultOptimizer
from keystone_tpu_torch.workflow import Estimator as TEstimator
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops import stats as j_stats
from keystone_tpu.ops import util as j_util
from keystone_tpu.ops.images.fisher import GMMFisherVectorEstimator as JGMMFisherVector
from keystone_tpu.ops.learning import pca as j_pca
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlockLS
from keystone_tpu.ops.learning.block import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.learning.bwls import BlockWeightedLeastSquaresEstimator as JBWLS
from keystone_tpu.pipelines import imagenet_sift_lcs_fv as j_inet
from keystone_tpu.pipelines import voc_sift_fisher as j_voc
from keystone_tpu.workflow import Estimator as JEstimator
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.optimizer import DefaultOptimizer as JDefaultOptimizer

WEIGHT_TOL = 1e-4
SCORE_ATOL = 1e-4
VOC_RUN_WEIGHT_TOL, VOC_RUN_SCORE_ATOL = 2e-2, 1e-2
INET_RUN_WEIGHT_TOL = 5e-3

VOC = dict(descriptor_dim=16, vocab_size=4, block_size=64, synthetic_n=12)
INET = dict(sift_pca_dim=16, lcs_pca_dim=16, vocab_size=4, block_size=128, synthetic_n=16,
            synthetic_classes=4)


def _reset():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _mapper(fitted, cls):
    (m,) = [o for o in fitted.transformer_graph.operators.values() if isinstance(o, cls)]
    return m


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _plan(optimizer, graph):
    """Each node's label and dependencies after the optimizer's rewrite."""
    plan, _ = optimizer.execute(graph, {})
    return {
        node.id: (plan.get_operator(node).label,
                  tuple((type(d).__name__, d.id) for d in plan.get_dependencies(node)))
        for node in plan.nodes
    }


def _counting(name):
    """Wrap a kernel wrapper of ``cuda_ops`` to count its calls (its plain
    version runs on CPU tensors)."""
    calls = []
    fn = getattr(cuda_ops, name)

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kwargs)

    return counted, calls


def _voc_features(j_fitted, models):
    """The reference's features of its own training descriptors: its fitted
    operators after SIFT, up to its block model."""
    x = JDataset(models["descriptors"])
    after_sift = False
    for op in _ops_in_order(j_fitted):
        if type(op).__name__ == "BlockLinearMapper":
            return x
        if after_sift:
            x = op.batch_apply(x)
        after_sift = after_sift or type(op).__name__ == "SIFTExtractor"
    raise AssertionError("no block model")


def _ops_in_order(fitted):
    g = fitted.transformer_graph
    return [g.get_operator(n) for n in sorted(g.nodes, key=lambda n: n.id)]


class _JColumnPCA64(JEstimator):
    """The reference's distributed column PCA fitted on float64 columns,
    its matrix cast back to the pipeline's float32."""

    def __init__(self, dims):
        self.dims = dims

    def fit(self, data):
        cols = np.concatenate([np.asarray(x, np.float64).T for x in data.to_list()])
        pca_mat = j_pca.DistributedPCAEstimator(self.dims).fit(JDataset.of(cols)).pca_mat
        return j_pca.BatchPCATransformer(np.asarray(pca_mat, np.float32))


class _TColumnPCA64(TEstimator):
    """The port's distributed column PCA fitted on float64 columns, its
    matrix cast back to the pipeline's float32."""

    def __init__(self, dims):
        self.dims = dims

    def fit(self, data):
        X = TDataset(data.array[:data.n].double())
        pca_mat = t_pca.DistributedColumnPCAEstimator(self.dims).fit(X).pca_mat
        return t_pca.BatchPCATransformer(pca_mat.float())


def _fit_from_descriptors(pkg, descriptors, label_arrays):
    """VOC's featurizer after SIFT and its block fit, every estimator
    fitted in one package (``pkg`` the port's or the reference's modules),
    the column PCA in float64."""
    util, stats = pkg["util"], pkg["stats"]
    data = pkg["data"](descriptors)
    chain = util.Cacher().to_pipeline().and_then(pkg["pca"](16), data).and_then(
        pkg["fisher"](4, gmm_seed=0), data)
    for node in (util.FloatToDouble(), util.MatrixVectorizer(), stats.NormalizeRows(),
                 stats.SignedHellingerMapper(), stats.NormalizeRows(), util.Cacher()):
        chain = chain.and_then(node)
    labels = util.ClassLabelIndicatorsFromIntArrayLabels(20).batch_apply(
        pkg["of"](label_arrays))
    return chain.and_then(pkg["block"](64, 1, 0.5), data, labels).fit()


_PORT = dict(data=lambda x: TDataset(torch.from_numpy(x)), of=TDataset.of, util=t_util,
             stats=t_stats, pca=_TColumnPCA64, fisher=TGMMFisherVector, block=TBlockLS)
_REFERENCE = dict(data=JDataset, of=JDataset.of, util=j_util, stats=j_stats, pca=_JColumnPCA64,
                  fisher=JGMMFisherVector, block=JBlockLS)


def _port_descriptors(images):
    x = TDataset(stack_images(images, "cpu"))
    for node in (TPixelScaler(), TGrayScaler(), TSIFTExtractor()):
        x = node.batch_apply(x)
    return x.array.numpy()


@pytest.fixture(scope="module")
def voc():
    _reset()
    j_pipe, j_aps, j_map = j_voc.run(j_voc.VOCConfig(**VOC))
    j_fitted = j_pipe.fit()
    extract = j_voc._MultiLabeledImageExtractor().batch_apply
    j_scores = np.asarray(j_fitted.apply(extract(j_voc.synthetic_voc(8, 1, 48))).to_numpy())
    # The reference's SIFT descriptors of the training images, and its
    # fitted PCA and GMM.
    models = {}
    for key, images in (("descriptors", j_voc.synthetic_voc(12, 0, 48)),
                        ("test_descriptors", j_voc.synthetic_voc(8, 1, 48))):
        x = extract(images)
        for op in _ops_in_order(j_fitted):
            x = op.batch_apply(x)
            if type(op).__name__ == "SIFTExtractor":
                models[key] = np.array(x.to_numpy())
                break
    for op in _ops_in_order(j_fitted):
        if type(op).__name__ in ("BatchPCATransformer", "FisherVector"):
            models[type(op).__name__] = op
    _reset()
    j_plan = _plan(JDefaultOptimizer(), j_pipe.executor.graph)
    counted, calls = _counting("gram_corr_sym")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_ops, "gram_corr_sym", counted)
        r = t_voc.run(t_voc.VOCConfig(**VOC), device="cpu")
    t_scores = r.fitted.apply(TDataset(stack_images(t_voc.synthetic_voc(8, 1, 48), "cpu")))
    t_scores = t_scores.to_numpy()
    _reset()
    t_plan = _plan(TDefaultOptimizer(), r.pipeline.executor.graph)
    _reset()
    return dict(j_fitted=j_fitted, j_aps=np.asarray(j_aps), j_map=j_map, j_scores=j_scores,
                j_plan=j_plan, r=r, t_scores=t_scores, t_plan=t_plan, gram_calls=calls,
                j_models=models)


@pytest.fixture(scope="module")
def inet():
    _reset()
    fits = []
    fit = JBWLS.fit

    def recording_fit(self, data, labels):
        fits.append((np.array(data.to_numpy()), np.array(labels.to_numpy())))
        return fit(self, data, labels)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBWLS, "fit", recording_fit)
        j_pipe, j_top1, j_top5 = j_inet.run(j_inet.ImageNetConfig(**INET))
    j_fitted = j_pipe.fit()
    from keystone_tpu.ops.images.core import ImageExtractor
    j_pred = np.asarray(j_fitted.apply(ImageExtractor().batch_apply(
        j_inet.synthetic_imagenet(8, 4, 1, 48))).to_numpy())
    _reset()
    j_plan = _plan(JDefaultOptimizer(), j_pipe.executor.graph)
    r = t_inet.run(t_inet.ImageNetConfig(**INET), device="cpu")
    _reset()
    t_plan = _plan(TDefaultOptimizer(), r.pipeline.executor.graph)
    _reset()
    (features, labels), = fits
    return dict(j_fitted=j_fitted, j_top1=j_top1, j_top5=j_top5, j_pred=j_pred,
                j_plan=j_plan, r=r, t_plan=t_plan, features=features, labels=labels)


class TestVOCSlice:
    def test_synthetic_images_are_the_references(self):
        j, t = j_voc.synthetic_voc(5, 3, 32).to_list(), t_voc.synthetic_voc(5, 3, 32).to_list()
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.filename == b.filename

    def test_route_from_the_references_descriptors_and_models(self, voc):
        # The port's composition after SIFT (build_featurizer's, with the
        # two estimators replaced by the reference's fitted models) on the
        # reference's descriptors, then its block fit.
        models = voc["j_models"]
        pca, fv = models["BatchPCATransformer"], models["FisherVector"]
        gmm = {name: np.asarray(getattr(fv.gmm, name))
               for name in ("means", "variances", "weights")}
        chain = interop.batch_pca_transformer(np.asarray(pca.pca_mat), device="cpu")
        chain = chain.to_pipeline().and_then(interop.fisher_vector(gmm, device="cpu"))
        for node in (t_util.FloatToDouble(), t_util.MatrixVectorizer(), t_stats.NormalizeRows(),
                     t_stats.SignedHellingerMapper(), t_stats.NormalizeRows(), t_util.Cacher()):
            chain = chain.and_then(node)
        descriptors = TDataset(torch.from_numpy(models["descriptors"]))
        train = t_voc.synthetic_voc(12, 0, 48).to_list()
        labels = t_util.ClassLabelIndicatorsFromIntArrayLabels(20).batch_apply(
            TDataset.of([item.labels for item in train]))
        fitted = chain.and_then(TBlockLS(64, 1, 0.5), descriptors, labels).fit()
        j_m = _mapper(voc["j_fitted"], JBlockLinearMapper)
        t_m = _mapper(fitted, TBlockLinearMapper)
        assert len(t_m.xs) == len(j_m.xs) == 2
        want = np.concatenate([np.asarray(x) for x in j_m.xs])
        got = torch.cat(t_m.xs).numpy()
        assert got.shape == want.shape == (128, 20)
        assert _rel(got, want) <= WEIGHT_TOL
        np.testing.assert_allclose(t_m.b_opt.numpy(), np.asarray(j_m.b_opt), atol=1e-6)
        j_feat = voc["j_fitted"]
        scores = fitted.apply(descriptors).to_numpy()
        want_scores = np.asarray(j_m.batch_apply(_voc_features(j_feat, models)).to_numpy())
        np.testing.assert_allclose(scores, want_scores, atol=SCORE_ATOL)

    @pytest.mark.parametrize("source", ["reference", "port"])
    def test_fits_from_the_same_descriptors(self, voc, source):
        # Every estimator after SIFT fitted in its own package (column PCA
        # in float64) on one package's SIFT descriptors: weights and
        # scores at the whole pipeline's tolerances.
        models = voc["j_models"]
        if source == "reference":
            train, test = models["descriptors"], models["test_descriptors"]
        else:
            train = _port_descriptors(t_voc.synthetic_voc(12, 0, 48))
            test = _port_descriptors(t_voc.synthetic_voc(8, 1, 48))
        label_arrays = [item.labels for item in t_voc.synthetic_voc(12, 0, 48).to_list()]
        _reset()
        j_fitted = _fit_from_descriptors(_REFERENCE, train, label_arrays)
        t_fitted = _fit_from_descriptors(_PORT, train, label_arrays)
        _reset()
        want = np.concatenate([np.asarray(x) for x in _mapper(j_fitted, JBlockLinearMapper).xs])
        got = torch.cat(_mapper(t_fitted, TBlockLinearMapper).xs).numpy()
        assert got.shape == want.shape == (128, 20)
        assert _rel(got, want) <= WEIGHT_TOL
        want_scores = np.asarray(j_fitted.apply(JDataset(test)).to_numpy())
        scores = t_fitted.apply(TDataset(torch.from_numpy(test))).to_numpy()
        assert scores.shape == want_scores.shape == (8, 20)
        np.testing.assert_allclose(scores, want_scores, atol=SCORE_ATOL)

    def test_own_runs(self, voc):
        j_m = _mapper(voc["j_fitted"], JBlockLinearMapper)
        t_m = _mapper(voc["r"].fitted, TBlockLinearMapper)
        want = np.concatenate([np.asarray(x) for x in j_m.xs])
        got = torch.cat(t_m.xs).numpy()
        assert got.shape == want.shape == (128, 20)
        assert _rel(got, want) <= VOC_RUN_WEIGHT_TOL
        assert voc["t_scores"].shape == voc["j_scores"].shape == (8, 20)
        np.testing.assert_allclose(voc["t_scores"], voc["j_scores"], atol=VOC_RUN_SCORE_ATOL)
        np.testing.assert_array_equal(voc["r"].aps, voc["j_aps"])
        assert voc["r"].mean_ap == voc["j_map"]
        assert voc["r"].fit_seconds > 0 and voc["r"].apply_seconds > 0

    def test_fit_takes_gram_corr_sym(self, voc):
        # Two equal blocks of 64: one gram_corr_sym (its plain version on
        # the CPU) a block in the one epoch.
        assert voc["gram_calls"] == [(12, 64), (12, 64)]

    def test_plan_is_the_references(self, voc):
        assert voc["t_plan"] == voc["j_plan"]
        labels = [label for label, _ in voc["t_plan"].values()]
        assert ("Fused[FloatToDouble > MatrixVectorizer > NormalizeRows > "
                "SignedHellingerMapper > NormalizeRows]") in labels
        assert "Fused[PixelScaler > GrayScaler]" in labels
        assert "BlockLeastSquaresEstimator" in labels  # not fused into the fit


class TestImageNetSlice:
    def test_synthetic_images_are_the_references(self):
        j = j_inet.synthetic_imagenet(5, 7, 3, 32).to_list()
        t = t_inet.synthetic_imagenet(5, 7, 3, 32).to_list()
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a.image, b.image)
            assert a.label == b.label and a.filename == b.filename

    def test_own_runs(self, inet):
        j_m = _mapper(inet["j_fitted"], JBlockLinearMapper)
        t_m = _mapper(inet["r"].fitted, TBlockLinearMapper)
        want = np.concatenate([np.asarray(x) for x in j_m.xs])
        got = torch.cat(t_m.xs).numpy()
        assert got.shape == want.shape == (256, 4)
        assert _rel(got, want) <= INET_RUN_WEIGHT_TOL

    def test_bwls_on_the_references_features(self, inet):
        # The pipeline's solver at its shape and λ, on the reference's own
        # features, in float64 on both sides.
        F, Y = inet["features"].astype(np.float64), inet["labels"].astype(np.float64)
        cfg = j_inet.ImageNetConfig(**INET)
        args = (cfg.block_size, cfg.num_iters, cfg.lam, cfg.mixture_weight)
        want = JBWLS(*args).fit(JDataset(F), JDataset(Y))
        got = TBWLS(*args).fit(TDataset(torch.from_numpy(F)), TDataset(torch.from_numpy(Y)))
        w_j = np.concatenate([np.asarray(x) for x in want.xs])
        assert F.shape == (16, 256)
        assert _rel(torch.cat(got.xs).numpy(), w_j) <= 1e-6
        assert _rel(got.b_opt.numpy(), np.asarray(want.b_opt)) <= 1e-6

    def test_predictions_and_errors(self, inet):
        r = inet["r"]
        np.testing.assert_array_equal(r.top5, inet["j_pred"])
        assert r.top5.shape == (8, 4)
        assert r.top1_eval.total_error == inet["j_top1"].total_error
        assert r.top5_error == inet["j_top5"]

    def test_gather_is_not_fused(self, inet):
        assert inet["t_plan"] == inet["j_plan"]
        labels = [label for label, _ in inet["t_plan"].values()]
        assert not any(label.startswith("FusedGather") for label in labels)
        chain = ("Fused[FloatToDouble > MatrixVectorizer > NormalizeRows > "
                 "SignedHellingerMapper > NormalizeRows]")
        j_labels = [label for label, _ in inet["j_plan"].values()]
        assert labels.count(chain) == j_labels.count(chain) >= 2
        assert "BlockWeightedLeastSquaresEstimator" in labels


class TestEntryPoints:
    def test_cli_names(self):
        assert "VOCSIFTFisher" in t_run.PIPELINES and "ImageNetSiftLcsFV" in t_run.PIPELINES

    def test_cli_runs_on_the_cpu(self, capsys):
        _reset()
        t_run.main(["VOCSIFTFisher", "--descDim", "8", "--vocabSize", "2", "--blockSize", "16",
                    "--syntheticN", "8", "--imageSize", "32", "--device", "cpu"])
        t_run.main(["ImageNetSiftLcsFV", "--vocabSize", "2", "--blockSize", "256",
                    "--syntheticN", "8", "--syntheticClasses", "3", "--imageSize", "48",
                    "--device", "cpu"])
        _reset()
        out = capsys.readouterr().out
        assert "TEST Mean Average Precision is" in out and "TEST top-5 error is" in out

    def test_entry_points_raise_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            t_voc.run(t_voc.VOCConfig(**VOC))
        with pytest.raises(RuntimeError):
            t_inet.run(t_inet.ImageNetConfig(**INET))
        with pytest.raises(RuntimeError):
            interop.fisher_vector(
                {"means": np.zeros((2, 1)), "variances": np.ones((2, 1)), "weights": [1.0]})
