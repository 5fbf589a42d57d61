"""The CIFAR slice of the port (keystone_tpu_torch/pipelines/cifar.py:
RandomPatchCifarKernel) against the JAX package, end to end on the CPU.

Both packages load the same numpy-seeded synthetic images, float32 on the
port's side and float64 narrowed to float32 inside the reference's
Convolver, so the featurizer computes in float32 in both. The patch
corners and the filter subsample are the same numpy draws, and the ZCA
whitener is fitted in float32 in both (the reference's RandomPatcher casts
its patches to float32 before the fit). The reference solves by its XLA
path, its default on the CPU; the port by its kernels' plain versions.

Tolerances, with their reasons:
  - filters and whitener: 1e-4 absolute on entries of order 1, two float32
    SVDs of the same sample (see tests/test_torch_images.py);
  - KRR scores from the same filters: 1e-3 of the largest score — the
    featurizer's float32 sums (1e-5 relative) pass through the scaler and
    the Gaussian kernel into the solve;
  - train and test errors: equal.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch import run as trun
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import loaders as tloaders
from keystone_tpu_torch.ops.images.conv import Convolver as TConvolver
from keystone_tpu_torch.ops.learning import kernel as tkernel
from keystone_tpu_torch.ops.stats import StandardScaler as TStandardScaler
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels as TLabels
from keystone_tpu_torch.ops.util import MaxClassifier as TMaxClassifier
from keystone_tpu_torch.pipelines import cifar as tcifar
from keystone_tpu_torch.workflow import DefaultOptimizer as TDefaultOptimizer
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow import fusion as tfusion

from keystone_tpu.data import loaders as jloaders
from keystone_tpu.ops.learning import kernel as jkernel
from keystone_tpu.ops.stats import StandardScaler as JStandardScaler
from keystone_tpu.ops.util import ClassLabelIndicatorsFromIntLabels as JLabels
from keystone_tpu.ops.util import MaxClassifier as JMaxClassifier
from keystone_tpu.pipelines import cifar as jcifar
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.optimizer import DefaultOptimizer as JDefaultOptimizer

# tests/test_pipelines_examples.py's configuration (one 216-row block for
# 192 images), and the same with blocks smaller than n (3 blocks, the last
# ragged).
CFG = dict(synthetic_n=192, num_filters=24, whitener_size=300, block_size=216,
           pool_stride=9, pool_size=10)
CONFIGS = {"one block": CFG, "three blocks": dict(CFG, block_size=80)}


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
    jtrain, jtest, _ = jcifar._load(jcifar.CifarConfig(**cfg))
    ttrain, ttest, _ = tcifar._load(tcifar.CifarConfig(**cfg), torch.device("cpu"))
    return (jtrain, jtest), (ttrain, ttest)


class TestData:
    def test_synthetic_cifar_is_the_references(self):
        j = jloaders.synthetic_cifar(40, seed=3)
        t = tloaders.synthetic_cifar(40, seed=3, device="cpu")
        assert t.data.array.dtype == torch.float32 and t.data.array.shape == (40, 32, 32, 3)
        np.testing.assert_array_equal(_np(t.data.array), np.asarray(j.data.array, np.float32))
        np.testing.assert_array_equal(_np(t.labels.array), np.asarray(j.labels.array))

    def test_cifar_binary(self, tmp_path):
        rng = np.random.default_rng(0)
        records = rng.integers(0, 256, size=(5, 3073)).astype(np.uint8)
        records[:, 0] = rng.integers(0, 10, size=5)
        path = tmp_path / "batch.bin"
        path.write_bytes(records.tobytes())
        j = jloaders.load_cifar_binary(str(path))
        t = tloaders.load_cifar_binary(str(path), device="cpu")
        np.testing.assert_array_equal(_np(t.data.array), np.asarray(j.data.array))
        np.testing.assert_array_equal(_np(t.labels.array), np.asarray(j.labels.array))
        path.write_bytes(records.tobytes()[:-1])
        with pytest.raises(ValueError, match="3073"):
            tloaders.load_cifar_binary(str(path), device="cpu")


class TestFilters:
    def test_same_filters_and_whitener(self):
        (jtrain, _), (ttrain, _) = _data(CFG)
        jf, jw = jcifar._sample_whitened_filters(jtrain, jcifar.CifarConfig(**CFG))
        tf, tw = tcifar._sample_whitened_filters(ttrain, tcifar.CifarConfig(**CFG))
        assert tuple(tf.shape) == jf.shape == (24, 6, 6, 3)
        np.testing.assert_allclose(_np(tw.means), np.asarray(jw.means), atol=1e-6)
        np.testing.assert_allclose(_np(tw.whitener), np.asarray(jw.whitener), atol=1e-4)
        np.testing.assert_allclose(_np(tf), jf, atol=1e-4)

    def test_interop_carries_the_convolver(self):
        (jtrain, _), (ttrain, _) = _data(CFG)
        cfg = jcifar.CifarConfig(**CFG)
        jf, jw = jcifar._sample_whitened_filters(jtrain, cfg)
        jconv = jcifar._conv_featurizer(jf, jw, cfg)
        (j_op,) = [op for op in jconv.executor.graph.operators.values()
                   if type(op).__name__ == "Convolver"]
        t_op = interop.params_from_jax({
            "filters": np.asarray(j_op.filters), "img_channels": 3,
            "whitener": {"whitener": np.asarray(jw.whitener), "means": np.asarray(jw.means)},
        }, device="cpu")
        assert isinstance(t_op, TConvolver)
        images = np.asarray(jtrain.data.array)[:4]
        np.testing.assert_allclose(_np(t_op.apply(torch.from_numpy(images))),
                                   np.asarray(j_op.apply(images)), rtol=1e-5, atol=1e-4)


class TestRunAgainstReference:
    @pytest.mark.parametrize("which", list(CONFIGS))
    def test_errors(self, which):
        cfg = CONFIGS[which]
        _, jtrain_eval, jtest_eval = jcifar.run_random_patch_cifar_kernel(
            jcifar.CifarConfig(**cfg))
        run = tcifar.run_random_patch_cifar_kernel(tcifar.CifarConfig(**cfg), device="cpu")
        assert run.train_eval.total == 192 and run.test_eval.total == 128
        assert run.train_eval.total_error == jtrain_eval.total_error
        assert run.test_eval.total_error == jtest_eval.total_error
        assert run.test_eval.total_error < 0.5  # chance is 0.9
        assert run.fit_seconds > 0 and run.apply_seconds > 0

    @pytest.mark.parametrize("which", list(CONFIGS))
    def test_scores_from_the_same_filters(self, which):
        cfg = CONFIGS[which]
        (jtrain, jtest), (ttrain, ttest) = _data(cfg)
        jcfg, tcfg = jcifar.CifarConfig(**cfg), tcifar.CifarConfig(**cfg)
        jf, jw = jcifar._sample_whitened_filters(jtrain, jcfg)
        tf = torch.from_numpy(np.asarray(jf))
        tw = interop.zca_whitener(np.asarray(jw.whitener), np.asarray(jw.means), "cpu")
        jlabels = JLabels(10)(jtrain.labels)
        tlabels = TLabels(10)(ttrain.labels)
        jpipe = jcifar._conv_featurizer(jf, jw, jcfg).and_then(
            JStandardScaler(), jtrain.data).and_then(
            jkernel.KernelRidgeRegression(jkernel.GaussianKernelGenerator(jcfg.kernel_gamma),
                                          jcfg.lam, jcfg.block_size, jcfg.num_epochs),
            jtrain.data, jlabels)
        tpipe = tcifar._conv_featurizer(tf, tw, tcfg).and_then(
            TStandardScaler(), ttrain.data).and_then(
            tkernel.KernelRidgeRegression(tkernel.GaussianKernelGenerator(tcfg.kernel_gamma),
                                          tcfg.lam, tcfg.block_size, tcfg.num_epochs),
            ttrain.data, tlabels)
        want = np.asarray(jpipe.apply(jtest.data).get().array)
        got = _np(tpipe.fit().apply(ttest.data).array)
        assert got.shape == want.shape == (128, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# Plan parity and the chunked featurizer
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
    cifar, Scaler, KRR, Gen, Labels, Max = (
        (jcifar, JStandardScaler, jkernel.KernelRidgeRegression, jkernel.GaussianKernelGenerator,
         JLabels, JMaxClassifier) if package == "jax" else
        (tcifar, TStandardScaler, tkernel.KernelRidgeRegression,
         tkernel.GaussianKernelGenerator, TLabels, TMaxClassifier))
    cfg = cifar.CifarConfig(**dict(CFG, synthetic_n=48, whitener_size=60, num_filters=4))
    train, _, _ = (cifar._load(cfg) if package == "jax"
                   else cifar._load(cfg, torch.device("cpu")))
    filters, whitener = cifar._sample_whitened_filters(train, cfg)
    pipe = cifar._conv_featurizer(filters, whitener, cfg).and_then(
        Scaler(), train.data).and_then(
        KRR(Gen(cfg.kernel_gamma), cfg.lam, cfg.block_size, cfg.num_epochs),
        train.data, Labels(10)(train.labels)).and_then(Max())
    return {
        "under fit()": pipe.executor.graph,
        "under apply-first": pipe.apply(train.data).executor.graph,
    }


FUSED = "Fused[Convolver > SymmetricRectifier > Pooler > ImageVectorizer]"


class TestPlanParity:
    @pytest.fixture(scope="class")
    def plans(self):
        TPipelineEnv.get_or_create().reset()
        JPipelineEnv.get_or_create().reset()
        j = {k: _plan(JDefaultOptimizer(), g) for k, g in _compositions("jax").items()}
        t = {k: _plan(TDefaultOptimizer(), g) for k, g in _compositions("torch").items()}
        return j, t

    @pytest.mark.parametrize("which", ["under fit()", "under apply-first"])
    def test_same_rewrite_node_for_node(self, plans, which):
        j, t = plans
        assert t[which] == j[which]

    def test_featurizer_is_one_fused_node(self, plans):
        _, t = plans
        labels = [label for label, _ in t["under apply-first"].values()]
        assert labels.count(FUSED) == 1  # the train featurization, shared by fit and apply
        assert "KernelRidgeRegression" in labels and "Cacher" in labels


class TestChunkedFeaturizer:
    @pytest.fixture
    def featurizer(self):
        (_, _), (ttrain, _) = _data(dict(CFG, synthetic_n=40))
        cfg = tcifar.CifarConfig(**dict(CFG, synthetic_n=40, whitener_size=60))
        filters, whitener = tcifar._sample_whitened_filters(ttrain, cfg)
        graph = tcifar._conv_featurizer(filters, whitener, cfg).executor.graph
        plan, _ = TDefaultOptimizer().execute(graph, {})
        (fused,) = [op for op in plan.operators.values()
                    if isinstance(op, tfusion.FusedBatchTransformer)]
        return fused, ttrain.data

    @pytest.mark.parametrize("rows", [1, 3, 39, 40])
    def test_chunked_equals_unchunked(self, featurizer, monkeypatch, rows):
        fused, data = featurizer
        fns = [m.device_fn() for m in fused.members]
        whole = tfusion._compose(fns, data.array)
        per_row = 4 * (32 * 32 * 3 + 27 * 27 * 24 + 27 * 27 * 48 + 2 * 3 * 3 * 48)
        monkeypatch.setattr(tfusion, "CHUNK_BUDGET_BYTES", rows * per_row)
        calls = []
        conv = fns[0]
        monkeypatch.setattr(fused.members[0], "device_fn",
                            lambda: lambda X: calls.append(X.shape[0]) or conv(X))
        out = fused.batch_apply(data)
        # A one-row probe, then every row (the first again) in chunks.
        assert calls == [1] + [min(rows, 40 - s) for s in range(0, 40, rows)]
        assert out.array.shape == whole.shape == (40, 3 * 3 * 48)
        np.testing.assert_allclose(_np(out.array), _np(whole), rtol=1e-6, atol=1e-5)

    def test_pipeline_results_do_not_depend_on_the_budget(self, monkeypatch):
        cfg = tcifar.CifarConfig(**dict(CFG, synthetic_n=64, whitener_size=100))
        wide = tcifar.run_random_patch_cifar_kernel(cfg, device="cpu")
        TPipelineEnv.get_or_create().reset()
        monkeypatch.setattr(tfusion, "CHUNK_BUDGET_BYTES", 5 << 20)  # a few images a chunk
        narrow = tcifar.run_random_patch_cifar_kernel(cfg, device="cpu")
        assert narrow.train_eval.total_error == wide.train_eval.total_error
        assert narrow.test_eval.total_error == wide.test_eval.total_error


class TestEntryPoint:
    def test_cli(self, capsys):
        trun.main(["RandomPatchCifarKernel", "--device", "cpu", "--syntheticN", "64",
                   "--numFilters", "8", "--whitenerSize", "100", "--blockSize", "32"])
        out = capsys.readouterr().out
        assert "TRAIN Error is" in out and "TEST Error is" in out

    def test_cli_is_registered_by_name(self):
        assert trun.resolve("RandomPatchCifarKernel") is trun.resolve(
            "keystone_tpu.pipelines.RandomPatchCifarKernel")
        with pytest.raises(SystemExit, match="Known pipelines"):
            trun.resolve("RandomPatchCifarWide")  # no such pipeline
