"""The port's MnistRandomFFT slice against the JAX package, on the CPU.

Both sides featurize the same rows (numpy-seeded synthetic MNIST, or
scikit-learn's digits, bit-identical in both packages) with the same sign
vectors: the reference's ``jax.random.rademacher`` signs are carried into
the port through ``keystone_tpu_torch.interop``. Inputs are float32 on
both sides; under tests/conftest.py's x64 the reference's block solve runs
in float64 on the float64 rows its loaders give, a stricter reference than
the port's float32.

Tolerances and why:
  - sign flips and rectifiers: exact (a multiply by ±1, a max).
  - padded FFT and the packed gather: 1e-4 absolute on rows of standard
    normals (bins of size up to about 30): float32 FFTs of width up to
    1,024 in other orders (pocketfft and XLA), about 1e-6 of a bin's size.
  - block weights: relative Frobenius error <= 1e-4 (measured 1.3e-5 on
    synthetic rows, 2.6e-5 on the digits): one epoch of the block solve in
    float32 against float64 on well-conditioned Gramians.
  - train and test error: equal (no label flips at these margins).
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.data import loaders as t_loaders
from keystone_tpu_torch.ops import stats as t_stats
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper as TBlockLinearMapper
from keystone_tpu_torch.ops.util import VectorCombiner as TVectorCombiner
from keystone_tpu_torch.pipelines import mnist_random_fft as t_mnist
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv
from keystone_tpu_torch.workflow.fusion import FusedGatherTransformer as TFusedGather

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.data import loaders as j_loaders
from keystone_tpu.ops import stats as j_stats
from keystone_tpu.ops.learning.block import BlockLinearMapper as JBlockLinearMapper
from keystone_tpu.ops.util import VectorCombiner as JVectorCombiner
from keystone_tpu.pipelines import mnist_random_fft as j_mnist
from keystone_tpu.workflow import PipelineEnv as JPipelineEnv
from keystone_tpu.workflow.fusion import FusedGatherTransformer as JFusedGather

WEIGHT_TOL = 1e-4
FFT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def clean_envs():
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()
    yield
    TPipelineEnv.get_or_create().reset()
    JPipelineEnv.get_or_create().reset()


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _signs(d, count, seed0=0):
    """The reference's sign draws, as numpy."""
    return [np.asarray(j_stats.RandomSignNode.create(d, seed=seed0 + i).signs)
            for i in range(count)]


def _branches(signs, alphas=None):
    """The same branches in both packages: (reference, port)."""
    alphas = alphas or [0.0] * len(signs)
    j = [[j_stats.RandomSignNode(jnp.asarray(s)), j_stats.PaddedFFT(),
          j_stats.LinearRectifier(0.0, alpha=a)] for s, a in zip(signs, alphas)]
    t = [[interop.random_sign_node(s, device="cpu"), t_stats.PaddedFFT(),
          t_stats.LinearRectifier(0.0, alpha=a)] for s, a in zip(signs, alphas)]
    return j, t


def _mapper(fitted, cls):
    (m,) = [o for o in fitted.transformer_graph.operators.values() if isinstance(o, cls)]
    return m


class TestNodes:
    def test_random_sign_node_applies_the_reference_signs(self):
        (signs,) = _signs(100, 1, seed0=3)
        X = _rows(7, 100)
        want = np.asarray(j_stats.RandomSignNode(jnp.asarray(signs)).device_fn()(jnp.asarray(X)))
        node = interop.params_from_jax({"signs": signs}, device="cpu")
        assert isinstance(node, t_stats.RandomSignNode)
        np.testing.assert_array_equal(node.device_fn()(torch.from_numpy(X)).numpy(), want)
        np.testing.assert_array_equal(node.apply(X[0]).numpy(), want[0])

    def test_random_sign_node_create(self):
        a = t_stats.RandomSignNode.create(784, seed=5, device="cpu").signs
        b = t_stats.RandomSignNode.create(784, seed=5, device="cpu").signs
        c = t_stats.RandomSignNode.create(784, seed=6, device="cpu").signs
        assert a.shape == (784,) and a.dtype == torch.float32
        assert set(a.unique().tolist()) == {-1.0, 1.0}
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert abs(float(a.mean())) < 0.15

    @pytest.mark.parametrize("d", [1, 48, 100, 784])
    def test_padded_fft(self, d):
        X = _rows(9, d, seed=d)
        want = np.asarray(j_stats.PaddedFFT().device_fn()(jnp.asarray(X)))
        got = t_stats.PaddedFFT().device_fn()(torch.from_numpy(X)).numpy()
        assert got.shape == want.shape == (9, t_stats.padded_pow2(d) // 2)
        np.testing.assert_allclose(got, want, atol=FFT_ATOL)
        np.testing.assert_allclose(t_stats.PaddedFFT().apply(X[2]).numpy(), want[2],
                                   atol=FFT_ATOL)

    @pytest.mark.parametrize("max_val,alpha", [(0.0, 0.0), (0.5, 0.25), (-1.0, 2.0)])
    def test_linear_rectifier(self, max_val, alpha):
        X = _rows(6, 33)
        want = np.asarray(j_stats.LinearRectifier(max_val, alpha).device_fn()(jnp.asarray(X)))
        got = t_stats.LinearRectifier(max_val, alpha).device_fn()(torch.from_numpy(X))
        np.testing.assert_array_equal(got.numpy(), want)


class TestPackedGather:
    @pytest.mark.parametrize("nb,d_in", [(2, 100), (3, 48), (4, 784), (5, 64)])
    def test_packed_matches_the_reference_and_per_branch_composition(self, nb, d_in):
        signs = _signs(d_in, nb)
        alphas = [0.1 * i for i in range(nb)]
        j_br, t_br = _branches(signs, alphas)
        X = _rows(16, d_in, seed=nb)
        j_fn = j_stats.packed_fft_gather_fn(j_br, JVectorCombiner())
        t_fn = t_stats.packed_fft_gather_fn(t_br, TVectorCombiner())
        assert j_fn is not None and t_fn is not None
        want = np.asarray(j_fn(jnp.asarray(X)))
        got = t_fn(torch.from_numpy(X)).numpy()
        assert got.shape == want.shape == (16, nb * t_stats.padded_pow2(d_in) // 2)
        np.testing.assert_allclose(got, want, atol=FFT_ATOL)
        per_branch = []
        for br in t_br:
            b = torch.from_numpy(X)
            for m in br:
                b = m.device_fn()(b)
            per_branch.append(b.numpy())
        np.testing.assert_allclose(got, np.concatenate(per_branch, axis=-1), atol=FFT_ATOL)

    def test_fused_gather_engages_the_packed_path(self):
        _, t_br = _branches(_signs(64, 4))
        fg = TFusedGather(t_br, TVectorCombiner())
        assert fg.uses_packed_fft
        X = _rows(8, 64)
        out = fg.batch_apply(TDataset(torch.from_numpy(X))).array.numpy()
        j_br, _ = _branches(_signs(64, 4))
        want = np.asarray(JFusedGather(j_br, JVectorCombiner()).batch_apply(
            JDataset.of(jnp.asarray(X))).array)
        np.testing.assert_allclose(out, want, atol=FFT_ATOL)

    def test_other_gathers_fall_back(self):
        _, t_br = _branches(_signs(32, 2))
        short = [br[:2] for br in t_br]
        assert t_stats.packed_fft_gather_fn(short, TVectorCombiner()) is None
        assert t_stats.packed_fft_gather_fn(t_br[:1], TVectorCombiner()) is None
        fg = TFusedGather(short, TVectorCombiner())
        assert not fg.uses_packed_fft
        out = fg.batch_apply(TDataset(torch.from_numpy(_rows(4, 32)))).array
        assert out.shape == (4, 2 * 16)

    def test_mixed_widths_fall_back(self):
        _, a = _branches(_signs(32, 1))
        _, b = _branches(_signs(40, 1))
        assert t_stats.packed_fft_gather_fn(a + b, TVectorCombiner()) is None

    def test_mnist_featurizer_plan_is_the_references(self):
        # Stage fusion then gather fusion: one packed FusedGather node, as
        # in the reference's optimized plan.
        X = _rows(8, 48)
        j_cfg = j_mnist.MnistRandomFFTConfig(num_ffts=4, block_size=32, image_size=48)
        handle = j_mnist.build_featurizer(j_cfg).apply(JDataset.of(jnp.asarray(X)))
        j_out = np.asarray(handle.get().array)
        j_graph = handle.executor.optimized_graph
        j_labels = sorted(type(j_graph.get_operator(n)).__name__ for n in j_graph.nodes)
        t_cfg = t_mnist.MnistRandomFFTConfig(num_ffts=4, block_size=32, image_size=48)
        nodes = [interop.random_sign_node(s, device="cpu") for s in _signs(48, 4)]
        t_handle = t_mnist.build_featurizer(t_cfg, sign_nodes=nodes).apply(
            TDataset(torch.from_numpy(X)))
        t_out = t_handle.get().array.numpy()
        t_graph = t_handle.executor._ensure_optimized()
        t_ops = [t_graph.get_operator(n) for n in t_graph.nodes]
        assert sorted(type(o).__name__ for o in t_ops) == j_labels
        fgs = [o for o in t_ops if isinstance(o, TFusedGather)]
        assert len(fgs) == 1 and fgs[0].uses_packed_fft
        assert fgs[0].label.count(" | ") == 3
        np.testing.assert_allclose(t_out, j_out, atol=FFT_ATOL)


def _run_both(config, image_size):
    """The slice on both packages with the reference's signs; the port's
    also fitted first. Returns numpy results of each."""
    JPipelineEnv.get_or_create().reset()
    pipe, j_train, j_test = j_mnist.run(j_mnist.MnistRandomFFTConfig(**config))
    j_W = np.concatenate([np.asarray(x) for x in _mapper(pipe.fit(), JBlockLinearMapper).xs])
    JPipelineEnv.get_or_create().reset()
    signs = _signs(image_size, config["num_ffts"], seed0=config.get("seed", 0))
    out = dict(j_W=j_W, j_err=(j_train.total_error, j_test.total_error))
    for fit_first in (False, True):
        TPipelineEnv.get_or_create().reset()
        nodes = [interop.random_sign_node(s, device="cpu") for s in signs]
        r = t_mnist.run(t_mnist.MnistRandomFFTConfig(**config), device="cpu", sign_nodes=nodes,
                        fit_first=fit_first)
        key = "fit_first" if fit_first else "apply_first"
        out[key] = dict(
            W=np.concatenate([x.numpy() for x in _mapper(r.fitted, TBlockLinearMapper).xs]),
            err=(r.train_eval.total_error, r.test_eval.total_error),
            seconds=(r.fit_seconds, r.apply_seconds))
    TPipelineEnv.get_or_create().reset()
    return out


RUNS = {
    "synthetic": (dict(num_ffts=2, block_size=512, synthetic_n=2048), 784),
    "synthetic, 3 FFTs, lambda": (dict(num_ffts=3, block_size=512, synthetic_n=2048, lam=1e-2),
                                  784),
    "digits": (dict(use_digits=True, image_size=64, num_ffts=4, block_size=2048), 64),
}


@pytest.fixture(scope="module", params=list(RUNS))
def slice_runs(request):
    return request.param, _run_both(*RUNS[request.param])


class TestMnistSliceAgainstJax:
    @pytest.mark.parametrize("route", ["apply_first", "fit_first"])
    def test_block_weights(self, slice_runs, route):
        _, r = slice_runs
        got = r[route]["W"]
        assert got.shape == r["j_W"].shape
        rel = np.linalg.norm(got - r["j_W"]) / np.linalg.norm(r["j_W"])
        assert rel <= WEIGHT_TOL, rel

    @pytest.mark.parametrize("route", ["apply_first", "fit_first"])
    def test_errors(self, slice_runs, route):
        _, r = slice_runs
        assert r[route]["err"] == pytest.approx(r["j_err"], abs=0.0)
        assert all(s > 0 for s in r[route]["seconds"])


class TestLoadersAndCli:
    def test_synthetic_mnist_rows_are_bit_identical(self):
        j = j_loaders.synthetic_mnist(300, seed=7)
        t = t_loaders.synthetic_mnist(300, seed=7, device="cpu")
        np.testing.assert_array_equal(t.data.to_numpy(),
                                      np.asarray(j.data.array, dtype=np.float32))
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))
        assert t.data.to_numpy().shape == (300, 784)

    def test_load_digits_real(self):
        j_train, j_test = j_loaders.load_digits_real(seed=3)
        t_train, t_test = t_loaders.load_digits_real(seed=3, device="cpu")
        for j, t in ((j_train, t_train), (j_test, t_test)):
            np.testing.assert_array_equal(t.data.to_numpy(),
                                          np.asarray(j.data.array, dtype=np.float32))
            np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))

    def test_labeled_csv_takes_the_label_offset(self, tmp_path):
        rows = np.array([[1, 0.5, 2.0], [10, -1.0, 3.5], [3, 0.0, 0.25]])
        path = tmp_path / "mnist.csv"
        np.savetxt(path, rows, delimiter=",")
        j = j_loaders.load_labeled_csv(str(path), label_offset=-1)
        t = t_loaders.load_labeled_csv(str(path), label_offset=-1, device="cpu")
        np.testing.assert_array_equal(t.labels.to_numpy(), [0, 9, 2])
        np.testing.assert_array_equal(t.labels.to_numpy(), np.asarray(j.labels.array))
        np.testing.assert_array_equal(t.data.to_numpy(), rows[:, 1:].astype(np.float32))

    def test_csv_loader_reads_a_directory_in_file_order(self, tmp_path):
        np.savetxt(tmp_path / "b.csv", np.ones((2, 3)), delimiter=",")
        np.savetxt(tmp_path / "a.csv", np.zeros((1, 3)), delimiter=",")
        (tmp_path / "_SUCCESS").write_text("")
        got = t_loaders.csv_data_loader(str(tmp_path), device="cpu").to_numpy()
        want = np.asarray(j_loaders.csv_data_loader(str(tmp_path)).array)
        np.testing.assert_array_equal(got, want.astype(np.float32))
        assert got.shape == (3, 3)

    def test_run_raises_without_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            t_mnist.run(t_mnist.MnistRandomFFTConfig(synthetic_n=256))

    def test_cli_runs_on_the_cpu(self, capsys):
        from keystone_tpu_torch import run as t_run

        t_run.main(["MnistRandomFFT", "--numFFTs", "2", "--blockSize", "512", "--syntheticN",
                    "1024", "--lambda", "1e-2", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "TRAIN Error is" in out and "TEST Error is" in out
