"""The port's Gaussian kernel ridge regression (keystone_tpu_torch/ops/
learning/kernel.py) and its two kernels' plain versions
(ops/cuda_ops.py: gaussian_kernel_block, gaussian_resid_block) against the
JAX package.

Inputs are numpy draws from a seeded generator, float32 on both sides. The
plain versions are held against the reference's Pallas kernels in
interpret mode at ragged shapes; the fit against the reference's fit on
the CPU, by its XLA path (its default there) and, once, by its Pallas path
in interpret mode (``KEYSTONE_PALLAS=1``).

Tolerances, with their reasons:
  - kernel entries: 1e-5 absolute — K lies in [0, 1], and the two float32
    cross terms sum d products in different orders;
  - residuals: 1e-5 of the sum's scale (max over entries of K ᵀ|W|);
  - the weight stack: 1e-4 relative (Frobenius) — a few Gauss-Seidel
    sweeps of float32 Cholesky solves, each entry's rounding carried
    through the later blocks' right-hand sides;
  - the port's own runs against themselves (checkpoint resume): bitwise.
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import kernel as tkernel

import jax
import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops import pallas_ops
from keystone_tpu.ops.learning import kernel as jkernel

N, D, K, BS, EPOCHS = 300, 12, 4, 64, 3  # 5 blocks, the last one 44 rows
GAMMA, LAM = 0.05, 0.2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _gauss_inputs(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    return X, Y, (X * X).sum(1), (Y * Y).sum(1)


def _problem(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    Y = rng.normal(size=(n, K)).astype(np.float32)
    return X, Y


def _j_est(**kw):
    kdtype = kw.pop("kernel_dtype", "f32")
    return jkernel.KernelRidgeRegression(
        jkernel.GaussianKernelGenerator(GAMMA, kdtype), LAM, BS, EPOCHS, **kw)


def _t_est(**kw):
    kdtype = kw.pop("kernel_dtype", "f32")
    return tkernel.KernelRidgeRegression(
        tkernel.GaussianKernelGenerator(GAMMA, kdtype), LAM, BS, EPOCHS, **kw)


def _j_fit(X, Y, **kw):
    return _j_est(**kw).fit(JDataset.of(X), JDataset.of(Y))


def _t_fit(X, Y, **kw):
    return _t_est(**kw).fit(TDataset(_t(X)), TDataset(_t(Y)))


def _weights(model):
    return np.stack([np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
                     for w in model.w_locals])


GAUSS_SHAPES = [(37, 45, 23), (200, 130, 70), (129, 257, 9), (1, 1, 1)]


class TestGaussianKernelsAgainstPallas:
    @pytest.mark.parametrize("m,n,d", GAUSS_SHAPES)
    def test_kernel_block_f32(self, m, n, d):
        X, Y, xn, yn = _gauss_inputs(m, n, d)
        want = np.asarray(pallas_ops.gaussian_kernel_block(X, Y, xn, yn, 0.07, interpret=True))
        got = cuda_ops.gaussian_kernel_block_ref(_t(X), _t(Y), _t(xn), _t(yn), 0.07)
        assert got.shape == (m, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    def test_kernel_block_bf16_operands(self):
        X, Y, xn, yn = _gauss_inputs(200, 130, 70, seed=1)
        want = np.asarray(pallas_ops.gaussian_kernel_block(
            X, Y, xn, yn, 0.07, compute_dtype=jnp.bfloat16, interpret=True))
        got = cuda_ops.gaussian_kernel_block_ref(
            _t(X), _t(Y), _t(xn), _t(yn), 0.07, compute_dtype=torch.bfloat16)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    def test_diagonal_block_is_clamped(self):
        # sq rounds to either side of 0 on the diagonal of K(X, X): the
        # clamp turns the negative ones into exactly 1, never above.
        X, _, xn, _ = _gauss_inputs(64, 1, 30, seed=2)
        X, xn = _t(X) * 50, _t(xn) * 2500
        got = cuda_ops.gaussian_kernel_block_ref(X, X, xn, xn, 1.0)
        sq = xn[:, None] + xn[None, :] - 2.0 * (X @ X.T)
        assert float(got.max()) <= 1.0
        assert bool((sq.diagonal() < 0).any())
        assert torch.equal(got.diagonal()[sq.diagonal() <= 0],
                           torch.ones(int((sq.diagonal() <= 0).sum())))

    @pytest.mark.parametrize("m,n,d,k", [(96, 40, 30, 5), (300, 129, 17, 1), (517, 200, 12, 35)])
    def test_resid_block(self, m, n, d, k):
        X, Y, xn, yn = _gauss_inputs(m, n, d, seed=3)
        W = np.random.default_rng(4).normal(size=(m, k)).astype(np.float32)
        want = np.asarray(pallas_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.07, interpret=True))
        got = cuda_ops.gaussian_resid_block_ref(_t(X), _t(Y), _t(xn), _t(yn), _t(W), 0.07)
        Kt = cuda_ops.gaussian_kernel_block_ref(_t(X), _t(Y), _t(xn), _t(yn), 0.07).T
        scale = float((Kt @ _t(np.abs(W))).max())
        assert got.shape == (n, k)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale

    def test_resid_masks_instead_of_padding(self):
        # The reference pads X and relies on W's ghost rows being zero; the
        # port reads the true rows only. Both give the same residual.
        m, n, d, k, n_true = 64, 32, 16, 3, 50
        X, Y, xn, yn = _gauss_inputs(m, n, d, seed=5)
        W = np.random.default_rng(6).normal(size=(m, k)).astype(np.float32)
        W[n_true:] = 0.0
        want = np.asarray(pallas_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.3, interpret=True))
        got = cuda_ops.gaussian_resid_block(
            _t(X[:n_true]), _t(Y), _t(xn[:n_true]), _t(yn), _t(W[:n_true]), 0.3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    def test_wrappers_take_plain_versions_on_cpu(self):
        X, Y, xn, yn = (_t(a) for a in _gauss_inputs(37, 45, 23, seed=7))
        W = torch.ones((37, 3))
        before = dict(cuda_ops.launches)
        assert torch.equal(cuda_ops.gaussian_kernel_block(X, Y, xn, yn, 0.1),
                           cuda_ops.gaussian_kernel_block_ref(X, Y, xn, yn, 0.1))
        assert torch.equal(cuda_ops.gaussian_resid_block(X, Y, xn, yn, W, 0.1),
                           cuda_ops.gaussian_resid_block_ref(X, Y, xn, yn, W, 0.1))
        assert cuda_ops.launches == before


class TestKernelBlocks:
    def test_transformer_blocks_against_reference(self):
        X, _ = _problem(seed=8)
        test = np.random.default_rng(9).normal(size=(17, D)).astype(np.float32)
        j = jkernel.GaussianKernelGenerator(GAMMA).fit(JDataset.of(X))
        t = tkernel.GaussianKernelGenerator(GAMMA).fit(TDataset(_t(X)))
        for start, size in ((0, BS), (256, BS)):  # a full block and the ragged one
            v = min(size, N - start)
            col = t.column_block(start, size)
            assert col.shape == (N, v)
            np.testing.assert_allclose(col.numpy(), np.asarray(j.column_block(start, v)),
                                       atol=1e-5)
            np.testing.assert_allclose(t.diag_block(start, size).numpy(),
                                       np.asarray(j.diag_block(start, v)), atol=1e-5)
            np.testing.assert_allclose(t.test_block(_t(test), start, size).numpy(),
                                       np.asarray(j.test_block(test, start, v)), atol=1e-5)

    def test_bf16x3_waits_and_unknown_dtypes_raise(self):
        # "bf16x3" is ported (tests/test_torch_krr_mesh.py holds it);
        # unknown dtypes still raise.
        assert tkernel.GaussianKernelGenerator(GAMMA, "bf16x3").kernel_dtype == "bf16x3"
        with pytest.raises(ValueError):
            tkernel.GaussianKernelGenerator(GAMMA, "f16")

    def test_profile_path_waits(self):
        # The stepwise profile path is ported (tests/test_torch_krr_mesh.py):
        # it no longer waits, and it refuses checkpointing as the reference.
        assert _t_est(profile=True).profile is True
        with pytest.raises(ValueError, match="pick one"):
            _t_est(profile=True, checkpoint_path="unused.ckpt")


class TestFitAgainstReference:
    @pytest.mark.parametrize("permuter", [None, 7])
    def test_weight_stack(self, permuter):
        X, Y = _problem()
        want = _weights(_j_fit(X, Y, block_permuter=permuter))
        got = _weights(_t_fit(X, Y, block_permuter=permuter))
        assert got.shape == want.shape == (5, BS, K)
        assert _rel(got, want) < 1e-4
        # The ragged last block's ghost rows solve to exactly zero.
        assert np.all(got[-1, N - 4 * BS:] == 0.0)

    def test_against_the_reference_pallas_path(self, monkeypatch):
        X, Y = _problem(seed=1, n=150)
        monkeypatch.setenv("KEYSTONE_PALLAS", "1")  # interpret-mode dispatch on CPU
        try:
            want = _weights(_j_fit(X, Y))
        finally:
            monkeypatch.delenv("KEYSTONE_PALLAS")
            jax.clear_caches()
        assert _rel(_weights(_t_fit(X, Y)), want) < 1e-4

    def test_bf16_kernel_dtype(self):
        X, Y = _problem(seed=2)
        want = _weights(_j_fit(X, Y, kernel_dtype="bf16"))
        got = _weights(_t_fit(X, Y, kernel_dtype="bf16"))
        assert _rel(got, want) < 1e-4

    def test_one_block_and_zero_epochs(self):
        X, Y = _problem(seed=3, n=50)
        est = tkernel.KernelRidgeRegression(tkernel.GaussianKernelGenerator(GAMMA), LAM, BS, 0)
        assert np.all(_weights(est.fit(TDataset(_t(X)), TDataset(_t(Y)))) == 0.0)
        assert _rel(_weights(_t_fit(X, Y)), _weights(_j_fit(X, Y))) < 1e-4


class TestPredictions:
    def test_mapper_against_reference(self):
        X, Y = _problem(seed=4)
        test = np.random.default_rng(10).normal(size=(33, D)).astype(np.float32)
        jm = _j_fit(X, Y)
        want = np.asarray(jm.batch_apply(JDataset.of(test)).array)
        got = _t_fit(X, Y).batch_apply(TDataset(_t(test)))
        np.testing.assert_allclose(got.array.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        # The reference's fitted model, carried across, predicts the same.
        carried = interop.params_from_jax({
            "w_locals": [np.asarray(w) for w in jm.w_locals], "block_size": BS,
            "train_X": np.asarray(jm.kernel_transformer.train_X)[:N], "gamma": GAMMA,
        }, device="cpu")
        assert isinstance(carried, tkernel.KernelBlockLinearMapper)
        np.testing.assert_allclose(carried.batch_apply(TDataset(_t(test))).array.numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(carried.apply(_t(test[3])), want[3], rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


class _PreemptAfter:
    """os.replace wrapper that completes the Nth checkpoint save, then
    'preempts' (the reference's tests/test_krr_checkpoint.py helper)."""

    def __init__(self, monkeypatch, n_saves: int, path: str):
        self.remaining = n_saves
        self.path = str(path)
        self._real = os.replace
        monkeypatch.setattr(os, "replace", self)

    def __call__(self, src, dst):
        self._real(src, dst)
        if str(dst) != self.path:
            return
        self.remaining -= 1
        if self.remaining == 0:
            raise KeyboardInterrupt("simulated preemption after save")


class TestCheckpointResume:
    @pytest.mark.parametrize("permuter", [None, 7])
    def test_preempted_fit_resumes_bit_identically(self, tmp_path, monkeypatch, permuter):
        X, Y = _problem()
        ref = _weights(_t_fit(X, Y, block_permuter=permuter))
        path = str(tmp_path / "krr.ckpt")
        _PreemptAfter(monkeypatch, n_saves=3, path=path)
        with pytest.raises(KeyboardInterrupt):
            _t_fit(X, Y, block_permuter=permuter, checkpoint_path=path,
                   checkpoint_every_blocks=2)
        monkeypatch.undo()
        with np.load(path, allow_pickle=False) as ck:
            assert int(ck["pos"]) == 6  # 3 completed saves x 2 blocks each
        out = _weights(_t_fit(X, Y, block_permuter=permuter, checkpoint_path=path,
                              checkpoint_every_blocks=2))
        np.testing.assert_array_equal(out, ref)
        assert not os.path.exists(path)  # removed on completion

    def test_segmented_fit_matches_unsegmented(self, tmp_path):
        X, Y = _problem()
        path = str(tmp_path / "krr.ckpt")
        out = _weights(_t_fit(X, Y, checkpoint_path=path, checkpoint_every_blocks=4))
        np.testing.assert_array_equal(out, _weights(_t_fit(X, Y)))
        assert not os.path.exists(path)

    @pytest.mark.parametrize("change", ["gamma", "data"])
    def test_foreign_checkpoint_is_rejected(self, tmp_path, monkeypatch, change):
        X, Y = _problem()
        path = str(tmp_path / "krr.ckpt")
        _PreemptAfter(monkeypatch, n_saves=1, path=path)
        with pytest.raises(KeyboardInterrupt):
            _t_fit(X, Y, checkpoint_path=path, checkpoint_every_blocks=2)
        monkeypatch.undo()
        if change == "gamma":
            other = tkernel.KernelRidgeRegression(
                tkernel.GaussianKernelGenerator(GAMMA * 2), LAM, BS, EPOCHS,
                checkpoint_path=path)
            with pytest.raises(ValueError, match="different KRR fit"):
                other.fit(TDataset(_t(X)), TDataset(_t(Y)))
        else:
            X2, Y2 = _problem(seed=1)
            with pytest.raises(ValueError, match="different KRR fit"):
                _t_fit(X2, Y2, checkpoint_path=path, checkpoint_every_blocks=2)

    def test_checkpointed_fit_against_reference(self, tmp_path):
        X, Y = _problem(seed=5)
        want = _weights(_j_fit(X, Y, checkpoint_path=str(tmp_path / "j.ckpt"),
                               checkpoint_every_blocks=2))
        got = _weights(_t_fit(X, Y, checkpoint_path=str(tmp_path / "t.ckpt"),
                              checkpoint_every_blocks=2))
        assert _rel(got, want) < 1e-4
