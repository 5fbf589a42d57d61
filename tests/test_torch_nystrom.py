"""Nyström kernel ridge regression of the port
(keystone_tpu_torch/ops/learning/kernel.py: NystromKernelRidge,
NystromKernelMapper, _nystrom_fit_kernel) against the JAX package on the CPU.

Both packages pick the same landmarks: k-means++ centres from the same
numpy seeding draws and the same float64 Lloyd iterations, or m distinct
rows from numpy's ``default_rng(seed).choice``. The port's kernel blocks
are ``gaussian_kernel_block``'s plain version for float32 rows and the same
formula in float64 for float64 rows; the reference runs its XLA path.

The port assembles and solves the m x m normal equations in float64
(ROADMAP C.7); the reference does both in the rows' dtype. On
well-conditioned systems that moves float32 α by float32 rounding only, so
float32 is held to 1e-4 relative (the reference's own float32 α reads
1e-5 to 9e-5 from the float64 solve here) and float64 to 1e-10. On
standardised CIFAR features the system's condition number is about 1e6:
there the reference's float32 α is far from the float64 solve while the
port's satisfies the float64 equations, and the two packages' predictions
still agree to 1e-4.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning import kernel as tkernel
from keystone_tpu_torch.workflow import PipelineEnv as TPipelineEnv

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import kernel as jkernel

GAMMA, LAM, M = 0.05, 1.0, 40


def _rows(n=300, d=20, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    Y = 2.0 * np.eye(k)[rng.integers(0, k, n)] - 1.0
    return X, Y


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _fit_both(X, Y, dtype, kmeans, n=None, m=M, lam=LAM, gamma=GAMMA, seed=3):
    """The reference's and the port's fitted mappers on the same rows cast
    to ``dtype`` (``n`` true rows of them; the rest are padding)."""
    Xd, Yd = X.astype(dtype), Y.astype(dtype)
    n = X.shape[0] if n is None else n
    j = jkernel.NystromKernelRidge(jkernel.GaussianKernelGenerator(gamma), lam, m,
                                   kmeans_landmarks=kmeans, seed=seed).fit(
        JDataset(Xd, n=n), JDataset(Yd, n=n))
    t = tkernel.NystromKernelRidge(tkernel.GaussianKernelGenerator(gamma), lam, m,
                                   kmeans_landmarks=kmeans, seed=seed).fit(
        TDataset(torch.from_numpy(Xd), n=n), TDataset(torch.from_numpy(Yd), n=n))
    return j, t


KINDS = {"k-means++": True, "uniform": False}
DTYPES = {"float32": (np.float32, 1e-4), "float64": (np.float64, 1e-10)}


class TestAgainstReference:
    @pytest.mark.parametrize("kind", list(KINDS))
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_landmarks_alpha_and_outputs(self, kind, dtype):
        np_dtype, tol = DTYPES[dtype]
        X, Y = _rows()
        j, t = _fit_both(X, Y, np_dtype, KINDS[kind])
        assert t.landmarks.dtype == t.alpha.dtype == getattr(torch, dtype)
        assert tuple(t.landmarks.shape) == (M, 20) and tuple(t.alpha.shape) == (M, 3)
        np.testing.assert_allclose(_np(t.landmarks), np.asarray(j.landmarks), rtol=0,
                                   atol=1e-12 if dtype == "float64" else 1e-6)
        assert _rel(_np(t.alpha), np.asarray(j.alpha)) <= tol
        Xt, _ = _rows(50, seed=9)
        Xt = Xt.astype(np_dtype)
        want = np.asarray(j.batch_apply(JDataset(Xt)).array)
        got = _np(t.batch_apply(TDataset(torch.from_numpy(Xt))).array)
        assert got.shape == want.shape == (50, 3)
        assert _rel(got, want) <= tol
        np.testing.assert_allclose(_np(t.apply(torch.from_numpy(Xt[0]))), want[0], rtol=0,
                                   atol=tol * np.abs(want).max())

    @pytest.mark.parametrize("kind", list(KINDS))
    def test_padding_rows_are_masked(self, kind):
        # 260 true rows and 40 zero rows of padding in both packages: the
        # padding's kernel values exp(-γ‖l‖²) are masked out of the fit,
        # which equals the fit on the 260 rows alone.
        X, Y = _rows()
        X[260:], Y[260:] = 0.0, 0.0
        j, t = _fit_both(X, Y, np.float64, KINDS[kind], n=260)
        alone = tkernel.NystromKernelRidge(tkernel.GaussianKernelGenerator(GAMMA), LAM, M,
                                           kmeans_landmarks=KINDS[kind], seed=3).fit(
            TDataset(torch.from_numpy(X[:260])), TDataset(torch.from_numpy(Y[:260])))
        assert _rel(_np(t.alpha), np.asarray(j.alpha)) <= 1e-10
        assert _rel(_np(t.alpha), _np(alone.alpha)) <= 1e-10
        out = t.batch_apply(TDataset(torch.from_numpy(X), n=260)).array
        assert float(out[260:].abs().max()) == 0.0

    def test_fewer_rows_than_landmarks(self):
        X, Y = _rows(30)
        j, t = _fit_both(X, Y, np.float64, False)
        assert t.landmarks.shape[0] == 30
        assert _rel(_np(t.alpha), np.asarray(j.alpha)) <= 1e-10

    def test_carried_model_applies_as_the_reference(self):
        X, Y = _rows()
        j, _ = _fit_both(X, Y, np.float32, True)
        t = tkernel.NystromKernelMapper(torch.from_numpy(np.array(j.landmarks)),
                                        torch.from_numpy(np.array(j.alpha)), GAMMA)
        Xt = _rows(50, seed=9)[0].astype(np.float32)
        want = np.asarray(j.batch_apply(JDataset(Xt)).array)
        got = _np(t.batch_apply(TDataset(torch.from_numpy(Xt))).array)
        assert _rel(got, want) <= 1e-5


class TestRoute:
    def test_landmark_blocks_go_through_the_kernel_wrapper(self, monkeypatch):
        # float32 rows reach gaussian_kernel_block twice a fit (K(X, L),
        # K(L, L)) and once an apply; float64 rows never (the CUDA kernel is
        # float32 or bf16).
        calls = []
        fn = cuda_ops.gaussian_kernel_block

        def logged(X, Y, *args, **kwargs):
            calls.append((X.shape[0], Y.shape[0]))
            return fn(X, Y, *args, **kwargs)

        monkeypatch.setattr(cuda_ops, "gaussian_kernel_block", logged)
        X, Y = _rows()
        _, t = _fit_both(X, Y, np.float32, False)
        t.batch_apply(TDataset(torch.from_numpy(X[:7].astype(np.float32))))
        assert calls == [(300, M), (M, M), (7, M)]
        calls.clear()
        _fit_both(X, Y, np.float64, False)
        assert calls == []

    def test_weight_and_dtype_rules(self):
        est = tkernel.NystromKernelRidge(tkernel.GaussianKernelGenerator(GAMMA), LAM, M)
        assert est.weight == 2
        # "bf16x3" (ROADMAP A.8) is ported; Nyström ignores the kernel
        # dtype, as the reference's does.
        assert tkernel.GaussianKernelGenerator(GAMMA, "bf16x3").kernel_dtype == "bf16x3"
        with pytest.raises(ValueError, match="kernel_dtype"):
            tkernel.GaussianKernelGenerator(GAMMA, "f16")

    def test_in_a_pipeline(self):
        TPipelineEnv.get_or_create().reset()
        from keystone_tpu_torch.ops.stats import StandardScaler

        X, Y = _rows()
        data = TDataset(torch.from_numpy(X.astype(np.float32)))
        pipe = StandardScaler().with_data(data).and_then(
            tkernel.NystromKernelRidge(tkernel.GaussianKernelGenerator(GAMMA), LAM, M,
                                       kmeans_landmarks=False),
            data, TDataset(torch.from_numpy(Y.astype(np.float32))))
        out = pipe.fit().apply(data).array
        assert tuple(out.shape) == (300, 3) and bool(torch.isfinite(out).all())
        TPipelineEnv.get_or_create().reset()


class TestIllConditioned:
    """ROADMAP C.7 on standardised CIFAR features (600 synthetic images,
    100 whitened filters, 64 landmarks: condition number about 1e6)."""

    @pytest.fixture(scope="class")
    def features(self):
        from keystone_tpu_torch.ops.stats import StandardScaler
        from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels
        from keystone_tpu_torch.pipelines import cifar

        TPipelineEnv.get_or_create().reset()
        config = cifar.CifarConfig(synthetic_n=600)
        train, test, _ = cifar._load(config, torch.device("cpu"))
        filters, whitener = cifar._sample_whitened_filters(train, config)
        feat = cifar._conv_featurizer(filters, whitener, config).and_then(
            StandardScaler(), train.data)
        F = _np(feat.apply(train.data).get().array)
        Ft = _np(feat.apply(test.data).get().array)
        Y = _np(ClassLabelIndicatorsFromIntLabels(10)(train.labels).array)
        TPipelineEnv.get_or_create().reset()
        return F, Ft, Y

    @pytest.mark.parametrize("kind", list(KINDS))
    def test_port_solves_the_float64_equations_and_predicts_as_the_reference(
            self, features, kind):
        F, Ft, Y = features
        j, t = _fit_both(F, Y, np.float32, KINDS[kind], m=64, lam=10.0, gamma=5e-4, seed=0)
        L = t.landmarks
        Ftt = torch.from_numpy(F)
        K = cuda_ops.gaussian_kernel_block(Ftt, L, (Ftt * Ftt).sum(1), (L * L).sum(1),
                                           5e-4).double()
        Kmm = cuda_ops.gaussian_kernel_block(L, L, (L * L).sum(1), (L * L).sum(1),
                                             5e-4).double()
        lhs = K.T @ K + 10.0 * Kmm
        lhs += 1e-6 * (torch.trace(lhs) / 64 + 1.0) * torch.eye(64, dtype=torch.float64)
        alpha64 = _np(torch.linalg.solve(lhs, K.T @ torch.from_numpy(Y).double()))
        assert _rel(_np(t.alpha), alpha64) <= 1e-6
        assert _rel(np.asarray(j.alpha), alpha64) > 1e-3  # the reference's float32 solve
        want = np.asarray(j.batch_apply(JDataset(Ft)).array)
        got = _np(t.batch_apply(TDataset(torch.from_numpy(Ft))).array)
        assert _rel(got, want) <= 1e-4
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
