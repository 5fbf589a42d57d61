"""The port's PCA family, TSQR, k-means++, GMM and the class-weighted block
solver (BWLS) against the JAX package, on the CPU.

Inputs are numpy-seeded and float64 on both sides (tests/conftest.py runs
the reference under x64); the port gets float64 tensors.

Tolerances and why:
  - PCA, all five estimators and the two column forms: 1e-6 absolute on
    unit-norm directions, compared after the matlab sign convention (both
    packages apply it), on data whose singular values are well separated;
    the approximate estimator draws its test matrix from a
    ``torch.Generator`` (the reference from ``jax.random``), so it is held
    to the exact directions, to which q = 10 power iterations converge.
  - k-means++: the same centres picked (the reference's numpy draws, the
    distances on either side), Lloyd's means to 1e-6 relative, the same
    number of iterations.
  - GMM: the same k-means++ picks, means, variances and weights to 1e-6
    relative, the same EM iteration count, no restart fired; the restart
    itself is held to its own terms (distinct data points, the data's
    variance, renormalised weights), since its draws are the generator's.
  - BWLS: weights, intercept and scores 1e-6 relative on float64 rows,
    1e-5 on float32.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch import interop
from keystone_tpu_torch.data import Dataset as TDataset
from keystone_tpu_torch.ops.learning import clustering as t_clu
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper as TBlockLinearMapper
from keystone_tpu_torch.ops.learning.bwls import BlockWeightedLeastSquaresEstimator as TBWLS
from keystone_tpu_torch.ops.learning import pca as t_pca
from keystone_tpu_torch.parallel import linalg as t_linalg

import jax.numpy as jnp

from keystone_tpu.data import Dataset as JDataset
from keystone_tpu.ops.learning import clustering as j_clu
from keystone_tpu.ops.learning.bwls import BlockWeightedLeastSquaresEstimator as JBWLS
from keystone_tpu.ops.learning import pca as j_pca
from keystone_tpu.parallel import linalg as j_linalg

PCA_ATOL = 1e-6
REL = 1e-6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_fro(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _spread_rows(n, d, seed, spectrum=None):
    """Rows with singular values spread from 6 to 0.5 (or ``spectrum``)
    along a random basis."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    scales = np.linspace(6.0, 0.5, d) if spectrum is None else spectrum
    return rng.normal(size=(n, d)) @ np.diag(scales) @ basis + rng.normal(size=d)


def _blobs(k, d, per, seed, scale=6.0):
    """k well-separated Gaussian blobs of ``per`` rows each, shuffled."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, d))
    X = np.concatenate([c + rng.normal(size=(per, d)) * rng.uniform(0.5, 1.5, size=d)
                        for c in centers])
    return X[rng.permutation(len(X))]


class TestPCA:
    def test_sign_convention(self):
        rng = np.random.default_rng(0)
        M = rng.normal(size=(9, 6))
        want = np.asarray(j_pca.enforce_matlab_sign_convention(jnp.asarray(M)))
        got = t_pca.enforce_matlab_sign_convention(torch.from_numpy(M)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_compute_pca(self):
        X = _spread_rows(300, 10, 1)
        want = np.asarray(j_pca.compute_pca(jnp.asarray(X), 4))
        got = t_pca.compute_pca(torch.from_numpy(X), 4).numpy()
        np.testing.assert_allclose(got, want, atol=PCA_ATOL)

    @pytest.mark.parametrize("name", ["PCAEstimator", "DistributedPCAEstimator"])
    def test_row_estimators(self, name):
        X = _spread_rows(400, 12, 2)
        want = np.asarray(getattr(j_pca, name)(5).fit(JDataset(X)).pca_mat)
        model = getattr(t_pca, name)(5).fit(TDataset(torch.from_numpy(X)))
        assert isinstance(model, t_pca.PCATransformer)
        np.testing.assert_allclose(model.pca_mat.numpy(), want, atol=PCA_ATOL)
        np.testing.assert_allclose(model.apply(torch.from_numpy(X[3])).numpy(), X[3] @ want,
                                   atol=1e-9)

    def test_distributed_rezeroes_padding_rows(self):
        X = _spread_rows(64, 6, 3)
        padded = np.concatenate([X, np.zeros((8, 6))])
        want = np.asarray(j_pca.DistributedPCAEstimator(3).fit(JDataset(padded, n=64)).pca_mat)
        got = t_pca.DistributedPCAEstimator(3).fit(TDataset(torch.from_numpy(padded), n=64))
        np.testing.assert_allclose(got.pca_mat.numpy(), want, atol=PCA_ATOL)

    def test_approximate_estimator(self):
        # A geometric spectrum: the 10 power iterations converge on it
        # (σ_10 / σ_4 ≈ 0.08 at dims + p = 9), so both draws reach the exact
        # directions.
        X = _spread_rows(500, 16, 4, spectrum=np.geomspace(6.0, 0.01, 16))
        exact = t_pca.compute_pca(torch.from_numpy(X), 4).numpy()
        want = np.asarray(j_pca.ApproximatePCAEstimator(4, seed=3).fit(JDataset(X)).pca_mat)
        got = t_pca.ApproximatePCAEstimator(4, seed=3).fit(TDataset(torch.from_numpy(X)))
        np.testing.assert_allclose(want, exact, atol=PCA_ATOL)
        np.testing.assert_allclose(got.pca_mat.numpy(), exact, atol=PCA_ATOL)
        again = t_pca.ApproximatePCAEstimator(4, seed=3).fit(TDataset(torch.from_numpy(X)))
        assert torch.equal(again.pca_mat, got.pca_mat)

    @pytest.mark.parametrize("name", ["LocalColumnPCAEstimator",
                                      "DistributedColumnPCAEstimator"])
    def test_column_estimators(self, name):
        rows = _spread_rows(6 * 40, 12, 5)
        items = rows.reshape(6, 40, 12).transpose(0, 2, 1)  # six (d, cols) items
        want = np.asarray(getattr(j_pca, name)(4).fit(JDataset.of(list(items))).pca_mat)
        for data in (TDataset(torch.from_numpy(items)),
                     TDataset([torch.from_numpy(m) for m in items])):
            model = getattr(t_pca, name)(4).fit(data)
            assert isinstance(model, t_pca.BatchPCATransformer)
            np.testing.assert_allclose(model.pca_mat.numpy(), want, atol=PCA_ATOL)
        out = model.batch_apply(TDataset(torch.from_numpy(items))).array.numpy()
        np.testing.assert_allclose(out, np.einsum("dk,ndc->nkc", want, items), atol=1e-9)

    @pytest.mark.parametrize("machines,cols", [(1, 40), (8, 40), (1, 4000), (64, 4000)])
    def test_column_pca_choice(self, machines, cols):
        # The reference counts len(jax.devices()) unless told; both are told.
        items = np.zeros((3, 128, cols))
        sample_j, sample_t = JDataset.of(list(items)), TDataset(torch.from_numpy(items))
        sample_j.total_n = sample_t.total_n = 5000
        want = j_pca.ColumnPCAEstimator(16, num_machines=machines).optimize(sample_j)
        got = t_pca.ColumnPCAEstimator(16, num_machines=machines).optimize(sample_t)
        assert type(got).__name__ == type(want).__name__

    def test_tsqr_r(self):
        A = _spread_rows(200, 7, 6)
        want = np.asarray(j_linalg.tsqr_r(jnp.asarray(A)))
        got = t_linalg.tsqr_r(torch.from_numpy(A)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-10)
        assert (np.diag(got) >= 0).all()
        np.testing.assert_allclose(got.T @ got, A.T @ A, rtol=1e-10, atol=1e-9)

    def test_interop(self):
        M = np.random.default_rng(7).normal(size=(8, 3))
        plain = interop.params_from_jax({"pca_mat": M}, device="cpu")
        batch = interop.params_from_jax({"pca_mat": M, "batch": True}, device="cpu")
        assert isinstance(plain, t_pca.PCATransformer)
        assert isinstance(batch, t_pca.BatchPCATransformer)
        np.testing.assert_allclose(batch.pca_mat.numpy(), M, rtol=1e-7)


def _capture(monkeypatch, module, name):
    """Wrap ``module.name`` to record the arguments and result of each call."""
    calls = []
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


class TestKMeans:
    @pytest.mark.parametrize("k,seed", [(5, 0), (8, 3)])
    def test_same_picks_and_means(self, monkeypatch, k, seed):
        X = _blobs(k, 4, 120, seed)
        lloyd = _capture(monkeypatch, j_clu, "_lloyd_loop")
        want = j_clu.KMeansPlusPlusEstimator(k, 20, seed=seed).fit_array(X)
        (args, (it, _, _)), = lloyd
        est = t_clu.KMeansPlusPlusEstimator(k, 20, seed=seed)
        centers = est.seed_centers(torch.from_numpy(X))
        np.testing.assert_array_equal(X[centers], np.asarray(args[1]))
        got = est.fit_array(torch.from_numpy(X))
        assert est.iterations == int(it)
        assert _rel(got.means.numpy(), want.means) <= REL

    def test_model_assignments(self):
        X = _blobs(4, 3, 50, 1)
        means = X[:4]
        want = np.asarray(j_clu.KMeansModel(jnp.asarray(means)).assignments(jnp.asarray(X)))
        model = interop.params_from_jax({"means": means}, device="cpu")
        assert isinstance(model, t_clu.KMeansModel)
        np.testing.assert_array_equal(model.assignments(torch.from_numpy(X)).numpy(), want)
        np.testing.assert_array_equal(model.apply(torch.from_numpy(X[7])).numpy(), want[7])

    def test_numpy_input_is_float64(self):
        X = _blobs(3, 2, 30, 2).astype(np.float32)
        model = t_clu.KMeansPlusPlusEstimator(3, 5).fit_array(X)
        assert model.means.dtype == torch.float64


class TestGMM:
    @pytest.mark.parametrize("k,seed", [(4, 0), (6, 1)])
    def test_fit_matches_without_restarts(self, monkeypatch, k, seed):
        X = _blobs(k, 5, 200, seed + 10)
        lloyd = _capture(monkeypatch, j_clu, "_lloyd_loop")
        em = _capture(monkeypatch, j_clu, "_em_loop")
        want = j_clu.GaussianMixtureModelEstimator(k, seed=seed).fit_array(X)
        est = t_clu.GaussianMixtureModelEstimator(k, seed=seed)
        got = est.fit_array(torch.from_numpy(X))
        (lloyd_args, _), = lloyd
        centers = t_clu.KMeansPlusPlusEstimator(k, 10, seed=seed).seed_centers(
            torch.from_numpy(X))
        np.testing.assert_array_equal(X[centers], np.asarray(lloyd_args[1]))
        (_, (it, *_)), = em
        assert est.restarts == 0
        assert est.iterations == int(it)
        for name in ("means", "variances", "weights"):
            assert _rel(getattr(got, name).numpy(), getattr(want, name)) <= REL, name
        assert got.means.shape == (5, k) and got.means.dtype == torch.float64

    def test_random_init(self):
        X = _blobs(3, 4, 150, 4)
        kw = dict(kmeans_init=False, min_cluster_size=5, seed=2)
        want = j_clu.GaussianMixtureModelEstimator(3, **kw).fit_array(X)
        est = t_clu.GaussianMixtureModelEstimator(3, **kw)
        got = est.fit_array(torch.from_numpy(X))
        assert est.restarts == 0
        for name in ("means", "variances", "weights"):
            assert _rel(getattr(got, name).numpy(), getattr(want, name)) <= REL, name

    def test_posteriors_thresholded(self):
        X = _blobs(3, 4, 60, 5)
        gmm = j_clu.GaussianMixtureModelEstimator(3, seed=0).fit_array(X)
        params = {"means": np.asarray(gmm.means), "variances": np.asarray(gmm.variances),
                  "weights": np.asarray(gmm.weights)}
        model = interop.params_from_jax(params, device="cpu")
        assert isinstance(model, t_clu.GaussianMixtureModel)
        want = np.asarray(gmm.posteriors(jnp.asarray(X)))
        got = model.posteriors(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        assert (got[got > 0] > 1e-4).all()
        np.testing.assert_allclose(model.apply(torch.from_numpy(X[2])).numpy(), want[2],
                                   rtol=1e-9, atol=1e-12)
        batched = model.posteriors(torch.from_numpy(X.reshape(2, 90, 4))).numpy()
        np.testing.assert_allclose(batched.reshape(180, 3), got, rtol=1e-12, atol=1e-15)

    def test_load(self, tmp_path):
        rng = np.random.default_rng(0)
        means, variances = rng.normal(size=(3, 2)), rng.uniform(1, 2, size=(3, 2))
        weights = np.array([0.25, 0.75])
        for name, a in (("m", means), ("v", variances), ("w", weights)):
            np.savetxt(tmp_path / f"{name}.csv", np.atleast_2d(a), delimiter=",")
        files = [str(tmp_path / f"{x}.csv") for x in "mvw"]
        want = j_clu.GaussianMixtureModel.load(*files)
        got = t_clu.GaussianMixtureModel.load(*files)
        for name in ("means", "variances", "weights"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        with pytest.raises(ValueError):
            t_clu.GaussianMixtureModel(torch.zeros(3, 2), torch.zeros(2, 2), torch.zeros(2))

    def test_restart_on_its_own_terms(self):
        X = torch.from_numpy(_blobs(4, 3, 25, 6))
        k = 6
        mu = X[:k].clone()
        var = torch.full((k, 3), 0.5, dtype=torch.float64)
        w = torch.full((k,), 0.1, dtype=torch.float64)
        w[0] = 0.5
        small = torch.tensor([False, True, False, True, True, False])
        base_var = X.var(dim=0, unbiased=False) + 1e-6
        gen = torch.Generator().manual_seed(11)
        mu2, var2, w2, count = t_clu.restart_collapsed(X, mu, var, w, small, base_var, gen)
        assert count == 3
        restarted = mu2[small]
        rows = [int(torch.nonzero((X == r).all(dim=1))[0]) for r in restarted]
        assert len(set(rows)) == 3  # distinct data points
        assert torch.equal(mu2[~small], mu[~small])
        assert torch.equal(var2[small], base_var.expand(3, 3))
        assert torch.equal(var2[~small], var[~small])
        raw = torch.where(small, torch.full_like(w, 1.0 / k), w)
        torch.testing.assert_close(w2, raw / raw.sum(), rtol=0, atol=1e-15)
        assert abs(float(w2.sum()) - 1.0) < 1e-12
        none = t_clu.restart_collapsed(X, mu, var, w, torch.zeros(k, dtype=torch.bool),
                                       base_var, gen)
        assert none[3] == 0 and torch.equal(none[0], mu)

    def test_collapsed_cluster_restarts(self):
        # One blob of 300 rows and 3 far outliers: k-means++ seeds a centre
        # on the outliers, whose cluster (3 rows) is under the minimum size
        # (min(40, n / 2k) = 37.9), so EM restarts it.
        rng = np.random.default_rng(7)
        X = np.concatenate([rng.normal(size=(300, 2)), 50.0 + rng.normal(size=(3, 2))])
        est = t_clu.GaussianMixtureModelEstimator(4, max_iterations=5, seed=1)
        gmm = est.fit_array(torch.from_numpy(X))
        assert est.restarts > 0
        assert torch.isfinite(gmm.means).all() and (gmm.variances > 0).all()
        assert abs(float(gmm.weights.sum()) - 1.0) < 1e-12


def _class_rows(n, d, k, seed, dtype):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    labels[labels == 2] = 1  # an absent class
    centres = rng.normal(size=(k, d))
    X = (centres[labels] + rng.normal(size=(n, d))).astype(dtype)
    return X, (2.0 * np.eye(k)[labels] - 1.0).astype(dtype)


class TestBWLS:
    @pytest.mark.parametrize("dtype,tol,block,iters,mw", [
        (np.float64, 1e-6, 8, 2, 0.25), (np.float64, 1e-6, 24, 1, 0.5),
        (np.float64, 1e-6, 10, 3, 0.0), (np.float32, 1e-5, 8, 2, 0.25)])
    def test_matches(self, dtype, tol, block, iters, mw):
        X, Y = _class_rows(150, 24, 6, block + iters, dtype)
        want = JBWLS(block, iters, 0.1, mw).fit(JDataset(X), JDataset(Y))
        got = TBWLS(block, iters, 0.1, mw).fit(TDataset(torch.from_numpy(X)),
                                               TDataset(torch.from_numpy(Y)))
        assert isinstance(got, TBlockLinearMapper) and len(got.xs) == len(want.xs)
        w_j = np.concatenate([np.asarray(x) for x in want.xs])
        assert _rel_fro(torch.cat(got.xs).numpy(), w_j) <= tol
        assert _rel_fro(got.b_opt.numpy(), np.asarray(want.b_opt)) <= tol
        scores = got.batch_apply(TDataset(torch.from_numpy(X))).array.numpy()
        assert _rel_fro(scores, np.asarray(want.batch_apply(JDataset(X)).array)) <= tol

    def test_more_classes_than_a_chunk(self):
        X, Y = _class_rows(400, 12, 40, 3, np.float64)
        want = JBWLS(12, 1, 1e-2, 0.25).fit(JDataset(X), JDataset(Y))
        got = TBWLS(12, 1, 1e-2, 0.25).fit(TDataset(torch.from_numpy(X)),
                                           TDataset(torch.from_numpy(Y)))
        assert _rel_fro(got.xs[0].numpy(), np.asarray(want.xs[0])) <= 1e-6

    def test_no_labeled_rows(self):
        with pytest.raises(ValueError):
            TBWLS(4, 1, 0.1, 0.25).fit(TDataset(torch.zeros(0, 4)), TDataset(torch.zeros(0, 3)))
