"""Clustering: k-means++ and the diagonal-covariance GMM.

Reference: nodes/learning/KMeansPlusPlus.scala:16-181,
GaussianMixtureModel.scala:19-110, GaussianMixtureModelEstimator.scala:25-203.

Port of ``keystone_tpu/ops/learning/clustering.py``. Lloyd's iterations and
EM are whole-batch products on the data's device (the distance and
responsibility computations are n×k GEMMs); their loops and convergence
tests run on the host, one scalar read an iteration, where the reference
compiles each loop into one program. The k-means++ seeding makes the
reference's numpy draws from ``default_rng(seed)`` in the reference's
order; the squared distances and the draw's cumulative sum are computed on
the device, so both packages pick the same centres unless a draw lands
within rounding of a boundary.

The EM restart of collapsed clusters draws its distinct data points from a
``torch.Generator`` seeded with the integer the reference seeds its
``jax.random`` key with; the two generators give different points, so a
run that restarts a cluster differs from the reference's (on data where no
cluster collapses the two agree).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.workflow import Estimator, Transformer

logger = logging.getLogger("keystone_tpu_torch.clustering")


def _as_float64(X) -> torch.Tensor:
    """The estimators fit in float64, as the reference does (its inputs are
    cast with ``np.asarray(..., dtype=np.float64)``)."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float64)
    return torch.from_numpy(np.asarray(X, dtype=np.float64))


def _rows(data: Dataset) -> torch.Tensor:
    return as_tensor(data.array)[:data.n]


def _half_sq_dist(X, X_sq_half, means) -> torch.Tensor:
    """0.5·|x − m|² for every (row, mean): (n, k)."""
    out = torch.addmm(X_sq_half[:, None], X, means.T, alpha=-1.0)
    return out.add_(0.5 * (means * means).sum(dim=1)[None, :])


class KMeansModel(Transformer):
    """Assign each point a one-hot nearest-center indicator
    (reference: KMeansPlusPlus.scala:16-70)."""

    def __init__(self, means):
        self.means = as_tensor(means)  # (k, d)

    def apply(self, x):
        return self.assignments(as_tensor(x, self.means.device)[None])[0]

    def assignments(self, X):
        X = as_tensor(X, self.means.device)
        sq_dist = _half_sq_dist(X, 0.5 * (X * X).sum(dim=1), self.means.to(X.dtype))
        nearest = torch.argmin(sq_dist, dim=1)
        return torch.nn.functional.one_hot(nearest, self.means.shape[0]).to(X.dtype)

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(self.assignments)


def _lloyd_loop(X, means, stop_tolerance: float, max_iterations: int):
    """Lloyd's iterations with the reference's cost-improvement stop: at
    least 2 iterations, then stop once the cost falls by less than
    ``stop_tolerance`` of itself. Returns (iterations, means, cost)."""
    k = means.shape[0]
    X_sq_half = 0.5 * (X * X).sum(dim=1)
    prev_cost, cost, it = math.inf, math.inf, 0
    while it < max_iterations and (it < 2 or (prev_cost - cost) >= stop_tolerance * abs(prev_cost)):
        sq_dist = _half_sq_dist(X, X_sq_half, means)
        min_d, nearest = sq_dist.min(dim=1)
        del sq_dist
        new_cost = float(min_d.mean())
        mass = torch.bincount(nearest, minlength=k).to(X.dtype)
        sums = torch.zeros_like(means).index_add_(0, nearest, X)
        new_means = sums / torch.clamp_min(mass, 1e-12)[:, None]
        # Keep empty clusters where they were rather than collapsing to 0.
        means = torch.where((mass > 0)[:, None], new_means, means)
        prev_cost, cost, it = cost, new_cost, it + 1
    return it, means, cost


class KMeansPlusPlusEstimator(Estimator):
    """k-means++ seeding + Lloyd's iterations with cost-improvement stopping
    (reference: KMeansPlusPlus.scala:83-180)."""

    def __init__(self, num_means: int, max_iterations: int, stop_tolerance: float = 1e-3,
                 seed: int = 0):
        self.num_means = num_means
        self.max_iterations = max_iterations
        self.stop_tolerance = stop_tolerance
        self.seed = seed

    def fit(self, data: Dataset) -> KMeansModel:
        return self.fit_array(_rows(data))

    def seed_centers(self, X: torch.Tensor) -> np.ndarray:
        """The k-means++ seeding: row indices of the initial centres, each
        drawn by ``default_rng(seed)`` as the reference draws it (the first
        uniformly, each next in proportion to its squared distance to the
        nearest centre so far, through numpy's ``choice``: a uniform draw
        searched in the normalised cumulative sum)."""
        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        x_sq_half = 0.5 * (X * X).sum(dim=1)
        centers = np.zeros(self.num_means, dtype=np.int64)
        centers[0] = rng.integers(0, n)
        cur_sq_dist = None
        for k in range(self.num_means - 1):
            c = X[int(centers[k])]
            sq_to_new = x_sq_half - X @ c + 0.5 * (c @ c)
            cur_sq_dist = (sq_to_new if cur_sq_dist is None
                           else torch.minimum(sq_to_new, cur_sq_dist))
            probs = torch.clamp_min(cur_sq_dist, 0.0)
            total = probs.sum()
            if float(total) <= 0:
                centers[k + 1] = rng.integers(0, n)
            else:
                cdf = torch.cumsum(probs / total, dim=0)
                cdf /= cdf[-1].clone()
                u = torch.tensor([rng.random()], dtype=cdf.dtype, device=cdf.device)
                centers[k + 1] = int(torch.searchsorted(cdf, u, right=True))
        return centers

    def fit_array(self, X) -> KMeansModel:
        X = _as_float64(X)
        centers = self.seed_centers(X)
        it, means, cost = _lloyd_loop(
            X, X[torch.from_numpy(centers).to(X.device)], self.stop_tolerance,
            self.max_iterations)
        self.iterations = it
        logger.info(
            "KMeans stopped after %d iterations (max %d, %s), cost %f", it,
            self.max_iterations,
            "converged" if it < self.max_iterations else "iteration cap", cost)
        return KMeansModel(means)


class GaussianMixtureModel(Transformer):
    """Thresholded posterior assignments under a diagonal-covariance GMM
    (reference: GaussianMixtureModel.scala:19-95).

    means/variances: (d, k) as in the reference; weights: (k,).
    """

    def __init__(self, means, variances, weights, weight_threshold: float = 1e-4):
        self.means = as_tensor(means)
        self.variances = as_tensor(variances, self.means.device)
        self.weights = as_tensor(weights, self.means.device)
        self.weight_threshold = weight_threshold
        if self.means.shape != self.variances.shape:
            raise ValueError("GMM means and variances must be the same size.")
        if self.weights.shape[0] != self.means.shape[1]:
            raise ValueError("Every GMM center must have a weight.")

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def posteriors(self, X):
        """(..., n, d) rows -> (..., n, k) posteriors, those at or under the weight
        threshold zeroed and the rest renormalised; computed in the wider
        of the rows' and the model's dtypes."""
        X = as_tensor(X, self.means.device)
        dtype = torch.promote_types(X.dtype, self.means.dtype)
        X = X.to(dtype)
        mu, var = self.means.T.to(dtype), self.variances.T.to(dtype)  # (k, d)
        # Squared Mahalanobis via GEMMs (GaussianMixtureModel.scala:53-57).
        llh = (X * X) @ (-0.5 / var).T
        llh += X @ (mu / var).T
        llh += (-0.5 * X.shape[-1] * math.log(2 * math.pi)
                - 0.5 * torch.log(var).sum(dim=1)
                + torch.log(self.weights.to(dtype))
                - 0.5 * (mu * mu / var).sum(dim=1))[None, :]
        llh -= llh.max(dim=-1, keepdim=True).values
        post = llh.exp_()
        post /= post.sum(dim=-1, keepdim=True)
        # Aggressive posterior thresholding (GaussianMixtureModel.scala:76-80).
        post = torch.where(post > self.weight_threshold, post, torch.zeros((), dtype=dtype,
                                                                           device=X.device))
        return post / post.sum(dim=-1, keepdim=True)

    def apply(self, x):
        return self.posteriors(as_tensor(x)[None])[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(self.posteriors)

    @staticmethod
    def load(mean_file: str, vars_file: str, weights_file: str,
             device=None) -> "GaussianMixtureModel":
        """CSV load (reference: GaussianMixtureModel.scala:103-110), in
        float64 on ``device`` (default: the CPU)."""
        means = np.loadtxt(mean_file, delimiter=",", ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=",", ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=",").reshape(-1)
        return GaussianMixtureModel(*(torch.from_numpy(a).to(device)
                                      for a in (means, variances, weights)))


def _em_step(X, X2, mu, var, w):
    """One EM step on the (n, d) rows X (X2 = X·X): returns the new means,
    variances and weights, the mean log-likelihood of the current model,
    and the clusters' masses."""
    n, d = X.shape
    llh = X2 @ (-0.5 / var).T
    llh.addmm_(X, (mu / var).T)
    llh += (-0.5 * d * math.log(2 * math.pi) - 0.5 * torch.log(var).sum(dim=1)
            + torch.log(w) - 0.5 * (mu * mu / var).sum(dim=1))[None, :]
    m = llh.max(dim=1, keepdim=True).values
    log_norm = m + torch.log((llh - m).exp_().sum(dim=1, keepdim=True))
    post = llh.sub_(log_norm).exp_()
    nk = post.sum(dim=0)
    new_mu = (post.T @ X) / nk[:, None]
    ex2 = (post.T @ X2) / nk[:, None]
    return new_mu, ex2 - new_mu * new_mu, nk / n, float(log_norm.mean()), nk


def restart_collapsed(X, mu, var, w, small, base_var, gen):
    """Restart the clusters flagged ``small`` at distinct data points drawn
    from ``gen``, with the data's variance ``base_var`` and weight 1/k, and
    renormalise the weights. Returns (mu, var, w, clusters restarted)."""
    n, k = X.shape[0], mu.shape[0]
    num_small = int(small.sum())
    if num_small:
        idx = torch.randperm(n, generator=gen, device=X.device)[:min(k, n)]
        idx = idx.repeat(-(-k // idx.shape[0]))[:k]
        mu = torch.where(small[:, None], X[idx], mu)
        var = torch.where(small[:, None], base_var[None, :], var)
        w = torch.where(small, torch.full_like(w, 1.0 / k), w)
    return mu, var, w / w.sum(), num_small


class GaussianMixtureModelEstimator(Estimator):
    """Diagonal-covariance GMM by EM over the collected sample, k-means++
    (or random) init, variance lower bounds, min-cluster-size restarts
    (reference: GaussianMixtureModelEstimator.scala:25-203).

    After a fit, ``iterations`` holds the EM steps taken and ``restarts``
    the collapsed clusters restarted."""

    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        tol: float = 1e-4,
        min_cluster_size: int = 40,
        absolute_variance_floor: float = 1e-9,
        # smallVarianceThreshold default (GaussianMixtureModelEstimator.scala:31).
        relative_variance_floor: float = 1e-2,
        kmeans_init: bool = True,
        seed: int = 0,
    ):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.min_cluster_size = min_cluster_size
        self.absolute_variance_floor = absolute_variance_floor
        self.relative_variance_floor = relative_variance_floor
        self.kmeans_init = kmeans_init
        self.seed = seed

    def fit(self, data: Dataset) -> GaussianMixtureModel:
        return self.fit_array(_rows(data))

    def fit_array(self, X) -> GaussianMixtureModel:
        X = _as_float64(X)
        n, d = X.shape
        k = self.k
        rng = np.random.default_rng(self.seed)
        if self.kmeans_init:
            mu = KMeansPlusPlusEstimator(k, 10, seed=self.seed).fit_array(X).means
        else:
            mu = X[torch.from_numpy(rng.choice(n, k, replace=False)).to(X.device)]
        exact_var = X.var(dim=0, unbiased=False)
        base_var = exact_var + 1e-6  # init/restart stability fudge only
        var = base_var.repeat(k, 1)
        w = torch.full((k,), 1.0 / k, dtype=X.dtype, device=X.device)
        small_threshold = min(self.min_cluster_size, n / (2 * k))
        # Variance floors: max(smallVarianceThreshold · the EXACT global
        # per-dim data variance, absolute floor), fixed before EM
        # (GaussianMixtureModelEstimator.scala:100 gmmVarLB).
        floor = torch.clamp_min(self.relative_variance_floor * exact_var,
                                self.absolute_variance_floor)[None, :]
        gen = torch.Generator(device=X.device).manual_seed(int(rng.integers(0, 2**31 - 1)))

        X2 = X * X
        it, prev_ll, ll, restarts = 0, -math.inf, -math.inf, 0
        while it < self.max_iterations and (
                it < 2 or abs(ll - prev_ll) >= self.tol * max(abs(prev_ll), 1.0)):
            mu, var, w, new_ll, nk = _em_step(X, X2, mu, var, w)
            var = torch.maximum(var, floor)
            # Restart clusters that collapsed below the minimum size at
            # distinct random data points.
            mu, var, w, num_small = restart_collapsed(X, mu, var, w, nk < small_threshold,
                                                      base_var, gen)
            restarts += num_small
            prev_ll, ll, it = ll, new_ll, it + 1
        del X2
        self.iterations, self.restarts = it, restarts
        logger.info(
            "GMM EM stopped after %d iterations (max %d, %s), mean llh %f, %d restarts", it,
            self.max_iterations,
            "converged" if it < self.max_iterations else "iteration cap", ll, restarts)
        # Reference layout: (d, k).
        return GaussianMixtureModel(mu.T.contiguous(), var.T.contiguous(), w)
