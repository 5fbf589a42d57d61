"""PCA family and ZCA whitening (reference: nodes/learning/PCA.scala:19-248,
DistributedPCA.scala:21-74, ApproximatePCA.scala:22-85,
ZCAWhitener.scala:12-80).

Port of ``keystone_tpu/ops/learning/pca.py``. Three PCA algorithms, as the
reference's optimizable set:
  - local SVD on the collected rows (``PCAEstimator``, sgesvd),
  - TSQR of the mean-centered rows, then the SVD of R
    (``DistributedPCAEstimator``; one device: a direct QR,
    ``parallel/linalg.py::tsqr_r``),
  - a randomized sketch (``ApproximatePCAEstimator``,
    Halko-Martinsson-Tropp), its Gaussian test matrix drawn from a
    ``torch.Generator`` seeded with ``seed`` (the reference draws it with
    ``jax.random``: the two differ, and the power iterations make both
    converge to the same subspace).
The column forms treat each column of each item's (d, cols) matrix as a
row; ``ColumnPCAEstimator`` picks local or distributed by the reference's
cost formulas, counting machines as CUDA devices. Signs follow the
reference's matlab convention (``enforce_matlab_sign_convention``), so both
packages give the same directions. The whitener
``V·diag((s²/(n−1)+ε)^−½)·Vᵀ`` does not depend on SVD signs. Not ported
yet: the streamed ZCA fit (it needs the shard sources).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.workflow import Estimator, Transformer
from keystone_tpu_torch.workflow.optimizable import OptimizableEstimator


def enforce_matlab_sign_convention(pca) -> torch.Tensor:
    """Each column times +1 where its largest entry is also its largest in
    magnitude, else −1 (reference: PCA.scala:238-247)."""
    pca = as_tensor(pca)
    col_max = pca.max(dim=0).values
    abs_col_max = pca.abs().max(dim=0).values
    signs = torch.where(col_max == abs_col_max, 1.0, -1.0).to(pca.dtype)
    return pca * signs[None, :]


def compute_pca(data, dims: int) -> torch.Tensor:
    """Principal directions of mean-centered rows: V[:, :dims] of the SVD,
    matlab sign convention (reference: PCA.scala:179-247)."""
    data = as_tensor(data)
    centered = data - data.mean(dim=0)
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    return enforce_matlab_sign_convention(vt.T)[:, :dims]


def _rows(data: Dataset) -> torch.Tensor:
    return as_tensor(data.array)[:data.n]


def _columns(data: Dataset) -> torch.Tensor:
    """Every column of every (d, cols) item as one (N, d) row matrix, in
    the items' order."""
    if data.is_host:
        return torch.cat([as_tensor(x).T for x in data.to_list()])
    X = _rows(data)
    return X.transpose(1, 2).reshape(-1, X.shape[1])


class PCATransformer(Transformer):
    """x -> pcaMatᵀ x (reference: PCA.scala:19-30)."""

    def __init__(self, pca_mat):
        self.pca_mat = as_tensor(pca_mat)

    def apply(self, x):
        return as_tensor(x, self.pca_mat.device) @ self.pca_mat

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(lambda X: as_tensor(X, self.pca_mat.device) @ self.pca_mat)


class BatchPCATransformer(Transformer):
    """Per-item (d, cols) matrix -> (dims, cols): pcaMatᵀ · in
    (reference: PCA.scala:37-43)."""

    def __init__(self, pca_mat):
        self.pca_mat = as_tensor(pca_mat)

    def apply(self, x):
        return self.pca_mat.T @ as_tensor(x, self.pca_mat.device)

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return Dataset.of([self.apply(x) for x in data.to_list()])
        return data.map_batch(lambda X: self.pca_mat.T @ as_tensor(X, self.pca_mat.device))


class PCAEstimator(Estimator):
    """Local PCA: the SVD of the collected rows (reference: PCA.scala:163-231)."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data: Dataset) -> PCATransformer:
        return PCATransformer(compute_pca(_rows(data), self.dims))

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w) -> float:
        flops = n * d * d
        return max(cpu_w * flops, mem_w * n * d) + net_w * n * d


class DistributedPCAEstimator(Estimator):
    """PCA via TSQR of the mean-centered rows, then SVD of R
    (reference: DistributedPCA.scala:21-74; subsumes mlmatrix TSQR)."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data: Dataset) -> PCATransformer:
        X = as_tensor(data.array)
        mean = X.sum(dim=0) / data.n
        centered = X - mean
        # Re-zero padding rows (centering made them -mean).
        centered[data.n:] = 0
        _, _, vt = torch.linalg.svd(linalg.tsqr_r(centered), full_matrices=False)
        return PCATransformer(enforce_matlab_sign_convention(vt.T)[:, :self.dims])

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w) -> float:
        flops = 2.0 * n * d * d / num_machines + (d ** 3) * math.log(max(num_machines, 2), 2)
        network = d * d * math.log(max(num_machines, 2), 2)
        return max(cpu_w * flops, mem_w * n * d / num_machines) + net_w * network


class ApproximatePCAEstimator(Estimator):
    """Randomized PCA, Halko-Martinsson-Tropp alg 4.4/5.1: Gaussian sketch +
    q power iterations of QR (reference: ApproximatePCA.scala:22-85)."""

    def __init__(self, dims: int, q: int = 10, p: int = 5, seed: int = 0):
        self.dims = dims
        self.q = q
        self.p = p
        self.seed = seed

    def fit(self, data: Dataset) -> PCATransformer:
        X = as_tensor(data.array)
        mean = X.sum(dim=0) / data.n
        A = X - mean
        A[data.n:] = 0
        gen = torch.Generator(device=A.device).manual_seed(self.seed)
        omega = torch.randn((A.shape[1], self.dims + self.p), generator=gen,
                            dtype=A.dtype, device=A.device)
        Q, _ = torch.linalg.qr(A @ omega)
        for _ in range(self.q):
            Qz, _ = torch.linalg.qr(A.T @ Q)
            Q, _ = torch.linalg.qr(A @ Qz)
        _, _, vt = torch.linalg.svd(Q.T @ A, full_matrices=False)  # B: (l, d)
        return PCATransformer(enforce_matlab_sign_convention(vt.T)[:, :self.dims])

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w) -> float:
        flops = n * d * (self.dims + self.p) * (self.q + 1) / num_machines
        return max(cpu_w * flops, mem_w * n * d / num_machines) + net_w * d * (self.dims + self.p)


class LocalColumnPCAEstimator(Estimator):
    """Column-matrix PCA, local SVD: items are (d, cols) matrices whose columns
    are treated as points (reference: PCA.scala:45-77)."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data: Dataset) -> BatchPCATransformer:
        return BatchPCATransformer(compute_pca(_columns(data), self.dims))


class DistributedColumnPCAEstimator(Estimator):
    """Column-matrix PCA via the distributed path (reference: PCA.scala:79-116)."""

    def __init__(self, dims: int):
        self.dims = dims

    def fit(self, data: Dataset) -> BatchPCATransformer:
        pca = DistributedPCAEstimator(self.dims).fit(Dataset(_columns(data)))
        return BatchPCATransformer(pca.pca_mat)


class ColumnPCAEstimator(OptimizableEstimator):
    """Optimizable column PCA: the sample-driven local-vs-distributed choice
    (reference: PCA.scala:118-156). ``num_machines`` defaults to the number
    of CUDA devices (at least 1)."""

    def __init__(
        self,
        dims: int,
        num_machines: Optional[int] = None,
        cpu_weight: float = 3.8e-4,
        mem_weight: float = 2.9e-1,
        network_weight: float = 1.32,
    ):
        self.dims = dims
        self.num_machines = num_machines
        self.cpu_weight = cpu_weight
        self.mem_weight = mem_weight
        self.network_weight = network_weight
        self._local = LocalColumnPCAEstimator(dims)
        self._distributed = DistributedColumnPCAEstimator(dims)

    @property
    def default(self):
        return self._distributed

    def optimize(self, sample: Dataset):
        items = sample.to_list()
        if not items:
            return None
        d = items[0].shape[0]
        cols_per_item = sum(x.shape[1] for x in items) / len(items)
        n = int(cols_per_item * getattr(sample, "total_n", sample.n))
        machines = self.num_machines or max(torch.cuda.device_count(), 1)
        weights = (self.cpu_weight, self.mem_weight, self.network_weight)
        local_cost = PCAEstimator(self.dims).cost(n, d, self.dims, 1.0, machines, *weights)
        dist_cost = DistributedPCAEstimator(self.dims).cost(n, d, self.dims, 1.0, machines,
                                                            *weights)
        return self._local if local_cost < dist_cost else self._distributed


class ZCAWhitener(Transformer):
    """(in − means) · whitener on per-item (rows, d) matrices
    (reference: ZCAWhitener.scala:12-18)."""

    def __init__(self, whitener, means):
        self.whitener = as_tensor(whitener)
        self.means = as_tensor(means, self.whitener.device)

    def apply(self, x):
        return (as_tensor(x, self.whitener.device) - self.means) @ self.whitener

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(lambda X: (X - self.means) @ self.whitener)


class ZCAWhitenerEstimator(Estimator):
    """V·diag((s²/(n−1)+ε)^−½)·Vᵀ from the SVD of the centered sample
    (reference: ZCAWhitener.scala:30-80)."""

    def __init__(self, eps: float = 0.1):
        self.eps = eps

    def fit(self, data: Dataset) -> ZCAWhitener:
        # The reference fits on the first item (a sample matrix).
        first = data.to_list()[0] if data.is_host else as_tensor(data.array)[0]
        return self.fit_single(first)

    def fit_single(self, X) -> ZCAWhitener:
        X = as_tensor(X)
        means = X.mean(dim=0)
        _, s, vt = torch.linalg.svd(X - means, full_matrices=False)
        s2 = (s * s) / (X.shape[0] - 1.0)
        whitener = vt.T @ torch.diag((s2 + self.eps) ** -0.5) @ vt
        return ZCAWhitener(whitener, means)
