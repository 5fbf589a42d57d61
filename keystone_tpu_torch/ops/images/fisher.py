"""Fisher-vector encoding (reference: nodes/images/FisherVector.scala:17-94 and
the native enceval tier, src/main/cpp/EncEval.cxx:20-120).

Port of ``keystone_tpu/ops/images/fisher.py``. The encoding is three GEMMs
plus elementwise work; the batch path encodes every descriptor matrix of a
chunk of items at once (batched GEMMs), the per-item path serves host-form
data. The encoding runs in the wider of the descriptors' and the GMM's
dtypes (float64 for a GMM fitted here) and returns float32, as the
reference's does. The reference keeps one implementation for both of its
tiers (Breeze and enceval), and so does the port: ``optimize`` keeps the
default.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.clustering import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
)
from keystone_tpu_torch.workflow import Estimator, Transformer
from keystone_tpu_torch.workflow.optimizable import OptimizableEstimator

# Items a chunk of the batched encoding: 256 items of 499 descriptors and
# 256 centres hold 0.26 GB of float64 posteriors.
FISHER_CHUNK_ITEMS = 256


def _fisher_encode(x, means, variances, weights, q):
    """Sanchez et al. FV from posteriors, for one item or a batch.

    x: (..., d, n) descriptors; q: (..., n, k) posteriors; means/variances:
    (d, k); weights: (k,). Returns (..., d, 2k) (FisherVector.scala:33-52).
    """
    n = x.shape[-1]
    s0 = q.mean(dim=-2)[..., None, :]  # (..., 1, k)
    s1 = (x @ q) / n  # (..., d, k)
    s2 = ((x * x) @ q) / n
    fv1 = (s1 - means * s0) / (torch.sqrt(variances) * torch.sqrt(weights))
    fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0) / (
        variances * torch.sqrt(2.0 * weights))
    return torch.cat([fv1, fv2], dim=-1)


class FisherVector(Transformer):
    """FV encoding of a (d, numDescriptors) matrix against a trained GMM
    (reference: FisherVector.scala:17-53). Output is (d, 2k), float32."""

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm

    def _encode(self, X: torch.Tensor) -> torch.Tensor:
        """(..., d, n) -> (..., d, 2k)."""
        gmm = self.gmm
        dtype = torch.promote_types(X.dtype, gmm.means.dtype)
        X = X.to(dtype)
        q = gmm.posteriors(X.transpose(-1, -2))  # (..., n, k), thresholded
        return _fisher_encode(X, gmm.means.to(dtype), gmm.variances.to(dtype),
                              gmm.weights.to(dtype), q).to(torch.float32)

    def apply(self, x):
        return self._encode(as_tensor(x, self.gmm.means.device).to(torch.float32))

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return data.map(self.apply)

        def encode(X):
            X = as_tensor(X, self.gmm.means.device).to(torch.float32)
            return torch.cat([self._encode(X[i:i + FISHER_CHUNK_ITEMS])
                              for i in range(0, X.shape[0], FISHER_CHUNK_ITEMS)])

        return data.map_batch(encode)


class ScalaGMMFisherVectorEstimator(Estimator):
    """Fit a GMM treating every column of every input matrix as one training
    vector, in float64, then encode (reference: FisherVector.scala:60-73).
    The name keeps the reference's label."""

    def __init__(self, k: int, gmm_seed: int = 0):
        self.k = k
        self.gmm_seed = gmm_seed

    def fit(self, data: Dataset) -> FisherVector:
        if data.is_host:
            cols = torch.cat([as_tensor(m).T.to(torch.float64) for m in data.to_list()])
        else:
            X = as_tensor(data.array)[:data.n]
            cols = X.transpose(1, 2).reshape(-1, X.shape[1]).to(torch.float64)  # (N, d)
        self.gmm_estimator = GaussianMixtureModelEstimator(self.k, seed=self.gmm_seed)
        return FisherVector(self.gmm_estimator.fit_array(cols))


class GMMFisherVectorEstimator(OptimizableEstimator):
    """Optimizable FV estimator (reference: FisherVector.scala:85-94). The
    reference swaps to the native enceval tier for k >= 32; both of its
    tiers run one implementation, so ``optimize`` keeps the default."""

    def __init__(self, k: int, gmm_seed: int = 0):
        self.k = k
        self.gmm_seed = gmm_seed
        self._default = ScalaGMMFisherVectorEstimator(k, gmm_seed)

    @property
    def default(self) -> Estimator:
        return self._default

    def optimize(self, sample: Dataset) -> Optional[Estimator]:
        return self._default
