"""ZCA whitening (reference: ZCAWhitener.scala:12-80).

Port of the ZCA part of ``keystone_tpu/ops/learning/pca.py``:
:class:`ZCAWhitener` and :class:`ZCAWhitenerEstimator`, the whitening of
the CIFAR random-patch filters, with ``torch.linalg.svd``. The whitener
``V·diag((s²/(n−1)+ε)^−½)·Vᵀ`` does not depend on the signs the SVD picks
for V's columns. Not ported yet: the PCA estimators (local, distributed,
approximate) and the streamed ZCA fit.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.workflow import Estimator, Transformer


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
