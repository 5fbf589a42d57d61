"""Statistical featurization nodes (reference: nodes/stats/).

Port of ``keystone_tpu/ops/stats.py`` (the nodes the TIMIT slice runs:
StandardScaler and the cosine random features). Dense nodes operate
whole-batch on (n, d) tensors. Randomized nodes take explicit integer
seeds and draw from a ``torch.Generator`` seeded with them on the CPU, so
a seed gives the same draws on every device. (They are not the
reference's ``jax.random`` draws; tests carry the reference's weights
across through :mod:`keystone_tpu_torch.interop`.)
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.workflow import Estimator, Transformer


# ---------------------------------------------------------------------------
# StandardScaler
# ---------------------------------------------------------------------------


class StandardScalerModel(Transformer):
    """Subtract column means (and optionally divide by stds)
    (reference: nodes/stats/StandardScaler.scala:16-32)."""

    def __init__(self, mean, std=None):
        self.mean = as_tensor(mean)
        self.std = None if std is None else as_tensor(std, self.mean.device)

    def apply(self, x):
        out = as_tensor(x, self.mean.device) - self.mean
        if self.std is not None:
            out = out / self.std
        return out

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(self.apply)


class StandardScaler(Estimator):
    """Column mean/std in one pass over the rows
    (reference: nodes/stats/StandardScaler.scala:37-60)."""

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def fit(self, data: Dataset) -> StandardScalerModel:
        X = as_tensor(data.array)
        n = data.n
        # Padding rows are zero: sums are exact; divide by the true count.
        mean = X.sum(dim=0) / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean)
        # Sample variance with the zero-padding correction:
        # sum((x - mean)^2) over real rows = sum(x^2) - n*mean^2.
        sumsq = (X * X).sum(dim=0)
        var = (sumsq - n * mean * mean) / max(n - 1, 1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        bad = torch.isnan(std) | torch.isinf(std) | (torch.abs(std) < self.eps)
        std = torch.where(bad, torch.ones_like(std), std)
        return StandardScalerModel(mean, std)


# ---------------------------------------------------------------------------
# Random features
# ---------------------------------------------------------------------------


class CosineRandomFeaturesModel(Transformer):
    """x -> cos(x Wᵀ + b): Rahimi-Recht random features
    (reference: nodes/stats/CosineRandomFeatures.scala:19-45).

    The batch path is the fused CUDA kernel ``cuda_ops.cosine_features``
    (its plain version for CPU tensors); the single-datum ``apply`` stays
    plain ``torch.cos``, as the reference's stays ``jnp.cos``.
    """

    def __init__(self, W, b):
        self.W = as_tensor(W)
        self.b = as_tensor(b, self.W.device)
        if self.b.shape[0] != self.W.shape[0]:
            raise ValueError("# of rows in W and size of b should match")

    def apply(self, x):
        return torch.cos(as_tensor(x, self.W.device) @ self.W.T + self.b)

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.map_batch(
            lambda X: cuda_ops.cosine_features(
                as_tensor(X, self.W.device).contiguous(), self.W, self.b
            )
        )


def CosineRandomFeatures(
    num_input_features: int,
    num_output_features: int,
    gamma: float,
    seed: int = 0,
    cauchy: bool = False,
    device=None,
) -> CosineRandomFeaturesModel:
    """Draw W ~ gaussian(·γ) (or cauchy(·γ)), b ~ U[0, 2π]
    (reference: CosineRandomFeatures.scala:50-61), on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shape = (num_output_features, num_input_features)
    if cauchy:
        W = torch.empty(shape).cauchy_(generator=gen) * gamma
    else:
        W = torch.randn(shape, generator=gen) * gamma
    b = torch.rand((num_output_features,), generator=gen) * (2 * math.pi)
    return CosineRandomFeaturesModel(W.to(device), b.to(device))
