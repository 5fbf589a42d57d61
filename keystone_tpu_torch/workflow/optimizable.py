"""Optimizable nodes: operators with data-dependent algorithm selection.

Mirror of reference workflow/OptimizableNodes.scala:7-50: each optimizable node
has a ``default`` concrete implementation plus an ``optimize(sample, ...)``
hook invoked by NodeOptimizationRule with a small sample of the node's actual
input, returning the concrete operator to swap in (or None to keep default).

Port of ``keystone_tpu/workflow/optimizable.py``; only the import paths
changed.
"""

from __future__ import annotations

from typing import Optional

from keystone_tpu_torch.data import Dataset

from .operators import TransformerOperator
from .pipeline import Estimator, LabelEstimator, Transformer


class OptimizableTransformer(Transformer):
    """Transformer with a sample-driven implementation choice."""

    @property
    def default(self) -> Transformer:
        raise NotImplementedError

    def optimize(self, sample: Dataset) -> Optional[TransformerOperator]:
        raise NotImplementedError

    def apply(self, x):
        return self.default.apply(x)

    def batch_apply(self, data: Dataset) -> Dataset:
        return self.default.batch_apply(data)


class OptimizableEstimator(Estimator):
    """Estimator with a sample-driven implementation choice."""

    @property
    def default(self) -> Estimator:
        raise NotImplementedError

    def optimize(self, sample: Dataset) -> Optional[object]:
        raise NotImplementedError

    def fit(self, data: Dataset):
        return self.default.fit(data)


class OptimizableLabelEstimator(LabelEstimator):
    """LabelEstimator with a sample-driven implementation choice."""

    @property
    def default(self) -> LabelEstimator:
        raise NotImplementedError

    def optimize(self, sample: Dataset, labels_sample: Dataset) -> Optional[object]:
        raise NotImplementedError

    def fit(self, data: Dataset, labels: Dataset):
        return self.default.fit(data, labels)
