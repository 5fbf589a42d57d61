"""Plumbing nodes (reference: nodes/util/ — Cacher, VectorSplitter, label
indicators, classifiers, combiners).

Port of ``keystone_tpu/ops/util.py`` (the nodes the TIMIT, VOC and
ImageNet slices run). Dense nodes are whole-batch tensor ops on the
dataset's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.workflow import Transformer


class FunctionNode:
    """A dataset-level function outside graph tracking
    (reference: pipelines/FunctionNode.scala:3)."""

    def apply(self, data):
        raise NotImplementedError

    def __call__(self, data):
        return self.apply(data)


@dataclass(frozen=True)
class Cacher(Transformer):
    """Materialize-and-hold passthrough (reference: nodes/util/Cacher.scala:15-25).

    Waits for the dataset's device work and marks the node's prefix as
    saveable so the optimizer can reuse the result across pipeline
    applications (the analog of RDD ``.cache()``).
    """

    name: Optional[str] = None

    def apply(self, x):
        return x

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.cache()


@dataclass(frozen=True)
class ClassLabelIndicatorsFromIntLabels(Transformer):
    """Int label -> ±1 one-hot indicator vector
    (reference: nodes/util/ClassLabelIndicators.scala:15-38)."""

    num_classes: int

    def __post_init__(self):
        if self.num_classes < 2:
            raise ValueError("Must have at least two classes for ClassLabelIndicators")

    def apply(self, label):
        return self._encode(as_tensor(label).long())

    def _encode(self, labels: torch.Tensor) -> torch.Tensor:
        one_hot = torch.nn.functional.one_hot(labels, self.num_classes)
        return 2.0 * one_hot.to(torch.float32) - 1.0

    def batch_apply(self, data: Dataset) -> Dataset:
        labels = as_tensor(data.array).long()
        out = Dataset(self._encode(labels), n=data.n)
        # ±1 encoding is non-zero-preserving: re-zero padding rows.
        return out._rezero_padding()


@dataclass(frozen=True)
class ClassLabelIndicatorsFromIntArrayLabels(Transformer):
    """Multi-label int array -> ±1 indicator vector
    (reference: nodes/util/ClassLabelIndicators.scala:40-55). Host labels
    in, a float32 tensor on the CPU out."""

    num_classes: int
    valid_check: bool = True

    def __post_init__(self):
        if self.num_classes < 2:
            raise ValueError("Must have at least two classes for ClassLabelIndicators")

    def apply(self, labels):
        labels = np.atleast_1d(np.asarray(labels))
        if self.valid_check and (labels.min() < 0 or labels.max() >= self.num_classes):
            raise ValueError("Class labels out of range")
        out = -np.ones(self.num_classes, dtype=np.float32)
        out[labels] = 1.0
        return torch.from_numpy(out)

    def batch_apply(self, data: Dataset) -> Dataset:
        return Dataset.of([self.apply(x) for x in data.to_list()])


@dataclass(frozen=True)
class MaxClassifier(Transformer):
    """argmax over scores -> int label (reference: nodes/util/MaxClassifier.scala:9-11)."""

    def apply(self, x):
        return torch.argmax(as_tensor(x), dim=-1)

    def _batch_fn(self, X):
        return torch.argmax(X, dim=-1)

    def device_fn(self):
        return self._batch_fn


@dataclass(frozen=True)
class TopKClassifier(Transformer):
    """Top-k score indices, descending; k clamps at the vector size
    (reference: nodes/util/TopKClassifier.scala:9-14 takes min(k, length))."""

    k: int

    def apply(self, x):
        x = as_tensor(x)
        return torch.topk(x, min(self.k, x.shape[-1]), dim=-1).indices

    def batch_apply(self, data: Dataset) -> Dataset:
        return Dataset(self.apply(data.array), n=data.n)


@dataclass(frozen=True)
class VectorCombiner(Transformer):
    """Concatenate gathered branch vectors (reference: nodes/util/VectorCombiner.scala:10-14).

    Input items are tuples of vectors (the output of ``Pipeline.gather``);
    output is their concatenation.
    """

    def apply(self, x):
        return torch.cat([as_tensor(v) for v in x], dim=-1)

    def batch_apply(self, data: Dataset) -> Dataset:
        if isinstance(data.data, tuple):
            out = torch.cat([as_tensor(a) for a in data.data], dim=-1)
            return Dataset(out, n=data.n)
        return Dataset.of([self.apply(x) for x in data.to_list()])

    def device_combine_fn(self):
        """Gather-fusion contract: merge branch tensors inside one composed
        function (workflow/fusion.py::GatherFusionRule). A fused gather whose
        branches can write into column windows skips this concatenation."""
        return lambda arrays: torch.cat([as_tensor(a) for a in arrays], dim=-1)


@dataclass(frozen=True)
class MatrixVectorizer(Transformer):
    """Flatten a matrix to a vector, column-major to match Breeze's
    ``DenseMatrix.toDenseVector`` (reference: nodes/util/MatrixVectorizer.scala:9-11)."""

    def apply(self, x):
        return as_tensor(x).T.reshape(-1)

    def _batch_fn(self, X):
        return X.transpose(1, 2).reshape(X.shape[0], -1)

    def device_fn(self):
        return self._batch_fn


@dataclass(frozen=True)
class FloatToDouble(Transformer):
    """float32 -> float64 cast (reference: nodes/util/FloatToDouble.scala:9-11).

    As in the reference, the default widens to the accumulation dtype
    (float32) and the node stands for API parity; ``strict=True`` casts to
    float64.
    """

    strict: bool = False

    def _dtype(self):
        return torch.float64 if self.strict else torch.float32

    def apply(self, x):
        return as_tensor(x).to(self._dtype())

    def _batch_fn(self, X):
        return X.to(self._dtype())

    def device_fn(self):
        return self._batch_fn


class VectorSplitter(FunctionNode):
    """Split a (n, d) dataset into feature-axis blocks — the model-parallel
    partitioner (reference: nodes/util/VectorSplitter.scala:10-36).

    Returns a list of Datasets, each (n, block_size) (last may be smaller).
    The blocks are column views of the input, not copies.
    """

    def __init__(self, block_size: int, num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_features = num_features

    def apply(self, data: Dataset) -> List[Dataset]:
        arr = as_tensor(data.array)
        d = self.num_features if self.num_features is not None else int(arr.shape[-1])
        return [
            Dataset(arr[:, start:min(start + self.block_size, d)], n=data.n)
            for start in range(0, d, self.block_size)
        ]

    def split_vector(self, vec):
        """Split a single vector into per-block vectors."""
        vec = as_tensor(vec)
        d = self.num_features if self.num_features is not None else int(vec.shape[-1])
        return [
            vec[start:min(start + self.block_size, d)]
            for start in range(0, d, self.block_size)
        ]
