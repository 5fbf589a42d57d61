"""Plumbing nodes (reference: nodes/util/ — Cacher, VectorSplitter, label
indicators, classifiers, combiners).

Port of ``keystone_tpu/ops/util.py``, with the plan verifier's declared
signatures (``output_signature``). Dense nodes are whole-batch tensor ops
on the dataset's device.
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

    # Verifier contract (workflow/verify.py): a cache marker is a
    # signature passthrough, and its PLACEMENT is checked — a cut that
    # severs an edge the fusion rules would compose into one function is
    # reported as `cache-splits-fusion`.
    is_cache = True

    def apply(self, x):
        return x

    def batch_apply(self, data: Dataset) -> Dataset:
        return data.cache()

    def output_signature(self, sig):
        return sig


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

    def output_signature(self, sig):
        """Verifier declaration: int labels (lead,) -> ±1 indicators
        (lead, num_classes) float32."""
        from keystone_tpu_torch.workflow.verify import ArraySig, SignatureError

        if not isinstance(sig, ArraySig):
            return None
        if len(sig.shape) > (0 if sig.datum else 1):
            raise SignatureError(
                f"{self.label} expects scalar int labels per example, got "
                f"{sig.describe()}"
            )
        shape = (self.num_classes,) if sig.datum else (
            sig.shape[0], self.num_classes
        )
        return ArraySig(shape, "float32", n=sig.n, mesh=sig.mesh,
                        datum=sig.datum)


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

    def output_signature(self, sig):
        from keystone_tpu_torch.workflow.verify import ArraySig

        datum = getattr(sig, "datum", False)
        n = getattr(sig, "n", None)
        shape = (self.num_classes,) if datum else (n, self.num_classes)
        return ArraySig(shape, "float32", n=n, datum=datum)


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

    def output_signature(self, sig):
        from keystone_tpu_torch.workflow.verify import ArraySig, SignatureError

        if not isinstance(sig, ArraySig):
            return None
        if not sig.shape:
            raise SignatureError(
                f"{self.label} needs a score vector, got {sig.describe()}"
            )
        d = sig.shape[-1]
        k = min(self.k, d) if d is not None else self.k
        return ArraySig(sig.shape[:-1] + (k,), "int64", n=sig.n,
                        mesh=sig.mesh, datum=sig.datum)


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

    # The whole point of this node is a dtype change — tell the plan
    # verifier's drift check it is declared, not silent.
    declares_dtype_change = True

    def _dtype(self):
        return torch.float64 if self.strict else torch.float32

    def apply(self, x):
        return as_tensor(x).to(self._dtype())

    def _batch_fn(self, X):
        return X.to(self._dtype())

    def device_fn(self):
        return self._batch_fn


@dataclass(frozen=True)
class Shuffler(Transformer):
    """Random row permutation (the repartition/shuffle analog;
    reference: nodes/util/Shuffler.scala:14-22). The permutation is numpy's
    ``default_rng(seed)`` draw for both dataset forms: the reference's
    host-list draw, not its ``jax.random`` one for arrays."""

    seed: int = 0

    def apply(self, x):
        return x

    def output_signature(self, sig):
        return sig  # a permutation is a signature passthrough

    def batch_apply(self, data: Dataset) -> Dataset:
        perm = np.random.default_rng(self.seed).permutation(data.n)
        if data.is_host:
            items = data.to_list()
            return Dataset.of([items[i] for i in perm])
        arr = as_tensor(data.array)
        return Dataset(arr[: data.n][torch.from_numpy(perm).to(arr.device)], n=data.n)


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
