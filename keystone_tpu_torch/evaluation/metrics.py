"""Evaluators (reference: evaluation/ — Evaluator.scala:19-35,
MulticlassClassifierEvaluator.scala:23-161).

Port of ``keystone_tpu/evaluation/metrics.py`` (the multiclass evaluator
of the TIMIT, CIFAR and MNIST slices; the binary one of the Amazon
slice, reference: BinaryClassifierEvaluator.scala:17-79; the VOC slice's
mean average precision, MeanAveragePrecisionEvaluator.scala:13-87; the
augmented CIFAR runner's vote, AugmentedExamplesEvaluator.scala:9-76). The
confusion matrix is one device pass (a bincount over ``label * C +
prediction``), read back to the host as numpy; the binary counts are four
device sums; the average precisions and the augmented copies' vote are
host numpy in float64, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Any, Dict, Generic, TypeVar

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.workflow import PipelineDataset

P = TypeVar("P")
L = TypeVar("L")
E = TypeVar("E")


def _as_dataset(x) -> Dataset:
    if isinstance(x, PipelineDataset):
        return x.get()
    return Dataset.of(x)


class Evaluator(Generic[P, L, E]):
    """Computes a metric of predictions vs labels (Evaluator.scala:19-35)."""

    def evaluate(self, predictions: Any, labels: Any) -> E:
        return self._evaluate(_as_dataset(predictions), _as_dataset(labels))

    def _evaluate(self, predictions: Dataset, labels: Dataset) -> E:
        raise NotImplementedError


class MulticlassMetrics:
    """Derived metrics over a confusion matrix
    (reference: MulticlassClassifierEvaluator.scala:44-161).

    confusion[i, j] = count of items with true class i predicted as class j.
    """

    def __init__(self, confusion: np.ndarray):
        self.confusion = np.asarray(confusion, dtype=np.float64)
        self.num_classes = self.confusion.shape[0]
        self.total = self.confusion.sum()

    # -- per-class --

    def class_precision(self, c: int) -> float:
        denom = self.confusion[:, c].sum()
        return float(self.confusion[c, c] / denom) if denom > 0 else 0.0

    def class_recall(self, c: int) -> float:
        denom = self.confusion[c, :].sum()
        return float(self.confusion[c, c] / denom) if denom > 0 else 0.0

    def class_f1(self, c: int) -> float:
        return self.class_fscore(c)

    def class_fscore(self, c: int, beta: float = 1.0) -> float:
        """F_β (the reference's ``classMetrics(c).fScore(beta)``,
        MulticlassClassifierEvaluator.scala:56-66)."""
        p, r = self.class_precision(c), self.class_recall(c)
        b2 = beta * beta
        denom = b2 * p + r
        return (1 + b2) * p * r / denom if denom > 0 else 0.0

    def macro_fscore(self, beta: float = 1.0) -> float:
        return float(
            np.mean([self.class_fscore(c, beta) for c in range(self.num_classes)])
        )

    def micro_fscore(self, beta: float = 1.0) -> float:
        # Micro P == micro R == accuracy for single-label multiclass, so
        # every F_β equals the accuracy too.
        return self.accuracy

    # -- aggregate --

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion) / self.total) if self.total > 0 else 0.0

    @property
    def total_error(self) -> float:
        return 1.0 - self.accuracy

    @property
    def macro_precision(self) -> float:
        return float(np.mean([self.class_precision(c) for c in range(self.num_classes)]))

    @property
    def macro_recall(self) -> float:
        return float(np.mean([self.class_recall(c) for c in range(self.num_classes)]))

    @property
    def macro_f1(self) -> float:
        return self.macro_fscore()

    @property
    def micro_precision(self) -> float:
        return self.accuracy

    micro_recall = micro_precision

    @property
    def micro_f1(self) -> float:
        return self.micro_fscore()

    def summary(self, class_names=None) -> str:
        """Mahout-style pretty print (MulticlassClassifierEvaluator.scala:85-105)."""
        names = class_names or [str(i) for i in range(self.num_classes)]
        lines = [
            "=" * 48,
            "Summary Statistics",
            "-" * 48,
            f"Accuracy          {self.accuracy:.4f}",
            f"Total Error       {self.total_error:.4f}",
            f"Macro Precision   {self.macro_precision:.4f}",
            f"Macro Recall      {self.macro_recall:.4f}",
            f"Macro F1          {self.macro_f1:.4f}",
            "-" * 48,
            "Per-class (precision / recall / f1):",
        ]
        for c in range(self.num_classes):
            lines.append(
                f"  {names[c]:>8}: {self.class_precision(c):.4f} / "
                f"{self.class_recall(c):.4f} / {self.class_f1(c):.4f}"
            )
        lines.append("=" * 48)
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"MulticlassMetrics(accuracy={self.accuracy:.4f}, n={int(self.total)})"


class MulticlassClassifierEvaluator(Evaluator):
    """Single-pass confusion matrix from predicted/true int labels."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def _evaluate(self, predictions: Dataset, labels: Dataset) -> MulticlassMetrics:
        preds = as_tensor(predictions.array).reshape(-1)[: predictions.n].long()
        labs = as_tensor(labels.array, preds.device).reshape(-1)[: labels.n].long()
        C = self.num_classes
        conf = torch.bincount(labs * C + preds, minlength=C * C).reshape(C, C)
        return MulticlassMetrics(conf.cpu().numpy())


@dataclass
class BinaryClassificationMetrics:
    """Contingency counts (reference: BinaryClassifierEvaluator.scala:17-79)."""

    tp: float
    fp: float
    tn: float
    fn: float

    @property
    def accuracy(self) -> float:
        total = self.tp + self.fp + self.tn + self.fn
        return (self.tp + self.tn) / total if total > 0 else 0.0

    @property
    def error(self) -> float:
        return 1.0 - self.accuracy

    @property
    def precision(self) -> float:
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0

    @property
    def recall(self) -> float:
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    @property
    def specificity(self) -> float:
        denom = self.tn + self.fp
        return self.tn / denom if denom > 0 else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class BinaryClassifierEvaluator(Evaluator):
    """Predictions and labels are booleans (or {0, 1} ints)."""

    def _evaluate(self, predictions: Dataset, labels: Dataset) -> BinaryClassificationMetrics:
        preds = as_tensor(predictions.array).reshape(-1).bool()[: predictions.n]
        labs = as_tensor(labels.array, preds.device).reshape(-1).bool()[: labels.n]
        counts = torch.stack([(preds & labs).sum(), (preds & ~labs).sum(),
                              (~preds & ~labs).sum(), (~preds & labs).sum()])
        return BinaryClassificationMetrics(*(float(c) for c in counts.cpu().tolist()))


class MeanAveragePrecisionEvaluator(Evaluator):
    """VOC-style per-class average precision (reference:
    evaluation/MeanAveragePrecisionEvaluator.scala:13-87, after the enceval
    toolkit MATLAB code).

    predictions: per-example class-score vectors (n, numClasses);
    labels: per-example arrays of valid class ids (host list or (n, k) array).
    Returns a (numClasses,) float64 numpy array of 11-point interpolated APs.
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def _evaluate(self, predictions: Dataset, labels: Dataset) -> np.ndarray:
        scores = np.asarray(predictions.to_numpy(), dtype=np.float64)  # (n, C)
        n = scores.shape[0]
        gt = np.zeros((n, self.num_classes), dtype=np.float64)
        for i, labs in enumerate(labels.to_list()):
            for lab in np.atleast_1d(np.asarray(labs, dtype=np.int64)):
                if 0 <= lab < self.num_classes:
                    gt[i, lab] = 1.0

        # Per class: sort by descending score (stable, the reference's
        # sortBy(..).reverse tie order), accumulate true and false positives.
        order = np.argsort(-scores, axis=0, kind="stable")
        gt_sorted = np.take_along_axis(gt, order, axis=0)
        tps = np.cumsum(gt_sorted, axis=0)
        fps = np.cumsum(1.0 - gt_sorted, axis=0)
        totals = gt.sum(axis=0)

        aps = np.zeros(self.num_classes)
        with np.errstate(invalid="ignore", divide="ignore"):
            recalls = tps / totals[None, :]
            precisions = tps / (tps + fps)
        for c in range(self.num_classes):
            ap = 0.0
            for t in np.linspace(0.0, 1.0, 11):
                px = precisions[recalls[:, c] >= t, c]
                ap += (px.max() if px.size else 0.0) / 11.0
            aps[c] = ap
        return aps


class AggregationPolicy:
    """Vote-aggregation policies for augmented test copies
    (reference: AugmentedExamplesEvaluator.scala:9-13)."""

    AVERAGE = "average"
    BORDA = "borda"


class AugmentedExamplesEvaluator(Evaluator):
    """Aggregate the predictions of the augmented copies of each underlying
    example (grouped by name) before the multiclass evaluation
    (reference: evaluation/AugmentedExamplesEvaluator.scala:15-76). The
    scores come to the host as float64 and each group is voted there, in
    the reference's order of operations (a group's mean score, or its
    summed Borda ranks, then the argmax)."""

    def __init__(self, names, num_classes: int, policy: str = AggregationPolicy.AVERAGE):
        self.names = names if isinstance(names, list) else list(names)
        self.num_classes = num_classes
        if policy not in (AggregationPolicy.AVERAGE, AggregationPolicy.BORDA):
            raise ValueError(f"unknown aggregation policy {policy}")
        self.policy = policy

    @staticmethod
    def _borda(preds: np.ndarray) -> np.ndarray:
        # The rank of each class in each augmented copy, summed
        # (AugmentedExamplesEvaluator.scala:31-39).
        ranks = np.argsort(np.argsort(preds, axis=1, kind="stable"), axis=1)
        return ranks.sum(axis=0).astype(np.float64)

    def _evaluate(self, predictions: Dataset, labels: Dataset) -> MulticlassMetrics:
        scores = np.asarray(predictions.to_numpy(), dtype=np.float64)
        labs = np.asarray(labels.to_numpy()).reshape(-1).astype(np.int64)
        if len(self.names) != scores.shape[0]:
            raise ValueError("names must align with predictions")

        groups: Dict[Any, list] = {}
        for i, name in enumerate(self.names):
            groups.setdefault(name, []).append(i)

        agg_preds, agg_labels = [], []
        for name, idxs in groups.items():
            group_labels = labs[idxs]
            if len(set(group_labels.tolist())) != 1:
                raise AssertionError(f"conflicting labels for group {name}")
            p = scores[idxs]
            agg = self._borda(p) if self.policy == AggregationPolicy.BORDA else p.mean(axis=0)
            agg_preds.append(int(np.argmax(agg)))
            agg_labels.append(int(group_labels[0]))

        return MulticlassClassifierEvaluator(self.num_classes).evaluate(
            Dataset.of(np.asarray(agg_preds)), Dataset.of(np.asarray(agg_labels))
        )
