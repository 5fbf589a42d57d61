"""Evaluation: metrics and evaluators for pipeline outputs (port of
``keystone_tpu/evaluation/__init__.py``)."""

from .metrics import (
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
    Evaluator,
    MeanAveragePrecisionEvaluator,
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)

__all__ = [
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "Evaluator",
    "MeanAveragePrecisionEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
