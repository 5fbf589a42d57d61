"""Evaluation: metrics and evaluators for pipeline outputs (port of
``keystone_tpu/evaluation/__init__.py``)."""

from .metrics import (
    AggregationPolicy,
    AugmentedExamplesEvaluator,
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
    Evaluator,
    MeanAveragePrecisionEvaluator,
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)

__all__ = [
    "AggregationPolicy",
    "AugmentedExamplesEvaluator",
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "Evaluator",
    "MeanAveragePrecisionEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
