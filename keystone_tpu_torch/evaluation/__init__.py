"""Evaluation: metrics and evaluators for pipeline outputs (port of
``keystone_tpu/evaluation/__init__.py``)."""

from .metrics import (
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
    Evaluator,
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)

__all__ = [
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "Evaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
