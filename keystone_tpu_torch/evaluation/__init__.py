"""Evaluation: metrics and evaluators for pipeline outputs (port of
``keystone_tpu/evaluation/__init__.py``)."""

from .metrics import Evaluator, MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = ["Evaluator", "MulticlassClassifierEvaluator", "MulticlassMetrics"]
