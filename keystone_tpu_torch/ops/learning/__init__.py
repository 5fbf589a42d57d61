"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper

__all__ = ["BlockLeastSquaresEstimator", "BlockLinearMapper"]
