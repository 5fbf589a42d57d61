"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper
from .linear import LinearMapEstimator, LinearMapper

__all__ = [
    "BlockLeastSquaresEstimator", "BlockLinearMapper", "LinearMapEstimator", "LinearMapper",
]
