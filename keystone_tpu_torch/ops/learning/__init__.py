"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper
from .kernel import (
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from .linear import LinearMapEstimator, LinearMapper
from .pca import ZCAWhitener, ZCAWhitenerEstimator

__all__ = [
    "BlockLeastSquaresEstimator", "BlockLinearMapper", "GaussianKernelGenerator",
    "GaussianKernelTransformer", "KernelBlockLinearMapper", "KernelRidgeRegression",
    "LinearMapEstimator", "LinearMapper", "ZCAWhitener", "ZCAWhitenerEstimator",
]
