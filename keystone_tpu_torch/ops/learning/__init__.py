"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper
from .kernel import (
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .linear import LinearMapEstimator, LinearMapper, SparseLinearMapper
from .pca import ZCAWhitener, ZCAWhitenerEstimator

__all__ = [
    "BlockLeastSquaresEstimator", "BlockLinearMapper", "DenseLBFGSwithL2",
    "GaussianKernelGenerator", "GaussianKernelTransformer", "KernelBlockLinearMapper",
    "KernelRidgeRegression", "LinearMapEstimator", "LinearMapper", "SparseLBFGSwithL2",
    "SparseLinearMapper", "ZCAWhitener", "ZCAWhitenerEstimator",
]
