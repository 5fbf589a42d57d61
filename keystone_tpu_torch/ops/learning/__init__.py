"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper
from .cost import LeastSquaresEstimator, TransformerLabelEstimatorChain
from .kernel import (
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .linear import (
    LinearMapEstimator,
    LinearMapper,
    LocalLeastSquaresEstimator,
    SketchedLeastSquaresEstimator,
    SparseLinearMapper,
)
from .pca import ZCAWhitener, ZCAWhitenerEstimator
from .sketch import IterativeHessianSketch, SketchedLeastSquares

__all__ = [
    "BlockLeastSquaresEstimator", "BlockLinearMapper", "DenseLBFGSwithL2",
    "GaussianKernelGenerator", "GaussianKernelTransformer", "IterativeHessianSketch",
    "KernelBlockLinearMapper", "KernelRidgeRegression", "LeastSquaresEstimator",
    "LinearMapEstimator", "LinearMapper", "LocalLeastSquaresEstimator", "SketchedLeastSquares",
    "SketchedLeastSquaresEstimator", "SparseLBFGSwithL2", "SparseLinearMapper",
    "TransformerLabelEstimatorChain", "ZCAWhitener", "ZCAWhitenerEstimator",
]
