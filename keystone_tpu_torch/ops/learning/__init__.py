"""Solver and model nodes (reference: nodes/learning/; port of
``keystone_tpu/ops/learning/__init__.py``)."""

from .block import BlockLeastSquaresEstimator, BlockLinearMapper
from .bwls import BlockWeightedLeastSquaresEstimator
from .clustering import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
    KMeansModel,
    KMeansPlusPlusEstimator,
)
from .cost import LeastSquaresEstimator, TransformerLabelEstimatorChain
from .kernel import (
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
    NystromKernelMapper,
    NystromKernelRidge,
)
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .linear import (
    LinearMapEstimator,
    LinearMapper,
    LocalLeastSquaresEstimator,
    SketchedLeastSquaresEstimator,
    SparseLinearMapper,
)
from .pca import (
    ApproximatePCAEstimator,
    BatchPCATransformer,
    ColumnPCAEstimator,
    DistributedColumnPCAEstimator,
    DistributedPCAEstimator,
    LocalColumnPCAEstimator,
    PCAEstimator,
    PCATransformer,
    ZCAWhitener,
    ZCAWhitenerEstimator,
)
from .sketch import IterativeHessianSketch, SketchedLeastSquares
from .streaming_ls import (
    BlockStreamedLeastSquares,
    CosineBankFeaturize,
    StreamingFeaturizedLeastSquares,
    StreamingFeaturizedLinearModel,
    StreamingLeastSquaresChoice,
    cosine_bank_featurize,
)

__all__ = [
    "ApproximatePCAEstimator", "BatchPCATransformer", "BlockLeastSquaresEstimator",
    "BlockLinearMapper", "BlockStreamedLeastSquares", "BlockWeightedLeastSquaresEstimator",
    "ColumnPCAEstimator", "DistributedColumnPCAEstimator", "DistributedPCAEstimator",
    "GaussianMixtureModel", "GaussianMixtureModelEstimator", "KMeansModel",
    "KMeansPlusPlusEstimator", "LocalColumnPCAEstimator", "PCAEstimator", "PCATransformer",
    "CosineBankFeaturize", "DenseLBFGSwithL2", "GaussianKernelGenerator",
    "GaussianKernelTransformer", "IterativeHessianSketch", "KernelBlockLinearMapper",
    "KernelRidgeRegression", "LeastSquaresEstimator", "LinearMapEstimator", "LinearMapper",
    "LocalLeastSquaresEstimator", "NystromKernelMapper", "NystromKernelRidge",
    "SketchedLeastSquares", "SketchedLeastSquaresEstimator",
    "SparseLBFGSwithL2", "SparseLinearMapper", "StreamingFeaturizedLeastSquares",
    "StreamingFeaturizedLinearModel", "StreamingLeastSquaresChoice",
    "TransformerLabelEstimatorChain", "ZCAWhitener", "ZCAWhitenerEstimator",
    "cosine_bank_featurize",
]
