"""Image nodes (port of ``keystone_tpu/ops/images/__init__.py``: the
convolutional featurizer, the image plumbing, dense SIFT, LCS and the
Fisher-vector nodes; HOG and DAISY are not ported yet)."""

from .conv import Convolver, Pooler, SymmetricRectifier, Windower
from .core import (
    CenterCornerPatcher,
    Cropper,
    GrayScaler,
    ImageExtractor,
    ImageVectorizer,
    LabeledImage,
    LabelExtractor,
    PixelScaler,
    RandomImageTransformer,
    RandomPatcher,
)
from .fisher import FisherVector, GMMFisherVectorEstimator, ScalaGMMFisherVectorEstimator
from .lcs import LCSExtractor
from .sift import SIFTExtractor

__all__ = [
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "FisherVector",
    "GMMFisherVectorEstimator",
    "GrayScaler",
    "ImageExtractor",
    "ImageVectorizer",
    "LCSExtractor",
    "LabeledImage",
    "LabelExtractor",
    "PixelScaler",
    "Pooler",
    "RandomImageTransformer",
    "RandomPatcher",
    "SIFTExtractor",
    "ScalaGMMFisherVectorEstimator",
    "SymmetricRectifier",
    "Windower",
]
