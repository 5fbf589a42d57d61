"""Image nodes (port of ``keystone_tpu/ops/images/__init__.py``: the
convolutional featurizer, the image plumbing, dense SIFT, LCS, HOG, DAISY
and the Fisher-vector nodes)."""

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
from .hog import HogExtractor
from .daisy import DaisyExtractor
from .lcs import LCSExtractor
from .sift import SIFTExtractor

__all__ = [
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "DaisyExtractor",
    "FisherVector",
    "GMMFisherVectorEstimator",
    "GrayScaler",
    "HogExtractor",
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
