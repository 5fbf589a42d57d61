"""Image nodes (port of ``keystone_tpu/ops/images/__init__.py``; the
convolutional featurizer and the image plumbing so far — the SIFT, HOG,
DAISY, LCS and Fisher-vector nodes wait for their slice)."""

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
    RandomPatcher,
)

__all__ = [
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "GrayScaler",
    "ImageExtractor",
    "ImageVectorizer",
    "LabeledImage",
    "LabelExtractor",
    "PixelScaler",
    "Pooler",
    "RandomPatcher",
    "SymmetricRectifier",
    "Windower",
]
