"""Image plumbing nodes: scalers, croppers, patchers, vectorizer
(reference: nodes/images/{GrayScaler,PixelScaler,Cropper,ImageVectorizer,
CenterCornerPatcher,RandomPatcher,LabeledImageExtractors}.scala).

Port of ``keystone_tpu/ops/images/core.py``. Batches are ``(n, x, y, c)``
tensors. :class:`RandomPatcher` draws its patch corners with numpy's
``default_rng(seed)`` on the host, as the reference does, and gathers the
patches on the images' device: one seed gives the same patches in both
packages. ``RandomImageTransformer`` is not ported yet (the augmented CIFAR
runner's node).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.utils import images as image_utils
from keystone_tpu_torch.workflow import Transformer


@dataclass
class LabeledImage:
    """An image with an integer label and optional filename
    (reference: utils/images/LabeledImage in ImageUtils.scala)."""

    image: Any
    label: int
    filename: str = ""


class ImageExtractor(Transformer):
    """LabeledImage -> image (reference: nodes/images/LabeledImageExtractors.scala)."""

    def apply(self, x: LabeledImage):
        return x.image


class LabelExtractor(Transformer):
    """LabeledImage -> label (reference: nodes/images/LabeledImageExtractors.scala)."""

    def apply(self, x: LabeledImage):
        return x.label


class GrayScaler(Transformer):
    """RGB -> luminance (reference: nodes/images/GrayScaler.scala)."""

    def apply(self, img):
        return image_utils.to_grayscale(img)

    def device_fn(self):
        return image_utils.to_grayscale


class PixelScaler(Transformer):
    """Rescale byte pixels to [0, 1) (reference: nodes/images/PixelScaler.scala)."""

    def apply(self, img):
        return as_tensor(img).to(torch.float32) / 255.0

    def _batch_fn(self, X):
        return X.to(torch.float32) / 255.0

    def device_fn(self):
        return self._batch_fn


class Cropper(Transformer):
    """Fixed-window crop (reference: nodes/images/Cropper.scala)."""

    def __init__(self, start_x: int, start_y: int, end_x: int, end_y: int):
        self.start_x, self.start_y = start_x, start_y
        self.end_x, self.end_y = end_x, end_y

    def apply(self, img):
        return image_utils.crop(img, self.start_x, self.start_y, self.end_x, self.end_y)

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return data.map(self.apply)
        return data.map_batch(
            lambda X: X[:, self.start_x:self.end_x, self.start_y:self.end_y, :]
        )


class ImageVectorizer(Transformer):
    """Flatten an image to a vector, row-major over (x, y, c)
    (reference: nodes/images/ImageVectorizer.scala)."""

    def apply(self, img):
        return as_tensor(img).reshape(-1)

    def _batch_fn(self, X):
        return X.reshape(X.shape[0], -1)

    def device_fn(self):
        return self._batch_fn


class CenterCornerPatcher(Transformer):
    """Four corner patches + the center patch (optionally with horizontal
    flips): n images -> n·5 (or n·10) patches
    (reference: nodes/images/CenterCornerPatcher.scala:18-50)."""

    def __init__(self, patch_size_x: int, patch_size_y: int, horizontal_flips: bool = False):
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self.horizontal_flips = horizontal_flips

    def _patches(self, images):
        _, X, Y, _ = images.shape
        px, py = self.patch_size_x, self.patch_size_y
        start_xs = [0, X - px, 0, X - px, (X - px) // 2]
        start_ys = [0, 0, Y - py, Y - py, (Y - py) // 2]
        out = []
        for sx, sy in zip(start_xs, start_ys):
            patch = images[:, sx:sx + px, sy:sy + py, :]
            out.append(patch)
            if self.horizontal_flips:
                out.append(torch.flip(patch, dims=[2]))
        return torch.stack(out, dim=1)  # (n, patches_per_image, px, py, C)

    def apply(self, img):
        return self._patches(as_tensor(img)[None])[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        X = as_tensor(data.array).to(torch.float32)[: data.n]
        out = self._patches(X)
        return Dataset(out.reshape((-1,) + tuple(out.shape[2:])))

    @property
    def patches_per_image(self) -> int:
        return 10 if self.horizontal_flips else 5


class RandomPatcher(Transformer):
    """Uniformly random patches: n images -> n·num_patches patches
    (reference: nodes/images/RandomPatcher.scala:16-47). The corners are
    numpy draws from ``default_rng(seed)``, the reference's, so both
    packages take the same patches."""

    def __init__(self, num_patches: int, patch_size_x: int, patch_size_y: int,
                 seed: int = 12334):
        self.num_patches = num_patches
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self.seed = seed

    def _patches(self, images):
        n, X, Y, _ = images.shape
        px, py = self.patch_size_x, self.patch_size_y
        k = self.num_patches
        rng = np.random.default_rng(self.seed)
        sx = rng.integers(0, X - px + 1, size=(n, k))
        sy = rng.integers(0, Y - py + 1, size=(n, k))

        def index(a):
            return torch.from_numpy(a).to(images.device)

        idx_n = index(np.arange(n)[:, None, None, None])
        rx = index(sx[:, :, None, None] + np.arange(px)[None, None, :, None])  # (n,k,px,1)
        ry = index(sy[:, :, None, None] + np.arange(py)[None, None, None, :])  # (n,k,1,py)
        return images[idx_n, rx, ry, :]  # (n, k, px, py, C)

    def apply(self, img):
        return self._patches(as_tensor(img)[None])[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        X = as_tensor(data.array).to(torch.float32)[: data.n]
        out = self._patches(X)
        return Dataset(out.reshape((-1,) + tuple(out.shape[2:])))
