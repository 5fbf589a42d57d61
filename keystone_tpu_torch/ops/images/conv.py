"""Convolution-family image nodes: Convolver, Pooler, Windower,
SymmetricRectifier.

Port of ``keystone_tpu/ops/images/conv.py``. The reference convolves by
im2col into a reused patch matrix and one GEMM per image
(nodes/images/Convolver.scala:128-220); the JAX package runs the batch as
one program, through its Pallas kernel on a TPU. Here ``Convolver`` runs
the ``conv_featurize`` CUDA kernel (``ops/cuda_images.py``) on CUDA
tensors, which makes the patches in shared memory and never stores the
patch matrix, and raises for a shape the kernel refuses. On CPU tensors it
runs the kernel's plain version, the reference's XLA branch:
:func:`im2col`, :func:`normalize_patch_rows`, the whitening-mean
subtraction and one product.

Layout: NHWC batches ``(n, x, y, c)``; patches and packed filters are
flattened row-major over ``(x, y, c)``, the reference's order.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_images
from keystone_tpu_torch.ops.cuda_images import im2col, normalize_patch_rows
from keystone_tpu_torch.utils import images as image_utils
from keystone_tpu_torch.workflow import Transformer

__all__ = [
    "Convolver", "Pooler", "SymmetricRectifier", "Windower", "im2col",
    "normalize_patch_rows",
]


def _as_batch(x) -> tuple:
    """Return (batch tensor (n, X, Y, C), was_single)."""
    x = as_tensor(x)
    if x.dim() == 3:
        return x[None], True
    return x, False


class Convolver(Transformer):
    """Convolve images with a filter bank via im2col + one product
    (reference: nodes/images/Convolver.scala:20-221).

    ``filters`` is ``(num_filters, patch_size²·channels)``, already whitened
    if a whitener is supplied (see :meth:`build`), on the device the
    convolution runs on. The output image is ``(X-p+1, Y-p+1, num_filters)``.
    """

    def __init__(
        self,
        filters,
        img_x: int,
        img_y: int,
        img_channels: int,
        whitener=None,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
    ):
        self.filters = as_tensor(filters).to(torch.float32)
        self.img_x = img_x
        self.img_y = img_y
        self.img_channels = img_channels
        self.whitener = whitener
        self.normalize_patches = normalize_patches
        self.var_constant = var_constant
        self.patch_size = int(round((self.filters.shape[1] / img_channels) ** 0.5))

    @staticmethod
    def pack_filters(filter_images) -> torch.Tensor:
        """(k, p, p, c) filter images -> (k, p·p·c) rows, row-major (x, y, c)
        (reference: Convolver.packFilters, Convolver.scala:99-125)."""
        f = as_tensor(filter_images).to(torch.float32)
        return f.reshape(f.shape[0], -1)

    @classmethod
    def build(
        cls,
        filter_images,
        whitener=None,
        normalize_patches: bool = True,
        var_constant: float = 10.0,
        flip_filters: bool = False,
    ) -> "Convolver":
        """User-facing factory: takes unwhitened filter images ``(k, p, p, c)``
        and folds the whitening into the filter matrix
        (reference: Convolver.apply, Convolver.scala:60-89)."""
        f = as_tensor(filter_images).to(torch.float32)
        if flip_filters:
            # MATLAB convnd parity: full x/y/channel reversal
            # (Convolver.scala:67-70 via ImageUtils.flipImage).
            f = torch.stack([image_utils.flip_image(fi) for fi in f])
        packed = cls.pack_filters(f)
        if whitener is not None:
            packed = whitener.apply(packed) @ whitener.whitener.T
        conv = cls(
            packed,
            img_x=-1,
            img_y=-1,
            img_channels=f.shape[3],
            whitener=whitener,
            normalize_patches=normalize_patches,
            var_constant=var_constant,
        )
        conv.patch_size = f.shape[1]
        return conv

    def _convolve(self, images):
        # float32 by design, as in the reference: float64 loader output is
        # narrowed before any arithmetic.
        images = as_tensor(images, self.filters.device).to(torch.float32)
        return cuda_images.conv_featurize(
            images,
            self.filters,
            self.whitener.means if self.whitener is not None else None,
            patch_size=self.patch_size,
            normalize_patches=self.normalize_patches,
            var_constant=self.var_constant,
        )

    def apply(self, img):
        batch, single = _as_batch(img)
        out = self._convolve(batch)
        return out[0] if single else out

    # The convolution computes in float32 BY DESIGN: float64 image input
    # narrowing to f32 here is the declared compute dtype, not silent
    # drift — tell the plan verifier so (workflow/verify.py).
    declares_dtype_change = True

    def device_fn(self):
        return self._convolve


class Pooler(Transformer):
    """Strided spatial pooling with a pixel function applied first
    (reference: nodes/images/Pooler.scala:21-69).

    Pool k covers ``[k·stride, k·stride + pool_size)`` in each spatial axis
    (the reference's strideStart = poolSize/2 with windows centered there),
    truncated at the image edge. ``pool_function`` is "sum" or "max".
    """

    def __init__(
        self,
        stride: int,
        pool_size: int,
        pixel_function: Optional[Callable] = None,
        pool_function: Union[str, Callable] = "sum",
    ):
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_function = pixel_function
        if callable(pool_function):
            raise TypeError('pool_function must be "sum" or "max"')
        if pool_function not in ("sum", "max"):
            raise ValueError(f"unknown pool_function {pool_function}")
        self.pool_function = pool_function

    def _pool(self, images):
        _, X, Y, _ = images.shape
        if self.pixel_function is not None:
            images = self.pixel_function(images)
        start = self.pool_size // 2
        npx = -(-(X - start) // self.stride)  # ceil
        npy = -(-(Y - start) // self.stride)
        ext_x = (npx - 1) * self.stride + self.pool_size
        ext_y = (npy - 1) * self.stride + self.pool_size
        pad_val = -float("inf") if self.pool_function == "max" else 0.0
        if ext_x > X or ext_y > Y:
            images = torch.nn.functional.pad(
                images, (0, 0, 0, max(0, ext_y - Y), 0, max(0, ext_x - X)), value=pad_val
            )
        images = images[:, :ext_x, :ext_y, :]
        # (n, npx, npy, C, pool, pool) windows: views, no copy.
        windows = images.unfold(1, self.pool_size, self.stride).unfold(
            2, self.pool_size, self.stride
        )
        if self.pool_function == "max":
            return windows.amax(dim=(-2, -1))
        return windows.sum(dim=(-2, -1))

    def apply(self, img):
        batch, single = _as_batch(img)
        out = self._pool(batch)
        return out[0] if single else out

    def _batch_fn(self, X):
        return self._pool(X.to(torch.float32))

    def device_fn(self):
        return self._batch_fn


class Windower(Transformer):
    """Extract all stride-strided windows as separate images
    (reference: nodes/images/Windower.scala:13-56). A batch of n images
    becomes a batch of n·numWindows window images (RDD flatMap analog)."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def _windows(self, images):
        n, X, Y, C = images.shape
        w = self.window_size
        xs = np.arange(0, X - w + 1, self.stride)
        ys = np.arange(0, Y - w + 1, self.stride)
        rows = torch.from_numpy(xs[:, None] + np.arange(w)[None, :]).to(images.device)
        cols = torch.from_numpy(ys[:, None] + np.arange(w)[None, :]).to(images.device)
        out = images[:, rows, :, :]  # (n, nx, w, Y, C)
        out = out[:, :, :, cols, :]  # (n, nx, w, ny, w, C)
        out = out.permute(0, 1, 3, 2, 4, 5)  # (n, nx, ny, w, w, C)
        return out.reshape(n, len(xs) * len(ys), w, w, C)

    def apply(self, img):
        batch, single = _as_batch(img)
        out = self._windows(batch)
        return out[0] if single else out.reshape((-1,) + tuple(out.shape[2:]))

    def batch_apply(self, data: Dataset) -> Dataset:
        out = self._windows(as_tensor(data.array).to(torch.float32)[: data.n])
        return Dataset(out.reshape((-1,) + tuple(out.shape[2:])))


class SymmetricRectifier(Transformer):
    """Two-sided ReLU doubling the channel count: channels c and c+C hold
    max(maxVal, x−α) and max(maxVal, −x−α)
    (reference: nodes/images/SymmetricRectifier.scala:7-32)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def _rectify(self, x):
        pos = torch.clamp_min(x - self.alpha, self.max_val)
        neg = torch.clamp_min(-x - self.alpha, self.max_val)
        return torch.cat([pos, neg], dim=-1)

    def apply(self, img):
        return self._rectify(as_tensor(img))

    def device_fn(self):
        return self._rectify
