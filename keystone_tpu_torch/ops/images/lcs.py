"""Local Color Statistics descriptors (reference:
nodes/images/LCSExtractor.scala:25-130; Clinchant et al. 2007).

Port of ``keystone_tpu/ops/images/lcs.py``. Channel means and standard
deviations over subPatchSize boxes come from two box-filter convolutions
(image and image²); descriptors are then gathers at the
keypoint-neighborhood grid, for a whole batch of images at once.
"""

from __future__ import annotations

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.utils.images import as_float, separable_conv2d_same
from keystone_tpu_torch.workflow import Transformer


class LCSExtractor(Transformer):
    """Image -> (numNeighborhood²·channels·2, numKeypoints) matrix of local
    channel means and standard deviations (LCSExtractor.scala:49-129)."""

    def __init__(self, stride: int, stride_start: int, sub_patch_size: int):
        self.stride = stride
        self.stride_start = stride_start
        self.sub_patch_size = sub_patch_size
        # The outermost neighborhood offset is -2s + s//2 - 1; keypoints closer
        # than that to the border would wrap to the opposite image edge.
        min_start = 2 * sub_patch_size - sub_patch_size // 2 + 1
        if stride_start < min_start:
            raise ValueError(
                f"stride_start must be >= {min_start} for sub_patch_size="
                f"{sub_patch_size} so neighborhoods stay inside the image"
            )

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, C) -> (B, C·|offs|²·2, nx·ny)."""
        B, X, Y, C = images.shape
        s = self.sub_patch_size
        box = np.full(s, 1.0 / s)

        means = separable_conv2d_same(images, box, box)  # (B, X, Y, C)
        sq = separable_conv2d_same(images * images, box, box)
        stds = torch.sqrt(torch.clamp_min(sq - means * means, 0.0))

        xs = np.arange(self.stride_start, X - self.stride_start, self.stride)
        ys = np.arange(self.stride_start, Y - self.stride_start, self.stride)

        # Neighborhood offsets (LCSExtractor.scala:63-69).
        start = -2 * s + s // 2 - 1
        end = s + s // 2 - 1
        offs = np.arange(start, end + 1, s)

        # Rows in the reference's order: channel, then neighbor (nx, ny),
        # then mean and std interleaved (LCSExtractor.scala:108-124).
        px = (xs[None, :] + offs[:, None])  # (|offs|, nx)
        py = (ys[None, :] + offs[:, None])  # (|offs|, ny)
        dev = images.device
        ix = torch.from_numpy(px[:, None, :, None]).to(dev)
        iy = torch.from_numpy(py[None, :, None, :]).to(dev)
        stats = torch.stack([means, stds], dim=-1)  # (B, X, Y, C, 2)
        g = stats[:, ix, iy]  # (B, |offs|, |offs|, nx, ny, C, 2)
        g = g.permute(0, 5, 1, 2, 6, 3, 4)  # (B, C, ox, oy, 2, nx, ny)
        return g.reshape(B, -1, len(xs) * len(ys))

    def apply(self, image):
        image = as_float(image)
        if image.ndim == 2:
            image = image[:, :, None]
        return self._features(image[None])[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return data.map(self.apply)
        X = as_tensor(data.array).to(torch.float32)
        return Dataset(self._features(X), n=data.n)
