"""DAISY dense descriptors, Tola et al. (reference:
nodes/images/DaisyExtractor.scala:28-201).

Port of ``keystone_tpu/ops/images/daisy.py``. The per-angle orientation
maps and their cascaded Gaussian blurs are batched separable convolutions
(``utils/images.separable_conv2d_same``) over a whole batch of images, and
the ring sampling is a static set of gathers (Q·T offsets). No kernel of
its own: ``torch`` operations (the reference's are XLA).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.utils.images import as_float, separable_conv2d_same
from keystone_tpu_torch.workflow import Transformer

_FILTER1 = np.array([1.0, 0.0, -1.0])
_FILTER2 = np.array([1.0, 2.0, 1.0])


class DaisyExtractor(Transformer):
    """Image -> (H·(T·Q+1), numKeypoints) DAISY feature matrix
    (reference: DaisyExtractor.scala:28-201)."""

    def __init__(
        self,
        daisy_t: int = 8,
        daisy_q: int = 3,
        daisy_r: int = 7,
        daisy_h: int = 8,
        pixel_border: int = 16,
        stride: int = 4,
        patch_size: int = 24,
    ):
        self.T, self.Q, self.R, self.H = daisy_t, daisy_q, daisy_r, daisy_h
        self.pixel_border = pixel_border
        self.stride = stride
        self.patch_size = patch_size
        self.feature_threshold = 1e-8
        self.conv_threshold = 1e-6

        # Incremental blur kernels (DaisyExtractor.scala:49-64).
        sigma_sq = [(self.R * n / (2.0 * self.Q)) ** 2 for n in range(self.Q + 1)]
        diffs = [b - a for a, b in zip(sigma_sq, sigma_sq[1:])]
        self.g = []
        for t in diffs:
            rad = int(math.ceil(math.sqrt(
                -2 * t * math.log(self.conv_threshold) - t * math.log(2 * math.pi * t))))
            ns = np.arange(-rad, rad + 1, dtype=np.float64)
            self.g.append(np.exp(-(ns ** 2) / (2 * t)) / math.sqrt(2 * math.pi * t))

        # Ring sampling offsets by (level, angle): radius R(1+l)/Q, angle
        # 2π(t-1)/T, the (t-1) kept for parity (DaisyExtractor.scala:75-92,
        # 174); Java math.round = floor(x + 0.5).
        self.offsets = np.zeros((self.Q, self.T, 2), dtype=np.int64)
        for level in range(self.Q):
            rad = self.R * (1.0 + level) / self.Q
            for t in range(self.T):
                theta = 2 * math.pi * (t - 1) / self.T
                self.offsets[level, t, 0] = int(math.floor(rad * math.sin(theta) + 0.5))
                self.offsets[level, t, 1] = int(math.floor(rad * math.cos(theta) + 0.5))

    def _normalize(self, h: torch.Tensor, dim: int) -> torch.Tensor:
        norm = torch.sqrt((h * h).sum(dim=dim, keepdim=True))
        return torch.where(norm > self.feature_threshold, h / norm, torch.zeros((), dtype=h.dtype,
                                                                                device=h.device))

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, C) -> (B, H·(T·Q+1), nx·ny), from channel 0 as the
        reference reads it."""
        image = images[..., :1]
        B, X, Y = image.shape[:3]
        ix = separable_conv2d_same(image, _FILTER1, _FILTER2)[..., 0]
        iy = separable_conv2d_same(image, _FILTER2, _FILTER1)[..., 0]

        # Orientation layers with cascaded blurs (DaisyExtractor.scala:113-135):
        # the H angles' planes blurred together, one plane a channel.
        angles = 2 * math.pi * np.arange(self.H) / self.H
        level = torch.stack([torch.clamp_min(math.cos(a) * ix + math.sin(a) * iy, 0.0)
                             for a in angles], dim=-1)  # (B, X, Y, H)
        layers = [separable_conv2d_same(level, self.g[0], self.g[0])]
        for q in range(1, self.Q):
            layers.append(separable_conv2d_same(layers[-1], self.g[q], self.g[q]))

        xs = np.arange(self.pixel_border, X - self.pixel_border, self.stride)
        ys = np.arange(self.pixel_border, Y - self.pixel_border, self.stride)
        nx, ny = len(xs), len(ys)
        dev = images.device

        def sample(layer, ox=0, oy=0):  # (B, H, nx·ny), H normalized
            gx = torch.from_numpy(xs + ox).to(dev)
            gy = torch.from_numpy(ys + oy).to(dev)
            vals = layer[:, gx[:, None], gy[None, :], :]  # (B, nx, ny, H)
            return self._normalize(vals.permute(0, 3, 1, 2).reshape(B, self.H, nx * ny), 1)

        # Rows: the centre, then angle-major / level-minor ring histograms
        # (DaisyExtractor.scala:155-186).
        blocks = [sample(layers[0])]
        for t in range(self.T):
            for q in range(self.Q):
                ox, oy = int(self.offsets[q, t, 0]), int(self.offsets[q, t, 1])
                blocks.append(sample(layers[q], ox, oy))
        return torch.cat(blocks, dim=1)

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
