"""Dense multi-scale SIFT (the reference's native tier: vlfeat vl_dsift via
JNI — images/external/SIFTExtractor.scala:16-40, src/main/cpp/VLFeat.cxx:38-180).

Port of ``keystone_tpu/ops/images/sift.py``. Per scale, orientation energy
maps (8 planes) are built from the smoothed gradient field, box-filtered
(vl_dsift's flat-window approximation) and gathered at the dense keypoint
grid's 4×4 spatial bins; descriptors come back in the reference's
(128, numDescriptors) layout.

Parameters mirror the reference: per scale s, binSize_s = bin + 2s,
step_s = step + s·scaleStep, smoothing σ = binSize_s / 6 (magnif), flat
window, contrast threshold 0.005 zeroing, descriptors scaled to [0, 255]
shorts via min(⌊512·v⌋, 255).

The reference runs a host loop over a batch's images, one compiled program
an image shape; here every image of a batch runs through each scale at
once, in chunks of :data:`SIFT_CHUNK_IMAGES` images, and gives the same
descriptors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.utils.images import gaussian_blur, separable_conv2d_same, to_grayscale
from keystone_tpu_torch.workflow import Transformer

_NUM_ORIENTATIONS = 8
_MAGNIF = 6.0
_CONTRAST_THRESHOLD = 0.005

# Images a chunk of the batched extractor: 1,024 images of 64 x 64 hold
# about 0.5 GB of orientation planes.
SIFT_CHUNK_IMAGES = 1024


def _scale_descriptors(images: torch.Tensor, bin_size: int, step: int) -> torch.Tensor:
    """Dense descriptors for one scale of a batch. images: (B, X, Y)
    grayscale float32 in [0, 1]. Returns (B, 128, numDescriptors)."""
    return torch.clamp_max(torch.floor(_scale_values(images, bin_size, step)), 255.0)


def _scale_values(images: torch.Tensor, bin_size: int, step: int) -> torch.Tensor:
    """:func:`_scale_descriptors` before its quantization: 512·v of each
    normalized, clipped, renormalized and contrast-zeroed descriptor v."""
    B, X, Y = images.shape
    smoothed = gaussian_blur(images[..., None], bin_size / _MAGNIF)[..., 0]

    dx = torch.zeros_like(smoothed)
    dx[:, 1:-1, :] = (smoothed[:, 2:, :] - smoothed[:, :-2, :]) * 0.5
    dy = torch.zeros_like(smoothed)
    dy[:, :, 1:-1] = (smoothed[:, :, 2:] - smoothed[:, :, :-2]) * 0.5
    mag = torch.sqrt(dx * dx + dy * dy)
    angle = torch.atan2(dy, dx)  # [-pi, pi]

    # Linear orientation binning into the two adjacent of 8 bins. lo != hi,
    # so each (o, x, y) cell takes one term: a scatter, then a scatter-add
    # into distinct cells, gives the reference's sums.
    t = angle / (2 * math.pi) * _NUM_ORIENTATIONS  # [-4, 4]
    t = torch.remainder(t, _NUM_ORIENTATIONS)
    lo = torch.floor(t)
    frac = t - lo
    lo_i = lo.to(torch.int64) % _NUM_ORIENTATIONS
    hi_i = (lo_i + 1) % _NUM_ORIENTATIONS
    planes = torch.zeros((B, _NUM_ORIENTATIONS, X, Y), dtype=torch.float32,
                         device=images.device)
    planes.scatter_(1, lo_i[:, None], (mag * (1.0 - frac))[:, None])
    planes.scatter_add_(1, hi_i[:, None], (mag * frac)[:, None])
    del dx, dy, mag, angle, t, lo, frac, lo_i, hi_i

    # Flat-window spatial pooling: box sum of width binSize per bin.
    ones = np.ones(bin_size, dtype=np.float32)
    pooled = separable_conv2d_same(planes.permute(0, 2, 3, 1), ones, ones)  # (B, X, Y, 8)
    del planes

    # Keypoint grid: a descriptor anchored at its top-left bin; the 4x4 bin
    # centres sit at anchor + i*bin + bin//2.
    extent = 3 * bin_size + bin_size // 2
    anchors_x = np.arange(0, X - extent, step)
    anchors_y = np.arange(0, Y - extent, step)
    if len(anchors_x) == 0 or len(anchors_y) == 0:
        return torch.zeros((B, 128, 0), dtype=torch.float32, device=images.device)
    centers = np.arange(4) * bin_size + bin_size // 2
    gx = torch.from_numpy(anchors_x[:, None] + centers[None, :]).to(images.device)  # (nax, 4)
    gy = torch.from_numpy(anchors_y[:, None] + centers[None, :]).to(images.device)  # (nay, 4)
    # (B, nax, 4, nay, 4, 8): descriptor layout (bx, by, o), o fastest.
    vals = pooled[:, gx[:, :, None, None], gy[None, None, :, :], :]
    desc = vals.permute(0, 1, 3, 2, 4, 5).reshape(B, len(anchors_x) * len(anchors_y), 128)

    # Normalize, clip at 0.2, renormalize; zero low-contrast descriptors.
    norm = torch.sqrt(torch.sum(desc * desc, dim=2, keepdim=True))
    d1 = torch.clamp_max(desc / torch.clamp_min(norm, 1e-12), 0.2)
    norm2 = torch.sqrt(torch.sum(d1 * d1, dim=2, keepdim=True))
    d2 = d1 / torch.clamp_min(norm2, 1e-12)
    # vl_dsift's keypoint norm is the mean descriptor energy before
    # normalization; the raw norm is the contrast proxy, as in the reference.
    d2 = torch.where(norm > _CONTRAST_THRESHOLD, d2, torch.zeros((), device=d2.device))

    return (512.0 * d2).transpose(1, 2)  # (B, 128, n)


class SIFTExtractor(Transformer):
    """Image -> (128, numDescriptors) dense multi-scale SIFT matrix
    (reference: images/external/SIFTExtractor.scala:16-40)."""

    def __init__(self, step_size: int = 3, bin_size: int = 4, scales: int = 4,
                 scale_step: int = 1):
        self.step_size = step_size
        self.bin_size = bin_size
        self.scales = scales
        self.scale_step = scale_step
        self.descriptor_size = 128

    def _extract(self, images: torch.Tensor) -> torch.Tensor:
        """(B, X, Y) grayscale -> (B, 128, numDescriptors)."""
        return torch.cat([
            _scale_descriptors(images, self.bin_size + 2 * s, self.step_size + s * self.scale_step)
            for s in range(self.scales)
        ], dim=2)

    def apply(self, image):
        image = as_tensor(image).to(torch.float32)
        if image.ndim == 3:
            image = to_grayscale(image)[:, :, 0]
        return self._extract(image[None])[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return data.map(self.apply)
        X = as_tensor(data.array).to(torch.float32)
        if X.ndim == 4:
            X = to_grayscale(X)[..., 0]
        out = torch.cat([self._extract(X[i:i + SIFT_CHUNK_IMAGES])
                         for i in range(0, X.shape[0], SIFT_CHUNK_IMAGES)])
        return Dataset(out, n=data.n)
