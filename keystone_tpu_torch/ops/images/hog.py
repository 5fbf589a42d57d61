"""Felzenszwalb HOG features (reference: nodes/images/HogExtractor.scala:33-296,
itself a port of voc-release features.cc).

Port of ``keystone_tpu/ops/images/hog.py``. The reference walks pixels in
nested loops; here the histogram binning is one scatter-add over a whole
batch of images and the block normalization is elementwise work over the
cell grid. No kernel of its own: ``torch`` operations (the reference's are
XLA).
"""

from __future__ import annotations

import math

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.utils.images import as_float
from keystone_tpu_torch.workflow import Transformer

_EPSILON = 0.0001

# Unit vectors for the 9 contrast-insensitive orientations
# (HogExtractor.scala:39-59).
_UU = (1.0, 0.9397, 0.7660, 0.5, 0.1736, -0.1736, -0.5, -0.7660, -0.9397)
_VV = (0.0, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420)


def _cells(size: int, bin_size: int) -> int:
    # Java math.round = floor(x + 0.5) (HogExtractor.scala:64-65).
    return int(math.floor(size / bin_size + 0.5))


def _hog(images: torch.Tensor, bin_size: int, nx: int, ny: int) -> torch.Tensor:
    """(B, X, Y, C) float images -> (B, (nx-2)·(ny-2), 32) HOG features."""
    B, X, Y, C = images.shape
    dtype, dev = images.dtype, images.device
    vis_x, vis_y = min(nx * bin_size, X), min(ny * bin_size, Y)
    nxf, nyf = max(nx - 2, 0), max(ny - 2, 0)
    if nxf == 0 or nyf == 0:
        return torch.zeros((B, 0, 32), dtype=dtype, device=dev)

    # Gradients on interior visible pixels (HogExtractor.scala:85-113): the
    # channel of largest magnitude, the first one on ties.
    img = images[:, :vis_x, :vis_y, :]
    dx = img[:, 2:, 1:-1, :] - img[:, :-2, 1:-1, :]
    dy = img[:, 1:-1, 2:, :] - img[:, 1:-1, :-2, :]
    mag_sq = dx * dx + dy * dy
    best_c = torch.argmax(mag_sq, dim=-1, keepdim=True)
    bdx = torch.gather(dx, -1, best_c)[..., 0]
    bdy = torch.gather(dy, -1, best_c)[..., 0]
    magnitude = torch.sqrt(torch.gather(mag_sq, -1, best_c)[..., 0])

    # Snap to one of 18 orientations (HogExtractor.scala:115-129). The
    # reference scans o = 0..8 checking dot then -dot with strict >, so ties
    # go to the earliest of d0, -d0, d1, -d1, …: interleaved, argmax's first
    # maximum keeps that order.
    uu = torch.tensor(_UU, dtype=dtype, device=dev)
    vv = torch.tensor(_VV, dtype=dtype, device=dev)
    dots = uu * bdy[..., None] + vv * bdx[..., None]
    scan = torch.stack([dots, -dots], dim=-1).reshape(dots.shape[:-1] + (18,))
    best_j = torch.argmax(scan, dim=-1)
    best_o = (best_j >> 1) + 9 * (best_j & 1)

    # Bilinear binning into the cell grid (HogExtractor.scala:131-161).
    xp = (torch.arange(1, vis_x - 1, dtype=dtype, device=dev) + 0.5) / bin_size - 0.5
    yp = (torch.arange(1, vis_y - 1, dtype=dtype, device=dev) + 0.5) / bin_size - 0.5
    ixp, iyp = torch.floor(xp), torch.floor(yp)
    vx0, vy0 = (xp - ixp)[:, None], (yp - iyp)[None, :]
    vx1, vy1 = 1.0 - vx0, 1.0 - vy0
    ixp, iyp = ixp.to(torch.int64)[:, None], iyp.to(torch.int64)[None, :]

    hist = torch.zeros((B * nx * ny * 18,), dtype=dtype, device=dev)
    base = torch.arange(B, device=dev)[:, None, None] * (nx * ny * 18)
    for cell_x, cell_y, w in ((ixp, iyp, vx1 * vy1), (ixp, iyp + 1, vx1 * vy0),
                              (ixp + 1, iyp, vx0 * vy1), (ixp + 1, iyp + 1, vx0 * vy0)):
        ok = (cell_x >= 0) & (cell_x < nx) & (cell_y >= 0) & (cell_y < ny)
        cell = torch.where(ok, cell_x * ny + cell_y, 0)
        vals = torch.where(ok, w, 0.0) * magnitude
        hist.index_add_(0, (base + cell * 18 + best_o).reshape(-1), vals.reshape(-1))
    hist = hist.reshape(B, nx, ny, 18)

    # Cell energies over opposite-orientation sums (HogExtractor.scala:168-196).
    folded = hist[..., :9] + hist[..., 9:]
    energy = (folded * folded).sum(dim=-1)  # (B, nx, ny)

    # 2x2 block sums; the four normalizers of each feature cell
    # (HogExtractor.scala:211-232).
    S = energy[:, :-1, :-1] + energy[:, 1:, :-1] + energy[:, :-1, 1:] + energy[:, 1:, 1:]
    norms = [1.0 / torch.sqrt(s + _EPSILON)
             for s in (S[:, 1:, 1:], S[:, :-1, 1:], S[:, 1:, :-1], S[:, :-1, :-1])]
    h = hist[:, 1:-1, 1:-1, :]
    hf = folded[:, 1:-1, 1:-1, :]
    clipped = [torch.clamp_max(h * n[..., None], 0.2) for n in norms]
    sensitive = 0.5 * (clipped[0] + clipped[1] + clipped[2] + clipped[3])  # 18
    insensitive = 0.5 * sum(torch.clamp_max(hf * n[..., None], 0.2) for n in norms)  # 9
    texture = 0.2357 * torch.stack([c.sum(dim=-1) for c in clipped], dim=-1)  # 4
    trunc = torch.zeros(sensitive.shape[:3] + (1,), dtype=dtype, device=dev)
    feats = torch.cat([sensitive, insensitive, texture, trunc], dim=-1)
    return feats.reshape(B, nxf * nyf, 32)


class HogExtractor(Transformer):
    """Image -> (numFeatureCells, 32) HOG feature matrix
    (reference: HogExtractor.scala:33-71)."""

    def __init__(self, bin_size: int):
        self.bin_size = bin_size

    def apply(self, image):
        image = as_float(image)
        nx, ny = _cells(image.shape[0], self.bin_size), _cells(image.shape[1], self.bin_size)
        return _hog(image[None], self.bin_size, nx, ny)[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        if data.is_host:
            return data.map(self.apply)
        X = as_tensor(data.array).to(torch.float32)
        nx, ny = _cells(X.shape[1], self.bin_size), _cells(X.shape[2], self.bin_size)
        return Dataset(_hog(X, self.bin_size, nx, ny), n=data.n)
