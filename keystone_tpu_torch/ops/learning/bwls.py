"""Class-weighted block least squares (the ImageNet solver).

Reference: nodes/learning/BlockWeightedLeastSquares.scala:36-372. Port of
``keystone_tpu/ops/learning/bwls.py``. The solver interpolates per-class
and population second-moment statistics with ``mixture_weight`` and solves
one ridge system per (block, class) pair.

Rows are sorted by class once on the device (replacing Spark's
HashPartitioner(nClasses) reshuffle, BlockWeightedLeastSquares.scala:333-371);
each class is then a row window of the sorted rows, padded to the largest
class. Classes are solved in chunks of 32: the chunk's class covariances
are one batched product and its systems one batched LU solve (the
reference vmaps the same chunk; its solve is XLA's, no Pallas kernel, and
so is this one: on the card PyTorch's batched LU, which at b = 4,096
measured 10.4 s for ImageNet's 1,000 classes against 13.8 s for one
cuSOLVER LU a class).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.classstats import column_blocks, mixed_class_means
from keystone_tpu_torch.workflow import LabelEstimator

logger = logging.getLogger("keystone_tpu_torch.bwls")

# Classes a chunk of per-class solves (the reference's chunk).
CLASS_CHUNK = 32


def _class_chunk_solve(A, R, starts, counts, cols, pop_cov, pop_mean, pop_xtr,
                       residual_mean, joint_means, model_old, M: int, lam: float, mw: float):
    """One chunk of per-class column solves (BlockWeightedLeastSquares.scala:241-276).

    A: (n + M, b) class-sorted block rows, zero-padded; R: (n + M, k)
    residual; starts / counts / cols: (C,) each class's first row, rows
    (0 for chunk padding) and column. Returns (C, b)."""
    dev, dtype = A.device, A.dtype
    rows = starts[:, None] + torch.arange(M, device=dev)[None, :]  # (C, M)
    mask = (torch.arange(M, device=dev)[None, :] < counts[:, None]).to(dtype)
    A_c = A[rows] * mask[:, :, None]  # (C, M, b)
    r_c = R[rows, cols[:, None]] * mask  # (C, M)
    n_c = counts.to(dtype)
    is_pad = n_c < 0.5  # padded chunk entries have n_c == 0
    n_c = torch.clamp_min(n_c, 1.0)

    class_mean = A_c.sum(dim=1) / n_c[:, None]  # (C, b)
    centered = (A_c - class_mean[:, None, :]) * mask[:, :, None]
    class_xtr = (A_c.transpose(1, 2) @ r_c[:, :, None])[..., 0] / n_c[:, None]
    del A_c
    # joint_xtx = pop_cov (1-mw) + class_cov mw + mean_diff mean_diffᵀ (1-mw) mw
    lhs = centered.transpose(1, 2) @ centered
    del centered
    lhs *= (mw / n_c)[:, None, None]
    lhs += pop_cov * (1.0 - mw)
    mean_diff = class_mean - pop_mean
    lhs += (mean_diff[:, :, None] * mean_diff[:, None, :]) * ((1.0 - mw) * mw)
    lhs.diagonal(dim1=1, dim2=2).add_(lam)

    mean_mixture_wt = residual_mean[cols] * (1.0 - mw) + mw * (r_c.sum(dim=1) / n_c)
    joint_xtr = (pop_xtr[:, cols].T * (1.0 - mw) + class_xtr * mw
                 - joint_means[cols] * mean_mixture_wt[:, None])
    rhs = joint_xtr - model_old[:, cols].T * lam
    # Padded lanes solve the identity system (zero output).
    if bool(is_pad.any()):
        eye = torch.eye(lhs.shape[1], dtype=dtype, device=dev)
        lhs = torch.where(is_pad[:, None, None], eye, lhs)
        rhs = torch.where(is_pad[:, None], torch.zeros((), dtype=dtype, device=dev), rhs)
    return torch.linalg.solve(lhs, rhs[:, :, None])[..., 0]


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Weighted BCD least squares with per-class covariance mixing."""

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features

    @property
    def weight(self) -> int:
        return 3 * self.num_iter + 1

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        n = labels.n
        X = as_tensor(data.array)[:n]
        # Solve dtype: at least float32 (float64 inputs stay float64).
        dtype = torch.promote_types(X.dtype, torch.float32)
        X = X.to(dtype)
        Y = as_tensor(labels.array, X.device)[:n].to(dtype)
        k = Y.shape[1]
        dev = X.device
        mw = float(self.mixture_weight)

        class_of_row = torch.argmax(Y, dim=1)
        order = torch.argsort(class_of_row, stable=True)
        X, Y, class_of_row = X[order], Y[order], class_of_row[order]
        class_counts = torch.bincount(class_of_row, minlength=k).cpu().numpy().astype(np.int64)
        class_starts = np.concatenate([[0], np.cumsum(class_counts)[:-1]])
        present = np.nonzero(class_counts > 0)[0]
        if len(present) == 0:
            raise ValueError("BWLS fit requires at least one labeled row")
        M = int(class_counts.max())  # rows of the largest class

        # jointLabelMean (intercept base): 2mw + 2(1-mw)·n_c/n − 1.
        joint_label_mean = torch.from_numpy(
            2 * mw + 2 * (1 - mw) * class_counts / n - 1.0).to(dtype=dtype, device=dev)

        d_eff = self.num_features or X.shape[1]
        blocks = column_blocks(X, self.block_size, d_eff, M)
        del X
        R = torch.nn.functional.pad(Y - joint_label_mean, (0, 0, 0, M))
        counts_d = torch.from_numpy(class_counts).to(dtype=dtype, device=dev)
        models = [torch.zeros((b.shape[1], k), dtype=dtype, device=dev) for b in blocks]
        residual_mean = R.sum(dim=0) / n
        block_stats = [None] * len(blocks)
        present_d = torch.from_numpy(present).to(dev)
        chunk = min(CLASS_CHUNK, len(present))

        for it in range(self.num_iter):
            for bi, A in enumerate(blocks):
                pop_xtr = A.T @ R / n
                if block_stats[bi] is None:
                    pop_mean = A.sum(dim=0) / n
                    pop_cov = A.T @ A / n - torch.outer(pop_mean, pop_mean)
                    joint_means = mixed_class_means(A[:n], class_of_row, counts_d, pop_mean, k, mw)
                    block_stats[bi] = (pop_cov, pop_mean, joint_means)
                pop_cov, pop_mean, joint_means = block_stats[bi]
                model_old = models[bi]
                new_cols = []
                for lo in range(0, len(present), chunk):
                    sel = present[lo:lo + chunk]
                    pad_len = chunk - len(sel)
                    sel_p = np.concatenate([sel, np.repeat(sel[-1:], pad_len)])
                    counts_p = np.where(np.arange(chunk) < len(sel), class_counts[sel_p], 0)
                    sol = _class_chunk_solve(
                        A, R,
                        torch.from_numpy(class_starts[sel_p]).to(dev),
                        torch.from_numpy(counts_p).to(dev),
                        torch.from_numpy(sel_p).to(dev),
                        pop_cov, pop_mean, pop_xtr, residual_mean, joint_means, model_old,
                        M, float(self.lam), mw,
                    )
                    new_cols.append(sol[:len(sel)])
                delta = torch.zeros((A.shape[1], k), dtype=dtype, device=dev)
                delta[:, present_d] = torch.cat(new_cols).T
                models[bi] = model_old + delta
                R = torch.addmm(R, A, delta, alpha=-1.0)
                residual_mean = R.sum(dim=0) / n
                logger.info("BWLS pass %d block %d done", it, bi)

        # Intercept: jointLabelMean − Σ_d jointMeans[c, d]·W[d, c]
        # (BlockWeightedLeastSquares.scala:315-320).
        full_model = torch.cat(models)
        joint_means_all = torch.cat([stats[2] for stats in block_stats], dim=1)  # (k, D)
        final_b = joint_label_mean - (joint_means_all * full_model.T).sum(dim=1)
        return BlockLinearMapper(models, self.block_size, b_opt=final_b)
