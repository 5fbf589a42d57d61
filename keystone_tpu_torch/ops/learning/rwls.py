"""Per-class weighted least squares and the re-weighted BCD core.

Reference: nodes/learning/PerClassWeightedLeastSquares.scala:31-223 (one
weighted least-squares problem a class, assembled into a
BlockLinearMapper) and nodes/learning/internal/ReWeightedLeastSquares.scala:18-142
(the weighted block-coordinate-descent core solving
``W = (Xzmᵀ diag(w) Xzm + λI) \\ Xzmᵀ (w ∘ Y_zm)`` with feature-mean-centred
X and a maintained weighted residual). Port of
``keystone_tpu/ops/learning/rwls.py``.

Every class is solved at once a feature block, each class's weighted
Gramian decomposed around shared population terms. With per-class weights
``w_c = α + β_c·1[class=c]`` (α = (1−mw)/n, β_c = mw/n_c) and the
class-mixed feature mean μ_c:

    Xzm_cᵀ diag(w_c) Xzm_c
        = α·XᵀX + β_c·X_cᵀX_c − μ_c t̃_cᵀ − t̃_c μ_cᵀ + c0_c·μ_c μ_cᵀ

where ``X_cᵀX_c`` is the class segment's Gramian of the class-sorted rows,
``t̃_c = α·s + β_c·s_c`` (block column sums) and ``c0_c = α·n + β_c·n_c``
(1 for a present class). The population Gramian ``XᵀX`` is one product
shared by all classes, a float32 (or float64) ``torch.matmul`` as the
reference's is XLA's, not a kernel; the class Gramians one batched product
a chunk of 16 classes, their systems one batched solve.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.classstats import column_blocks, mixed_class_means
from keystone_tpu_torch.workflow import LabelEstimator

# Classes a chunk of batched per-class solves (the reference's chunk).
CLASS_CHUNK = 16


# ---------------------------------------------------------------------------
# ReWeightedLeastSquaresSolver — the general weighted BCD core
# ---------------------------------------------------------------------------


def _exact(x, device=None) -> torch.Tensor:
    """``x`` as a tensor in its own precision (``as_tensor`` would round a
    float64 host array to float32: the solver's inputs keep theirs)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x if device is None else x.to(device)


def _rwls_gram(Xb, mu_b, w):
    """Xzmᵀ diag(w) Xzm for one block (kept across passes, the aTaCache of
    ReWeightedLeastSquares.scala:92-101)."""
    Xzm = Xb - mu_b[None, :]
    return (Xzm * w[:, None]).T @ Xzm


def _rwls_step(Xb, mu_b, w, D, W_old, gram, lam: float):
    """One weighted Gauss-Seidel block update
    (ReWeightedLeastSquares.scala:103-135). ``D = w∘Y_zm − Σ_b
    w∘(Xzm_b W_b)`` is the weighted residual. Returns (W_new, D_new)."""
    Xzm = Xb - mu_b[None, :]
    rhs = Xzm.T @ (D + w[:, None] * (Xzm @ W_old))
    b = gram.shape[0]
    W_new = torch.linalg.solve(gram + lam * torch.eye(b, dtype=gram.dtype, device=gram.device),
                               rhs)
    return W_new, D - w[:, None] * (Xzm @ (W_new - W_old))


class ReWeightedLeastSquaresSolver:
    """Weighted BCD: ``W = (Xᵀ diag(B) X + λI) \\ Xᵀ (B ∘ Y)`` over feature
    blocks with feature-mean centring (reference:
    internal/ReWeightedLeastSquares.scala:18-142)."""

    @staticmethod
    def train_with_l2(
        feature_blocks: Sequence,
        labels_zm,
        weights,
        feature_mean,
        lam: float,
        num_iter: int,
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Returns (per-block models, final weighted residual
        ``Σ_b B∘(Xzm_b W_b)``), the reference's (model, residual) pair, on
        the labels' device."""
        labels_zm = _exact(labels_zm)
        dtype = torch.promote_types(labels_zm.dtype, torch.float32)
        dev = labels_zm.device
        labels_zm = labels_zm.to(dtype)
        w, mu = (_exact(a, dev).to(dtype) for a in (weights, feature_mean))
        blocks = [_exact(b, dev).to(dtype) for b in feature_blocks]
        k = labels_zm.shape[1]
        offsets = np.concatenate([[0], np.cumsum([b.shape[1] for b in blocks])])
        mus = [mu[offsets[i]:offsets[i + 1]] for i in range(len(blocks))]
        grams: List = [None] * len(blocks)
        models = [torch.zeros((b.shape[1], k), dtype=dtype, device=dev) for b in blocks]
        D = w[:, None] * labels_zm
        for _ in range(max(int(num_iter), 1)):
            for bi, Xb in enumerate(blocks):
                if grams[bi] is None:
                    grams[bi] = _rwls_gram(Xb, mus[bi], w)
                models[bi], D = _rwls_step(Xb, mus[bi], w, D, models[bi], grams[bi], float(lam))
        return models, w[:, None] * labels_zm - D


# ---------------------------------------------------------------------------
# PerClassWeightedLeastSquaresEstimator — all classes batched a block
# ---------------------------------------------------------------------------


def _class_terms(X_pad, W, jfm_blk, onehot, valid, alpha, beta):
    """w_c∘(Xzm_c W_c) for every class c at once, through the α/β weight
    split: ``(X W − 1 (μ_cᵀ W_c)) ∘ (α + β_c 1[class=c])`` on the true rows."""
    U = X_pad @ W  # (n+M, k)
    o = (jfm_blk * W.T).sum(dim=1)  # μ_cᵀ W_c
    Um = (U - o[None, :]) * valid[:, None]
    return alpha * Um + onehot * Um * beta[None, :]


def _chunk_solve(A, starts, counts, G, s, seg_s, jfm, P_sel, t_sel, beta, c0, alpha, M: int,
                 lam: float):
    """Batched per-class solves for one chunk of classes: each class's
    weighted Gramian from the shared population terms and its segment
    Gramian, then one batched (C, b, b) solve. Returns (C, b)."""
    dev, dtype = A.device, A.dtype
    rows = starts[:, None] + torch.arange(M, device=dev)[None, :]  # (C, M)
    mask = (torch.arange(M, device=dev)[None, :] < counts[:, None]).to(dtype)
    A_c = A[rows] * mask[:, :, None]  # (C, M, b)
    G_c = A_c.transpose(1, 2) @ A_c
    del A_c
    t_tilde = alpha * s[None, :] + beta[:, None] * seg_s  # (C, b)
    lhs = (alpha * G[None] + beta[:, None, None] * G_c
           - jfm[:, :, None] * t_tilde[:, None, :]
           - t_tilde[:, :, None] * jfm[:, None, :]
           + c0[:, None, None] * (jfm[:, :, None] * jfm[:, None, :]))
    del G_c
    b = G.shape[0]
    eye = torch.eye(b, dtype=dtype, device=dev)
    lhs = lhs + lam * eye[None]
    # Zero-count padding lanes solve the identity system (a defined zero).
    is_pad = counts < 0.5
    lhs = torch.where(is_pad[:, None, None], eye[None], lhs)
    rhs = torch.where(is_pad[:, None], torch.zeros((), dtype=dtype, device=dev),
                      P_sel - t_sel[:, None] * jfm)
    return torch.linalg.solve(lhs, rhs[:, :, None])[..., 0]


class PerClassWeightedLeastSquaresEstimator(LabelEstimator):
    """Per-class weighted BCD least squares
    (reference: PerClassWeightedLeastSquares.scala:31-223).

    Each class c solves its own weighted ridge problem with weights
    ``(1−mw)/n`` on every row plus ``mw/n_c`` on its own rows, features
    centred by ``μ_c = mw·classMean_c + (1−mw)·popMean`` and labels by the
    jointLabelMean, all classes batched a block (see the module docstring).
    Classes absent from the data get β_c = 0 (pure population weighting).
    The fit runs on the rows' device."""

    def __init__(self, block_size: int, num_iter: int, lam: float, mixture_weight: float,
                 num_features=None):
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
        dtype = torch.promote_types(X.dtype, torch.float32)
        X = X.to(dtype)
        dev = X.device
        Y = as_tensor(labels.array, dev)[:n].to(dtype)
        k = Y.shape[1]
        mw = float(self.mixture_weight)

        # Class-sort the rows on the device (the HashPartitioner reshuffle).
        class_of_row = torch.argmax(Y, dim=1)
        order = torch.argsort(class_of_row, stable=True)
        X, class_of_row = X[order], class_of_row[order]
        counts = torch.bincount(class_of_row, minlength=k).cpu().numpy().astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        present = np.nonzero(counts > 0)[0]
        if len(present) == 0:
            raise ValueError("PCWLS fit requires at least one labeled row")
        M = int(counts.max())

        alpha = (1.0 - mw) / n
        beta = np.where(counts > 0, mw / np.maximum(counts, 1), 0.0)
        c0 = alpha * n + beta * counts  # 1 for present classes
        jlm = (counts / n) * 2.0 * (1.0 - mw) - 1.0 + 2.0 * mw  # jointLabelMean

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        beta_d, jlm_d = t(beta), t(jlm)
        onehot = torch.nn.functional.pad(
            torch.nn.functional.one_hot(class_of_row, k).to(dtype), (0, 0, 0, M))
        valid = torch.nn.functional.pad(torch.ones((n,), dtype=dtype, device=dev), (0, M))
        pop_mean = X.sum(dim=0) / n
        jfm = mixed_class_means(X, class_of_row, t(counts), pop_mean, k, mw, absent_to_pop=True)

        d_eff = self.num_features or X.shape[1]
        bs = self.block_size
        col_starts = list(range(0, d_eff, bs))
        Y_zm = torch.nn.functional.pad(Y[order] - jlm_d[None, :], (0, 0, 0, M))
        D = (alpha * Y_zm + onehot * Y_zm * beta_d[None, :]) * valid[:, None]
        blocks = column_blocks(X, bs, d_eff, M)
        del X
        jfm_blocks = [jfm[:, s:min(s + bs, d_eff)] for s in col_starts]
        models = [torch.zeros((b.shape[1], k), dtype=dtype, device=dev) for b in blocks]
        stats: List = [None] * len(blocks)  # (XᵀX, column sums, class column sums)
        chunk = int(min(CLASS_CHUNK, len(present)))
        present_d = torch.from_numpy(present).to(dev)
        for _ in range(max(int(self.num_iter), 1)):
            for bi, A in enumerate(blocks):
                if stats[bi] is None:
                    A_real = A[:n]
                    seg = torch.zeros((k, A.shape[1]), dtype=dtype, device=dev)
                    seg.index_add_(0, class_of_row, A_real)
                    stats[bi] = (A_real.T @ A_real, A_real.sum(dim=0), seg)
                G, s, seg_s = stats[bi]
                # T = D + w_c∘(Xzm_c W_old_c); P = XᵀT, t = 1ᵀT.
                T = D + _class_terms(A, models[bi], jfm_blocks[bi], onehot, valid, alpha, beta_d)
                P, tt = A.T @ T, T.sum(dim=0)
                del T
                W_new = models[bi].clone()
                for lo in range(0, len(present), chunk):
                    sel = present[lo:lo + chunk]
                    sel_p = np.concatenate([sel, np.repeat(sel[-1:], chunk - len(sel))])
                    counts_sel = np.where(np.arange(chunk) < len(sel), counts[sel_p], 0)
                    idx = torch.from_numpy(sel_p).to(dev)
                    sol = _chunk_solve(A, torch.from_numpy(starts[sel_p]).to(dev),
                                       t(counts_sel), G, s, seg_s[idx], jfm_blocks[bi][idx],
                                       P[:, idx].T, tt[idx], beta_d[idx], t(c0[sel_p]), alpha,
                                       M, float(self.lam))
                    W_new[:, present_d[lo:lo + len(sel)]] = sol[:len(sel)].T
                dW = W_new - models[bi]
                models[bi] = W_new
                D = D - _class_terms(A, dW, jfm_blocks[bi], onehot, valid, alpha, beta_d)

        # finalB = jointLabelMean − Σ_d jfm[c, d]·W[d, c]
        # (PerClassWeightedLeastSquares.scala:118-121).
        full_model = torch.cat(models)
        final_b = jlm_d - (torch.cat(jfm_blocks, dim=1) * full_model.T).sum(dim=1)
        return BlockLinearMapper(models, self.block_size, b_opt=final_b)
