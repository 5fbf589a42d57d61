"""Block-partitioned linear models and the block least squares solver.

Port of ``keystone_tpu/ops/learning/block.py`` (reference:
nodes/learning/BlockLinearMapper.scala). The model is a sequence of
per-feature-block weight matrices; applying it sums per-block GEMM partial
products plus an intercept; fitting runs block coordinate descent with L2
through :mod:`keystone_tpu_torch.parallel.linalg`: the stacked solver for
materialized feature blocks (``fit``), and the flat solver when the
optimizer fuses the fit with its featurizer (``device_fit_fn``).
``cost`` and ``resident_bytes`` are the estimator's analytic cost and
capacity models, which the solver selector (``cost.py``) prices it by.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.cost import CostModel
from keystone_tpu_torch.ops.learning.linear import mapper_product
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.ops.util import VectorSplitter
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.workflow import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.fusion import DeviceFit, masked_center


class BlockLinearMapper(Transformer):
    """Apply a block-partitioned linear model: sum per-block GEMMs + intercept
    (reference: BlockLinearMapper.scala:22-138)."""

    def __init__(
        self,
        xs: Sequence,
        block_size: int,
        b_opt=None,
        feature_scalers: Optional[Sequence[StandardScalerModel]] = None,
    ):
        self.xs = [as_tensor(x) for x in xs]
        self.block_size = block_size
        self.b_opt = None if b_opt is None else as_tensor(b_opt, self.xs[0].device)
        self.feature_scalers = feature_scalers
        self.splitter = VectorSplitter(block_size)

    def __getstate__(self):
        # A fit's blocks are views of one stacked solution, and pickle
        # writes a view's whole storage: each block on its own, or a saved
        # (or pickle-cloned) mapper of b blocks holds b copies of every
        # block's weights when loaded.
        state = self.__dict__.copy()
        state["xs"] = [
            x.clone() if x.untyped_storage().nbytes() > x.numel() * x.element_size() else x
            for x in self.xs
        ]
        return state

    def _scaled_block(self, block, i: int):
        if self.feature_scalers is None:
            return block
        return self.feature_scalers[i].apply(block)

    def apply(self, x):
        blocks = self.splitter.split_vector(as_tensor(x, self.xs[0].device))
        out = sum(
            self._scaled_block(blk, i) @ self.xs[i] for i, blk in enumerate(blocks)
        )
        if self.b_opt is not None:
            out = out + self.b_opt
        return out

    def device_fn(self):
        """Stage-fusion contract: the whole blockwise model as one row-local
        tensor function — center by the concatenated means, one flat
        product (:func:`~keystone_tpu_torch.ops.learning.linear.mapper_product`,
        row-stable), add the intercept."""
        W_flat = torch.cat(list(self.xs), dim=0)
        mean = std = None
        if self.feature_scalers is not None:
            if any(getattr(s, "mean", None) is None for s in self.feature_scalers):
                return None  # non-scaler transformers: keep the block path
            mean = torch.cat([s.mean for s in self.feature_scalers])
            stds = [getattr(s, "std", None) for s in self.feature_scalers]
            if any(s is not None for s in stds):
                std = torch.cat([
                    torch.ones_like(s.mean) if sd is None else sd
                    for s, sd in zip(self.feature_scalers, stds)
                ])
        b = self.b_opt

        def fn(X):
            X = as_tensor(X, W_flat.device)
            if mean is not None:
                X = X - mean
            if std is not None:
                X = X / std
            out = mapper_product(X, W_flat)
            return out if b is None else out + b

        return fn

    def batch_apply(self, data: Dataset) -> Dataset:
        """A tensor dataset runs :meth:`device_fn` (its flat row-stable
        product) in row chunks, so an offline apply gives each row the bits
        an exported plan's buckets serve (ROADMAP C.8); other forms, or a
        model :meth:`device_fn` cannot express, take the blockwise path."""
        fn = self.device_fn()
        if fn is not None and (isinstance(data.data, torch.Tensor) or data.is_sharded):
            from keystone_tpu_torch.workflow.fusion import _compose_in_chunks

            # A sharded dataset runs it on each shard (map_batch).
            return data.map_batch(lambda X: _compose_in_chunks([fn], X))
        return self.apply_blocks(self.splitter.apply(data))

    def apply_blocks(self, blocks: List[Dataset]) -> Dataset:
        """Apply to pre-split feature blocks (BlockLinearMapper.scala:50-73)."""
        out = None
        for i, block in enumerate(blocks):
            partial = self._scaled_block(as_tensor(block.array), i) @ self.xs[i]
            out = partial if out is None else out + partial
        if self.b_opt is not None:
            out = out + self.b_opt
        return Dataset(out, n=blocks[0].n)._rezero_padding()


def _stack_fits_memory(A_blocks, num_iter: int) -> bool:
    """True when the stacked fit's transient peak fits comfortably in device
    memory. At stack time up to THREE full-size copies of the feature blocks
    are live (the unscaled splits, the scaled list, and the stack), plus the
    multi-epoch Gramian stash (nb * d_b^2). CPU tensors have no budget."""
    if not A_blocks or not A_blocks[0].is_cuda:
        return True
    total = sum(a.numel() * a.element_size() for a in A_blocks)
    stash = 0
    if num_iter > 1:
        d_b = int(A_blocks[0].shape[1])
        stash = len(A_blocks) * d_b * d_b * max(A_blocks[0].element_size(), 4)
    _, limit = torch.cuda.mem_get_info(A_blocks[0].device)
    return 3 * total + stash < 0.6 * limit


class BlockLeastSquaresEstimator(LabelEstimator, CostModel):
    """Block coordinate descent ridge regression
    (reference: BlockLinearMapper.scala:199-283).

    Label and per-block feature mean-centering via StandardScaler
    (normalize_std_dev=False), then Gauss-Seidel BCD over feature blocks;
    weight = 3*num_iter + 1 passes over the input.
    """

    def __init__(
        self,
        block_size: int,
        num_iter: int,
        lam: float = 0.0,
        num_features: Optional[int] = None,
    ):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.num_features = num_features

    @property
    def weight(self) -> int:
        return 3 * self.num_iter + 1

    def device_fit_fn(self):
        """Fit-fusion contract (workflow/fusion.py): feature/label
        mean-centering + the flat BCD sweep on the featurized matrix, so the
        optimizer can featurize straight into the fit. The featurized F is
        the fused fit's own: it is centred in place and its column windows
        are read where they lie, so the features are held once."""
        bs = self.block_size

        def fit_fn(F, Y, n_true: int):
            Fc, Yc, fmean, ymean = masked_center(F, Y, n_true)
            W_stack = linalg.bcd_least_squares_fused_flat(
                Fc, Yc, bs, lam=self.lam, num_iter=self.num_iter
            )
            return W_stack, fmean, ymean

        def build(params):
            W_stack, fmean, ymean = params
            scalers = [
                StandardScalerModel(fmean[i * bs:(i + 1) * bs])
                for i in range(W_stack.shape[0])
            ]
            return BlockLinearMapper(
                list(W_stack), bs, b_opt=ymean, feature_scalers=scalers
            )

        def supports(d_feat: int) -> bool:
            return d_feat % bs == 0 and self.num_features in (None, d_feat)

        return DeviceFit(fit_fn, build, supports)

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        splitter = VectorSplitter(self.block_size, self.num_features)
        return self.fit_blocks(splitter.apply(data), labels)

    def fit_blocks(self, blocks: List[Dataset], labels: Dataset) -> BlockLinearMapper:
        """Center, then solve: the stacked sweep for equal blocks on one
        device, else the stepwise one; rows sharded over a multi-device
        mesh take the stepwise sweep's mesh form (reference
        ``block.py:241-268``: the fused flat and stacked sweeps are
        one-device programs), the centred blocks and labels staying
        sharded."""
        multi_device = any(mesh_lib.is_multi_device(d.mesh) for d in [labels, *blocks])

        def centred(ds, scaler):
            out = scaler.batch_apply(ds).array
            return out if multi_device and ds.is_sharded else as_tensor(out)

        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels)
        B = centred(labels, label_scaler)

        feature_scalers = [
            StandardScaler(normalize_std_dev=False).fit(block) for block in blocks
        ]
        A_blocks = [centred(block, scaler) for block, scaler in zip(blocks, feature_scalers)]
        if multi_device:
            mesh = next(d.mesh for d in [labels, *blocks] if mesh_lib.is_multi_device(d.mesh))
            Ws = linalg.bcd_least_squares(
                A_blocks, B, lam=self.lam, num_iter=self.num_iter, mesh=mesh
            )
        elif len({a.shape for a in A_blocks}) == 1 and _stack_fits_memory(
            A_blocks, self.num_iter
        ):
            # Equal-size blocks (the common case): the stacked sweep with
            # the Gramian + Cholesky stash. Fits whose stacked copy would
            # not fit beside the blocks keep the stepwise path.
            stacked = torch.stack(A_blocks)
            del A_blocks  # the stack is a full second copy; drop the list
            W_stack = linalg.bcd_least_squares_fused(
                stacked, B, lam=self.lam, num_iter=self.num_iter
            )
            Ws = list(W_stack)
        else:
            Ws = linalg.bcd_least_squares(
                A_blocks, B, lam=self.lam, num_iter=self.num_iter
            )
        return BlockLinearMapper(
            Ws, self.block_size, b_opt=label_scaler.mean, feature_scalers=feature_scalers
        )

    def cost(
        self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight, network_weight
    ) -> float:
        """Analytic cost model (BlockLinearMapper.scala:268-282)."""
        flops = n * d * (self.block_size + k) / num_machines
        bytes_scanned = n * d / num_machines + d * k
        network = 2.0 * (d * (self.block_size + k)) * math.log2(max(num_machines, 2))
        return self.num_iter * (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model for the selector's device-memory cut: the fit
        holds the feature blocks plus a scaled/stacked second copy (f32),
        labels twice (raw + centered), and the multi-epoch Gramian stash."""
        return (
            8.0 * n * d / num_machines
            + 8.0 * n * k / num_machines
            + 4.0 * d * self.block_size
        )
