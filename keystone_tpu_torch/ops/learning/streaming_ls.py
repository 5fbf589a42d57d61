"""Estimator API over the out-of-core streaming least-squares tier.

Port of ``keystone_tpu/ops/learning/streaming_ls.py``.
``StreamingFeaturizedLeastSquares`` is the pipeline-facing form of
:mod:`keystone_tpu_torch.parallel.streaming`: the featurizer lives inside
the estimator, so the fit makes features one row tile at a time and folds
them into the (d, d) normal equations; the feature matrix never
materializes. The fitted model applies the same featurizer tile-wise.
``StreamingLeastSquaresChoice`` is the same tier as the cost model's
choice, and ``StreamedFitEstimator`` the form the optimizer's
``StreamedFitFusionRule`` gives it when it binds the upstream featurizer
into the fit.

Default semantics match ``BlockLeastSquaresEstimator``
(BlockLinearMapper.scala:224-243): features and labels are mean-centered
(the column sums accumulate in the same tile pass as the Gramian, a rank-1
correction, not a second data pass) and the model carries the intercept.
``center=False`` gives the raw-BCD semantics instead.

``StreamingLeastSquaresChoice`` carries the reference's cost side: the
analytic ``cost``, the capacity model ``resident_bytes`` and the budget
fields that the ``cost.py`` selector sets before pricing it, which also
decide its tier (``_gram_tier_ok``): the gram tier whenever the (d, d)
Gramian and one feature slab fit the device budget, else, for a cosine
bank, the block-streamed tier (``BlockStreamedLeastSquares`` on
``streaming.streaming_block_bcd_mesh``), whose working set
holds one (n, block) slab and the per-block Gramian stash, no d² term.

A shard-backed input takes the disk tier: ``StreamingLeastSquaresChoice.
fit_source`` (and ``StreamedFitEstimator`` on shard-backed data) folds
prefetched disk segments through
``streaming.streaming_bcd_fit_segments``, and ``resident_bytes`` prices it
with no term in n. ``BlockStreamedLeastSquares`` materializes a
shard-backed input, as the reference's does: its residual sweep
re-featurizes the raw rows every block step.

The tier decision is audited as a ``cost.decision`` event
(``decision="streaming_tier"``), as in the reference. Rows sharded over a
multi-device mesh (``Dataset.shard``) take the mesh forms:
``StreamingFeaturizedLeastSquares`` the mesh fold
(``streaming_bcd_fit_mesh[_centered]``), ``BlockStreamedLeastSquares`` the
block-streamed program over the mesh.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning.cost import CostModel
from keystone_tpu_torch.ops.sparse import Densify, is_sparse_dataset
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel import streaming
from keystone_tpu_torch.workflow import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.fusion import DeviceFit

logger = logging.getLogger("keystone_tpu_torch.streaming")


class StreamingFeaturizedLinearModel(Transformer):
    """Apply featurize + block weights tile-wise (features never resident).

    A centered fit supplies (fmean, ymean); predictions are then
    (F − fmean) @ W + ymean, which folds into the single affine offset
    ymean − fmean @ W_flat: BlockLinearMapper's model shape without a
    second pass over the features.

    ``d_in`` (when known) makes the model tolerant of graph position: fed
    raw rows (width d_in) it featurizes tile-wise; fed already-featurized
    rows (width d_feat) it applies the weights directly. The optimizer's
    streamed-fit rewrite needs this, because the same fitted transformer
    serves both rewired (raw-input) and original (featurized-input) apply
    sites.
    """

    def __init__(self, featurize, W_stack, tile_rows: int, fmean=None, ymean=None,
                 d_in: Optional[int] = None):
        self.featurize = featurize
        self.W_stack = as_tensor(W_stack)
        self.tile_rows = tile_rows
        self.d_in = d_in
        dev = self.W_stack.device
        self.fmean = None if fmean is None else as_tensor(fmean, dev)
        self.ymean = None if ymean is None else as_tensor(ymean, dev)
        Wf = self.W_stack.reshape(-1, self.W_stack.shape[2])
        self.offset = (
            None if self.ymean is None
            else self.ymean - self.fmean.to(torch.float32) @ Wf
        )

    @property
    def d_feat(self) -> int:
        return self.W_stack.shape[0] * self.W_stack.shape[1]

    def _featurize_for(self, width: int):
        if self.d_in is None or width == self.d_in:
            return self.featurize
        if width == self.d_feat:
            return _identity_featurize
        raise ValueError(
            f"input width {width} matches neither raw d_in={self.d_in} "
            f"nor d_feat={self.d_feat}"
        )

    def apply(self, x):
        x = as_tensor(x, self.W_stack.device)
        F = self._featurize_for(x.shape[-1])(x[None, :])
        Wf = self.W_stack.reshape(-1, self.W_stack.shape[2])
        out = (F.to(torch.float32) @ Wf)[0]
        return out if self.offset is None else out + self.offset

    def batch_apply(self, data: Dataset) -> Dataset:
        X = as_tensor(data.array, self.W_stack.device)
        preds = streaming.streaming_predict(
            X, self.W_stack, self._featurize_for(X.shape[-1]), self.tile_rows
        )
        if self.offset is not None:
            preds += self.offset
        return Dataset(preds, n=data.n)._rezero_padding()


class StreamingFeaturizedLeastSquares(LabelEstimator):
    """Featurize-inside-the-fit block least squares (the streaming tier).

    ``featurize``: ``(rows, d_in) -> (rows, d_feat)`` tensor function (e.g.
    a cosine random-feature bank). The fit folds the tiles into the normal
    equations (``gram_sym_acc``) and runs the BCD epochs on them;
    ``tile_rows=None`` sizes tiles to a 2 GiB feature slab at the
    featurizer's element size: a :class:`CosineBankFeaturize`'s
    ``feat_dtype`` (2 bytes for a bf16 bank), else float32.
    """

    def __init__(
        self,
        featurize: Callable,
        d_feat: int,
        block_size: int,
        num_iter: int = 1,
        lam: float = 0.0,
        tile_rows: Optional[int] = None,
        center: bool = True,
    ):
        self.featurize = featurize
        self.d_feat = d_feat
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        bank = isinstance(featurize, CosineBankFeaturize)
        itemsize = featurize.feat_dtype.itemsize if bank else 4
        self.tile_rows = tile_rows or streaming.pick_tile_rows(d_feat, itemsize)
        self.center = center

    @property
    def weight(self) -> int:
        return self.num_iter + 1

    def device_fit_fn(self):
        """Fit-fusion contract (workflow/fusion.py): F here is the
        estimator's input, the upstream transformers' output (typically
        narrow raw-ish rows); the internal features still exist one tile
        slab at a time. The reference's operands and program key (a
        compiled program shared across banks and λ) have no eager
        counterpart."""

        def fit_fn(F, Y, n_true: int):
            tile = min(self.tile_rows, F.shape[0])
            W, _, _, fmean, ymean = streaming._fit_core(
                F, Y, self.featurize, self.d_feat, tile, self.block_size, self.lam,
                self.num_iter, n_true if n_true != F.shape[0] else None, None, self.center,
            )
            return W, fmean, ymean

        def build(params):
            W, fmean, ymean = params
            return StreamingFeaturizedLinearModel(
                self.featurize, W, self.tile_rows, fmean=fmean, ymean=ymean,
            )

        return DeviceFit(fit_fn, build)

    def fit(self, data: Dataset, labels: Dataset) -> StreamingFeaturizedLinearModel:
        if mesh_lib.is_multi_device(data.mesh):
            # Each shard folds its own tiles; one psum of the stats a fit.
            X = data.array
            Y = labels.array if labels.is_sharded else labels.shard(data.mesh).array
            rows = X.shape[0] // mesh_lib.axis_size(data.mesh, mesh_lib.DATA_AXIS)
            kw = dict(featurize=self.featurize, d_feat=self.d_feat,
                      tile_rows=min(self.tile_rows, max(rows, 1)),
                      block_size=self.block_size, lam=self.lam, num_iter=self.num_iter,
                      mesh=data.mesh, n_true=data.n)
            fmean = ymean = None
            if self.center:
                W, fmean, ymean = streaming.streaming_bcd_fit_mesh_centered(X, Y, **kw)
            else:
                W = streaming.streaming_bcd_fit_mesh(X, Y, **kw)
            return StreamingFeaturizedLinearModel(
                self.featurize, W, self.tile_rows, fmean=fmean, ymean=ymean,
            )
        X = as_tensor(data.array)
        Y = as_tensor(labels.array, X.device)
        kw = dict(
            featurize=self.featurize, d_feat=self.d_feat,
            tile_rows=min(self.tile_rows, X.shape[0]),
            block_size=self.block_size, lam=self.lam, num_iter=self.num_iter,
            valid=int(data.n) if data.n != X.shape[0] else None,
        )
        fmean = ymean = None
        if self.center:
            W, fmean, ymean, _ = streaming.streaming_bcd_fit_centered(X, Y, **kw)
        else:
            W, _, _ = streaming.streaming_bcd_fit(X, Y, **kw)
        return StreamingFeaturizedLinearModel(
            self.featurize, W, self.tile_rows, fmean=fmean, ymean=ymean,
        )


class CosineBankFeaturize:
    """Cosine random-feature bank as a featurize callable: ``cos(X Wrfᵀ +
    brf)`` through the ``cosine_features`` CUDA kernel (its plain version on
    the CPU), one launch per row tile. ``feat_dtype=torch.bfloat16`` rounds
    the operands to bf16 (products still accumulate in float32) and writes
    bf16 features, the reference's Pallas form; its XLA form, the
    reference's CPU default, computes in float32 and rounds only the
    output. bf16 tiles are written at a row stride rounded up to 8
    elements (16 bytes), so the streamed fold's ``gram_sym_acc`` reads them
    in place on the tensor cores (``cuda_ops._tma_layout_ok``) whatever the
    bank's width."""

    def __init__(self, Wrf_flat, brf_flat, feat_dtype: torch.dtype = torch.float32):
        self.Wrf = as_tensor(Wrf_flat)
        self.brf = as_tensor(brf_flat, self.Wrf.device)
        self.feat_dtype = feat_dtype

    def __call__(self, X_t):
        X_t = as_tensor(X_t, self.Wrf.device).contiguous()
        out = None
        d = self.Wrf.shape[0]
        if self.feat_dtype == torch.bfloat16 and d % 8:
            out = torch.empty((X_t.shape[0], -(-d // 8) * 8), dtype=torch.bfloat16,
                              device=X_t.device)[:, :d]
        return cuda_ops.cosine_features(
            X_t, self.Wrf, self.brf, compute_dtype=self.feat_dtype, out_dtype=self.feat_dtype,
            out=out,
        )


def cosine_bank_featurize(Wrf_flat, brf_flat,
                          feat_dtype: torch.dtype = torch.float32) -> CosineBankFeaturize:
    """Build a :class:`CosineBankFeaturize` (the public factory)."""
    return CosineBankFeaturize(Wrf_flat, brf_flat, feat_dtype)


def _identity_featurize(X_t):
    """Module-level identity featurize: the already-featurized (resident)
    path of the streaming choice, picklable by reference."""
    return X_t


def pick_block_size(d_feat: int, hint: int) -> int:
    """Largest divisor of d_feat that is <= hint (BCD needs d % bs == 0)."""
    for b in range(min(hint, d_feat), 0, -1):
        if d_feat % b == 0:
            return b
    return 1


class ComposedDeviceFeaturize:
    """Composition of device-fusable transformers as a featurize callable.

    Holds the member transformers (picklable, the save contract) and
    rebuilds the composed function on unpickle.
    """

    def __init__(self, members):
        self.members = list(members)
        self._build()

    def _build(self):
        fns = [m.device_fn() for m in self.members]

        def composed(X_t):
            for f in fns:
                X_t = f(X_t)
            return X_t

        self._fn = composed

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_fn", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._build()

    def __call__(self, X_t):
        return self._fn(X_t)


def _extract_bank(members) -> Optional[CosineBankFeaturize]:
    """Recognize the cosine-featurizer shapes the optimizer produces and
    turn them into one :class:`CosineBankFeaturize` (the TIMIT composition,
    a gather of CosineRandomFeatures branches + VectorCombiner, is exactly
    this after GatherFusionRule)."""
    from keystone_tpu_torch.ops.stats import CosineRandomFeaturesModel
    from keystone_tpu_torch.ops.util import VectorCombiner
    from keystone_tpu_torch.workflow.fusion import FusedGatherTransformer

    if len(members) != 1:
        return None
    m = members[0]
    if isinstance(m, CosineRandomFeaturesModel):
        return CosineBankFeaturize(m.W, m.b)
    if isinstance(m, FusedGatherTransformer):
        if not isinstance(m.combiner, VectorCombiner):
            return None
        rfs = []
        for br in m.branches:
            if len(br) != 1 or not isinstance(br[0], CosineRandomFeaturesModel):
                return None
            rfs.append(br[0])
        return CosineBankFeaturize(
            torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
        )
    return None


class BlockStreamedLeastSquares(LabelEstimator):
    """The block-streamed tier as a pipeline estimator: per-block featurize
    → block Gramian and correlation → solve → residual update
    (``streaming.streaming_block_bcd_mesh``), for geometries
    where even the (d, d) Gramian of the gram tier exceeds device memory
    (d ≳ 90,000 on an 80 GB card). Needs a :class:`CosineBankFeaturize`:
    the residual sweep featurizes each block from its slice of the bank.
    Centred by default, BlockLeastSquares semantics as the other tiers.
    """

    def __init__(
        self,
        bank: CosineBankFeaturize,
        d_feat: int,
        block_size: int,
        num_iter: int = 3,
        lam: float = 0.0,
        center: bool = True,
    ):
        if not isinstance(bank, CosineBankFeaturize):
            raise TypeError(
                "BlockStreamedLeastSquares needs a CosineBankFeaturize "
                "(per-block bank slices drive the residual sweep)"
            )
        if bank.Wrf.shape[0] != d_feat:
            raise ValueError(f"bank rows {bank.Wrf.shape[0]} != d_feat {d_feat}")
        self.bank = bank
        self.d_feat = d_feat
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.center = center

    @property
    def label(self) -> str:
        return f"BlockStreamedLeastSquares({self.d_feat},{self.block_size})"

    @property
    def weight(self) -> int:
        return self.num_iter + 1

    def fit(self, data: Dataset, labels: Dataset) -> StreamingFeaturizedLinearModel:
        if data.is_shard_backed:
            # The residual sweep re-featurizes X every block step, so it
            # needs the raw rows on the device: a shard source materializes
            # here (genuinely over-RAM sets belong to the disk tier, where
            # the capacity selector routes them).
            data = data.materialize()
        if labels.is_shard_backed:
            labels = labels.materialize()
        mesh = data.mesh if mesh_lib.is_multi_device(data.mesh) else None
        if mesh is not None:
            # Rows stay sharded: every kernel runs on each shard's rows and
            # each block step psums its Gramian and correlation once.
            X = data.array
            Y = labels.array if labels.is_sharded else labels.shard(mesh).array
        else:
            X = as_tensor(data.array, self.bank.Wrf.device)
            Y = as_tensor(labels.array, X.device)
        out = streaming.streaming_block_bcd_mesh(
            X, Y, self.bank.Wrf, self.bank.brf, block_size=self.block_size, lam=self.lam,
            num_iter=self.num_iter, mesh=mesh,
            n_true=int(data.n) if data.n != X.shape[0] else None,
            feat_dtype=self.bank.feat_dtype, center=self.center,
        )
        W, fmean, ymean = out if self.center else (out, None, None)
        return StreamingFeaturizedLinearModel(
            self.bank, W, streaming.pick_tile_rows(self.d_feat, 4), fmean=fmean, ymean=ymean,
        )


class StreamingLeastSquaresChoice(LabelEstimator, CostModel):
    """The cost model's streaming-tier selection for
    :class:`~keystone_tpu_torch.ops.learning.cost.LeastSquaresEstimator`.

    When the resident solvers' operands exceed device memory, the cost
    model returns this choice; the optimizer's StreamedFitFusionRule then
    binds the upstream featurizer into the fit (``fuse_with_members``),
    giving the out-of-core tier: featurize per row tile, Gramian fold,
    centered BCD (BlockLeastSquaresEstimator semantics). Fitting it
    directly (no fusable upstream) tile-streams the already-resident
    features through the same solver: correct, but without the memory win.

    Cost model: one streamed data pass building the normal equations (the
    exact solver's n·d·(d+k) flops, LinearMapper.scala:100-115) plus
    ``num_iter`` Gramian-space epochs, at a streaming overhead factor, so
    resident solvers win whenever they fit.
    """

    streamed_fit_fusable = True
    # Streamed fits pay the full normal-equations product plus per-tile
    # featurize regeneration: the reference's bias toward resident solvers
    # whenever the analytic models land close.
    _STREAM_OVERHEAD = 2.0

    def __init__(
        self,
        num_iter: int = 3,
        lam: float = 0.0,
        block_size_hint: int = 4096,
        center: bool = True,
        device=None,
    ):
        self.num_iter = num_iter
        self.lam = lam
        self.block_size_hint = block_size_hint
        self.center = center
        # Where a disk-tier fit folds: None means the featurizer's device,
        # or the default device for the identity featurizer.
        self.device = device
        # Set by the owning LeastSquaresEstimator before cost evaluation:
        # bytes per raw input row (the streamed fit keeps raw rows, not
        # features, resident).
        self.raw_row_bytes: Optional[float] = None
        # Density of the raw input (set by the owner): decides how an unset
        # raw_row_bytes defaults in resident_bytes. None (no owner) is
        # treated as dense, the conservative direction for a feasibility cut.
        self.input_is_sparse: Optional[bool] = None
        # Feature-slab budget for the tile scan; the owner shrinks it when
        # the device budget is small so that the capacity model and the
        # actual fit agree on the working set.
        self.slab_bytes: int = 2 << 30
        # Device-memory budget (set by the owner): decides the tier, gram
        # (one data pass, needs an 8d² Gramian + factor stash) or block
        # streamed (per-block Gramians only) where 8d² itself exceeds it.
        self.budget_bytes: Optional[float] = None
        # Disk-tier facts (set by the owner when the sampled input is
        # shard-backed): raw rows then stream from disk segments, so the
        # capacity model prices staged buffers instead of n·raw resident,
        # and the fit folds over a prefetched ShardSource.
        self.data_is_shard_backed: bool = False
        self.shard_segment_bytes: Optional[float] = None
        self.prefetch_depth: int = 2
        # The CheckpointSpec (or directory) the disk fold snapshots and
        # resumes through; None defers to KEYSTONE_CHECKPOINT_DIR (run.py
        # --checkpoint-dir).
        self.checkpoint = None

    @property
    def label(self) -> str:
        return f"StreamingLeastSquaresChoice({self.num_iter},{self.lam})"

    @property
    def weight(self) -> int:
        return self.num_iter + 1

    def _slab(self, d_feat: int) -> float:
        """Bytes of one float32 feature slab of the tile scan."""
        return min(
            streaming.pick_tile_rows(d_feat, 4, slab_bytes=self.slab_bytes) * d_feat * 4.0,
            float(self.slab_bytes),
        )

    def _gram_tier_ok(self, d_feat: int) -> bool:
        """The d-only discriminator shared by the capacity model and
        build_estimator: the gram tier needs its (d, d) Gramian + factor
        stash resident."""
        if self.budget_bytes is None:
            return True
        return 8.0 * d_feat * d_feat + self._slab(d_feat) <= self.budget_bytes

    def _block_tier_bs(self, d_feat: int) -> int:
        """Block size for the block-streamed tier: the hint, shrunk until
        the per-block Gramian/factor stash (8·d·bs bytes) fits a quarter of
        the budget."""
        hint = self.block_size_hint
        if self.budget_bytes is not None:
            cap = max(int(self.budget_bytes / (32.0 * d_feat)), 1)
            hint = min(hint, cap)
        return pick_block_size(d_feat, hint)

    def build_estimator(self, featurize, d_feat: int):
        """The gram tier, with float32 feature tiles sized to ``slab_bytes``,
        where its Gramian fits the budget; else, for a cosine bank, the
        block-streamed tier. The decision is emitted as a
        ``cost.decision`` event and logged."""
        gram_ok = self._gram_tier_ok(d_feat)
        bank = isinstance(featurize, CosineBankFeaturize)
        winner, reason = (
            ("gram", "gramian_fits_budget") if gram_ok
            else ("block", "gramian_exceeds_budget") if bank
            else ("gram", "block_needs_bank_featurizer")
        )
        logger.info(
            "streaming tier: %s (%s), d_feat=%d, budget %s B, featurize %s",
            winner, reason, d_feat, self.budget_bytes, type(featurize).__name__,
        )
        obs.record_cost_decision(obs.CostDecision(
            decision="streaming_tier",
            winner=winner,
            candidates=[
                {"label": "gram", "feasible": gram_ok},
                {"label": "block", "feasible": bank},
            ],
            reason=reason,
            context={
                "d_feat": int(d_feat),
                "budget_bytes": self.budget_bytes,
                "featurize": type(featurize).__name__,
            },
        ))
        if winner == "block":
            return BlockStreamedLeastSquares(
                featurize, d_feat=d_feat, block_size=self._block_tier_bs(d_feat),
                num_iter=self.num_iter, lam=self.lam, center=self.center,
            )
        if not gram_ok:
            # The capacity model assumed the block tier (no d² term), but
            # only bank featurizers can drive per-block slices. Best effort,
            # as the reference: run the gram tier anyway (it may exceed the
            # budget) rather than fail a fit the selector already committed to.
            logger.warning(
                "d_feat=%d: (d, d) Gramian exceeds the device budget and the "
                "block-streamed tier needs a cosine bank featurizer (got %s); "
                "falling back to the gram tier: the fit may not fit device memory",
                d_feat, type(featurize).__name__,
            )
        return StreamingFeaturizedLeastSquares(
            featurize, d_feat=d_feat, block_size=pick_block_size(d_feat, self.block_size_hint),
            num_iter=self.num_iter, lam=self.lam, center=self.center,
            tile_rows=streaming.pick_tile_rows(d_feat, 4, slab_bytes=self.slab_bytes),
        )

    def fuse_with_members(self, members) -> "StreamedFitEstimator":
        fused = StreamedFitEstimator(members, self)
        # A pending cost-decision back-annotation (cost.py's optimize)
        # follows the fit to where it runs: the fused estimator replaces this
        # choice in the graph, so its fit stamps the measured seconds.
        ref = getattr(self, "_pending_cost_outcome", None)
        if ref is not None:
            fused._pending_cost_outcome = ref
            self._pending_cost_outcome = None
        return fused

    def fit_source(self, data: Dataset, labels: Dataset, featurize, d_feat: int):
        """The disk tier: fold the normal equations over prefetched shard
        segments (featurize applied a tile at a time inside the fold), so
        neither host RAM nor device memory holds the raw rows: the
        capacity-selected path for datasets past the host budget."""
        return _fit_paired_source(
            _paired_source(data, labels), featurize, d_feat,
            block_size=pick_block_size(d_feat, self.block_size_hint),
            lam=self.lam, num_iter=self.num_iter, center=self.center,
            prefetch_depth=self.prefetch_depth, checkpoint=self.checkpoint,
            device=self.device,
        )

    def fit(self, data: Dataset, labels: Dataset):
        if data.is_shard_backed:
            return self.fit_source(data, labels, _identity_featurize,
                                   _source_d_in(data.shard_source))
        if is_sparse_dataset(data):
            data = Densify().batch_apply(data)
        d_feat = int(as_tensor(data.array).shape[-1])
        return self.build_estimator(_identity_featurize, d_feat).fit(data, labels)

    def cost(
        self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight, network_weight,
    ) -> float:
        flops = (n * d * (d + k) + self.num_iter * d * d * k) / num_machines
        bytes_scanned = n * d / num_machines + 2.0 * d * d
        network = d * (d + k)  # the single (G, FY) reduction
        return (
            self._STREAM_OVERHEAD
            * max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model of whichever tier ``build_estimator`` would pick at
        this d (the shared ``_gram_tier_ok`` discriminator keeps the two
        consistent). Gram tier: raw rows + labels + the (d, d)
        Gramian/factor stash + one feature slab. Block tier: raw rows +
        labels + residual + per-block Gramian/factor stash + one block slab
        + the bank, no d² term. Disk tier (shard-backed input): the
        ``prefetch_depth + 1`` staged segments in place of the raw rows and
        labels, and the gram tier's stash whatever d (the disk fit always
        folds the Gramian), so no term scales with n."""
        raw = self.raw_row_bytes
        if self.input_is_sparse or not raw:
            # Sparse input is densified before the tile scan, so its
            # resident operand is 4d bytes a row whatever the COO width; an
            # unknown raw width on dense input is the full float32 row.
            raw = 4.0 * d
        bs = min(self.block_size_hint, d)
        if self.data_is_shard_backed:
            # If its 8d² Gramian passes the device budget, the disk tier
            # reports infeasible rather than running out of memory mid-fold.
            seg = self.shard_segment_bytes or (8192.0 * (raw + 4.0 * k))
            return (
                (self.prefetch_depth + 1) * seg
                + 8.0 * d * d
                + 8.0 * d * bs
                + self._slab(d)
            )
        common = n * raw / num_machines + 4.0 * n * k / num_machines
        if self._gram_tier_ok(d):
            return (
                common
                + 8.0 * d * d      # G + diagonal-block Cholesky stash
                + 8.0 * d * bs     # diag/chol block stacks in the solve
                + self._slab(d)
            )
        bs_b = self._block_tier_bs(d)
        return (
            common
            + 4.0 * n * k / num_machines       # residual R alongside Y
            + 8.0 * d * bs_b                   # per-block Gramian + factor stash
            + 4.0 * (n / num_machines) * bs_b  # one block slab
            + d * raw                          # bank rows ~ raw row width
        )


class StreamedFitEstimator(LabelEstimator):
    """A streaming fit bound to its upstream featurizer (the rewrite
    StreamedFitFusionRule performs).

    The members' composed ``device_fn`` becomes the tile featurizer of a
    :class:`StreamingFeaturizedLeastSquares`: featurize + Gramian fold +
    centered BCD, and the feature matrix never materializes (reference
    analog: LeastSquaresEstimator.scala:59-84 picking BlockLeastSquares,
    whose per-partition featurize + solve never materializes the global
    matrix either). Cosine featurizer shapes become one cosine bank.
    """

    def __init__(self, members, choice: StreamingLeastSquaresChoice):
        self.members = list(members)
        self.choice = choice
        self._featurize = _extract_bank(self.members) or ComposedDeviceFeaturize(self.members)

    @property
    def can_serve_raw_input(self) -> bool:
        """True when the fitted model can provably tell raw from featurized
        input by width, the gate StreamedFitFusionRule checks before
        rewiring apply sites to feed raw rows: a bank featurizer (widths
        known statically) with d_in != d_feat."""
        Wrf = getattr(self._featurize, "Wrf", None)
        return Wrf is not None and Wrf.shape[0] != Wrf.shape[1]

    @property
    def label(self) -> str:
        inner = " > ".join(m.label for m in self.members)
        return f"StreamedFit[{inner} -> {self.choice.label}]"

    @property
    def weight(self) -> int:
        return self.choice.weight

    def _fallback(self, data: Dataset, labels: Dataset):
        raw_width = self._raw_width(data)
        for m in self.members:
            data = m.batch_apply(data)
        model = self.choice.fit(data, labels)
        # Apply sites may have been rewired to feed raw rows (the rule
        # rewires only when can_serve_raw_input): make the fallback model
        # width-adaptive too, or those sites would fail on a raw batch.
        if (
            self.can_serve_raw_input
            and isinstance(model, StreamingFeaturizedLinearModel)
            and raw_width is not None
        ):
            model.featurize = self._featurize
            model.d_in = raw_width
        return model

    @staticmethod
    def _raw_width(data: Dataset):
        items = data.to_list() if data.is_host else None
        if items is not None:
            return int(as_tensor(items[0]).shape[-1]) if items else None
        return int(as_tensor(data.array).shape[-1])

    def fit(self, data: Dataset, labels: Dataset):
        if data.is_host or labels.is_host:
            return self._fallback(data, labels)
        if data.is_shard_backed:
            return self._fit_shard_backed(data, labels)
        X = as_tensor(data.array)
        # The feature width: the bank's rows, or else one featurized row
        # (the reference asks jax.eval_shape; a shape-only meta tensor
        # would fail the kernels' device check).
        Wrf = getattr(self._featurize, "Wrf", None)
        d_feat = int(Wrf.shape[0]) if Wrf is not None else int(self._featurize(X[:1]).shape[-1])
        d_in = int(X.shape[-1])
        model = self.choice.build_estimator(self._featurize, d_feat).fit(data, labels)
        if d_in == d_feat:
            # Width cannot tell raw from featurized input. The rule never
            # rewires apply sites in this case (can_serve_raw_input is
            # False), so every apply site featurizes upstream: the model
            # always takes the identity path.
            model.featurize = _identity_featurize
            model.d_in = None
        else:
            # Rewired apply sites feed raw rows (featurized tile-wise);
            # saved-state reuse in later pipelines with intact featurize
            # nodes feeds featurized rows.
            model.d_in = d_in
        return model

    def _fit_shard_backed(self, data: Dataset, labels: Dataset):
        """The out-of-core pipeline fit: raw rows stream from disk shards
        through the prefetcher, the bound featurizer runs a tile at a time
        inside the fold, and the feature matrix never exists at any tier,
        disk, host or device. The feature width is the bank's rows, or else
        the featurizer's output width on one meta row
        (``verify.MetaInterpretation``, the port's ``jax.eval_shape``)."""
        d_in = _source_d_in(data.shard_source)
        d_feat = _featurized_width(self._featurize, d_in)
        model = self.choice.fit_source(data, labels, self._featurize, d_feat)
        if d_in == d_feat:
            model.featurize = _identity_featurize
            model.d_in = None
        else:
            model.d_in = d_in
        return model


def _featurized_width(featurize, d_in: int) -> int:
    Wrf = getattr(featurize, "Wrf", None)
    if Wrf is not None:
        return int(Wrf.shape[0])
    from keystone_tpu_torch.workflow.verify import MetaInterpretation

    with torch.no_grad(), MetaInterpretation():
        out = featurize(torch.empty((1, d_in), dtype=torch.float32))
    return int(out.shape[-1])


def _source_d_in(src) -> int:
    """Row width of a shard source's data field (view or paired form):
    metadata, no segment load. Raises the same TypeError as
    ``_paired_source`` for sources that are not dense (a COOShardSource)."""
    width = getattr(src, "width", None)
    if width is None:
        width = getattr(src, "d_in", None)
    if width is None:
        raise TypeError(f"cannot stream a dense fit from shard source {type(src).__name__}")
    return int(width)


def _same_provider(a, b) -> bool:
    """Same segment provider: one object, or disk-shard sources over the
    same directory (two DiskDenseShards handles on one shard set are
    equivalent)."""
    if a is b:
        return True
    sa, sb = getattr(a, "shards", None), getattr(b, "shards", None)
    if sa is None or sb is None:
        return False
    if sa is sb:
        return True
    da, db = getattr(sa, "directory", None), getattr(sb, "directory", None)
    return da is not None and da == db


def _paired_source(data: Dataset, labels: Dataset):
    """The (X_seg, Y_seg, valid_rows) segment source a shard-backed fit
    folds over. Data and labels that view one set of disk shards (the
    spill path) cost no extra reads; resident labels are sliced a segment
    at a time."""
    from keystone_tpu_torch.data.prefetch import (
        DenseShardSource,
        DenseShardView,
        PairedDenseSource,
        ResidentDenseSource,
    )

    src = data.shard_source
    lsrc = labels.shard_source if labels is not None and labels.is_shard_backed else None
    if isinstance(src, DenseShardView):
        if isinstance(lsrc, DenseShardView):
            if lsrc.field == "x":
                raise ValueError(
                    "labels is a rows ('x') shard view — pass the labels ('y') view "
                    "(a duplicated or swapped pair would silently fit rows against rows)"
                )
            if _same_provider(lsrc.paired, src.paired):
                # The field check rides in PairedDenseSource too: a swapped
                # (data, labels) pair raises there.
                return PairedDenseSource(src)
        if labels is None:
            raise ValueError("shard-backed fit needs labels")
        return PairedDenseSource(src, np.asarray(labels.to_numpy()))
    if isinstance(src, (DenseShardSource, PairedDenseSource, ResidentDenseSource)):
        # The source delivers (X_seg, Y_seg, valid) triples with its own
        # labels: fitting against those while the caller passed different
        # labels would train the wrong model with no error, so only labels
        # that view the same source are accepted.
        if labels is not None:
            lbase = lsrc.paired if isinstance(lsrc, DenseShardView) else lsrc
            base = getattr(src, "paired", src)
            same = lsrc is src or (lbase is not None and _same_provider(lbase, base))
            if not same:
                raise ValueError(
                    "data's shard source embeds its own labels; pass the matching "
                    "labels view of the same shards (unrelated labels would be "
                    "silently ignored)"
                )
        return src
    raise TypeError(f"cannot stream a fit from shard source {type(src).__name__}")


def _fit_paired_source(source, featurize, d_feat: int, block_size: int, lam,
                       num_iter: int, center: bool, prefetch_depth: int = 2,
                       checkpoint=None, device=None) -> StreamingFeaturizedLinearModel:
    """The disk tier's fit: prefetched segment folds -> (centred) BCD on the
    normal equations -> the affine model every streaming tier returns.
    ``checkpoint`` (a CheckpointSpec or directory; None consults
    ``KEYSTONE_CHECKPOINT_DIR``) makes the fold resumable: a killed fit
    re-run with the same spec continues from its last snapshot, with the
    uninterrupted fit's bits."""
    W, fmean, ymean, _ = streaming.streaming_bcd_fit_segments(
        source, bank=featurize, d_feat=d_feat, block_size=block_size, lam=lam,
        num_iter=num_iter, center=center, prefetch_depth=prefetch_depth,
        checkpoint=checkpoint, device=device,
    )
    return StreamingFeaturizedLinearModel(
        featurize, W, streaming.pick_tile_rows(d_feat, 4), fmean=fmean, ymean=ymean,
    )
