"""Out-of-core (streaming / tiled) least squares: the memory-wall crosser.

Port of ``keystone_tpu/parallel/streaming.py``, single device. The
reference's substrate streams by construction (a lazy ``textFile``,
CsvDataLoader.scala:10-31; per-partition Gramians summed by a
``treeReduce``, BlockWeightedLeastSquares.scala:177-313): the full feature
matrix never exists. Here features are made one row tile at a time, and
each tile is folded into the normal equations

    G  += FₜᵀFₜ          (the ``gram_sym_acc`` CUDA kernel, in place)
    FY += FₜᵀYₜ
    yty += ΣYₜ²

so the (tile_rows, d) feature slab is the only feature storage that ever
exists. At TIMIT's scale (n = 2.2e6, d = 16384) the materialized features
would be 144 GB in float32; the streamed state is G (1.07 GB) + one slab
(2.15 GB) + the raw input (3.9 GB).

The solve then runs block Gauss-Seidel directly on the normal equations:

    W_b ← (G_bb + λI)⁻¹ (FY_b − Σ_{j≠b} G_bj W_j)

the same iterate sequence as residual-maintaining BCD
(``linalg.bcd_least_squares_fused_flat``) with the residual eliminated
through R = Y − F W. Extra epochs cost only (d, block) × (block, k)
products on the cached Gramian, no data pass.

Differences from the reference:
  - its ``lax.scan`` over tiles and ``fori_loop`` over blocks become Python
    loops; the fold updates its carry in place (the carry is the fold's
    own), where the reference's functional update lets XLA reuse buffers;
  - a ragged last tile is folded as it is, without the reference's padding
    to its kernel's 512-row alignment: the kernel masks ragged rows;
  - rows at and past ``valid`` are dropped from the feature tile after
    featurizing (a view of the first rows), which contributes exactly what
    the reference's zeroed rows contribute;
  - there is no ``use_pallas`` switch: on the card the fold always takes
    ``gram_sym_acc``, and on the CPU its plain version (the reference's
    pipeline passes ``use_pallas=False`` and folds with XLA's ``FᵀF``; both
    compute the same function on the upper tiles);
  - the jit dispatchers (``_streaming_fit_closure``, ``_streaming_fit_bank``,
    ``_dispatch_fit``, ``_solve_from_stats``) exist in the reference only
    to share compiled programs across fits; eager PyTorch compiles nothing,
    so they collapse to plain calls of ``_fit_core`` and
    ``_solve_from_stats_core``, and only a static ``valid`` is taken.

The block-streamed program, ``streaming_block_bcd_mesh``, makes its
features one (n, block) slab a block step and frees them, so the (d, d)
Gramian never exists either; that is the tier past the gram tier's wall
(TIMIT at d = 204,800). Without a mesh (or on one shard) it is the
reference's program on a 1-device mesh, where every ``psum`` is the
identity.

The mesh forms (``parallel/mesh.py``: rows sharded over ``data``, zero
padding past ``n_true``): ``gram_stats_mesh`` folds each shard's tiles
through ``gram_sym_acc`` and psums (G, FY, yty) once a fit (the column
sums too for the centred fits); ``streaming_bcd_fit_mesh[_centered]``
solve on the psum'd stats; ``streaming_block_bcd_mesh(mesh=)`` runs each
block step's kernels on every shard and psums the block's Gramian and
correlation once a step; ``streaming_block_bcd_mesh_2d`` shards the rows
over data × model and solves each block on its owner along ``model``.
Padding rows are dropped per shard (a view of each shard's valid rows),
which contributes what the reference's masked rows do; a shard past
``n_true`` folds nothing.

``streaming_bcd_fit_segments`` is the disk tier's fold: pre-tiled
segments delivered one at a time by a ``ShardSource`` (memory-mapped disk
shards, prefetched) or a callable, each tile folded as above, with
resumable checkpoints of the carry. On the card each segment is staged in
page-locked memory on the reader thread and copied on a side stream while
the previous segment folds; the reference's ``BoundedInflight`` becomes a
queue of CUDA events that keeps at most ``inflight`` segments ahead of the
card.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch import obs, resolve_device

from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops

from . import mesh as mesh_lib
from .linalg import _acc_dtype, _corr, _psd_factor, _solve_psd

# Device-memory budget for one feature slab (the streamed working set).
_SLAB_BYTES = 2 << 30
# Row alignment of the reference's Pallas kernel (its k-tile). The port's
# kernel needs none; tiles keep it so that both fold the same rows in the
# same order.
_ROW_ALIGN = 512


def pick_tile_rows(d_feat: int, feat_itemsize: int = 2, slab_bytes: int = _SLAB_BYTES) -> int:
    """Largest _ROW_ALIGN-multiple tile whose feature slab (``feat_itemsize``
    bytes an element) fits ``slab_bytes``. The default itemsize is the
    reference's (bf16 tiles); the port's streamed tier makes float32 tiles,
    so its callers pass 4."""
    rows = max(slab_bytes // max(d_feat * feat_itemsize, 1), _ROW_ALIGN)
    return max((rows // _ROW_ALIGN) * _ROW_ALIGN, _ROW_ALIGN)


def _row_mask(M: torch.Tensor, valid: Optional[int]) -> torch.Tensor:
    """M without its rows at index >= valid (padding rows must not touch
    G/FY): a view of the first ``valid`` rows, never a copy."""
    return M if valid is None else M[:valid]


def _tile_update(G, FY, yty, fsum, ysum, X_t, Y_t, featurize, valid: Optional[int]):
    """Fold one row tile into (G, FY, yty, fsum, ysum), updating G, FY,
    fsum and ysum in place; returns the carry. ``valid`` drops rows >=
    valid; None means the whole tile is valid.

    Masking applies to the *feature* rows, not just X rows: a zero input
    row still featurizes to cos(b), a nonzero constant, so padding must be
    excluded after featurization. The column sums ride the same pass, so
    the centered solvers get their means for free.
    """
    F_t = _row_mask(featurize(X_t), valid)
    Y_t = _row_mask(Y_t, valid)
    if F_t.device.type != "cpu" and not cuda_ops.gram_acc_ok(F_t):
        # The kernel reads contiguous rows: a tile with strided columns is
        # copied. A dtype it cannot take (float64) raises in the wrapper.
        F_t = F_t.contiguous()
    cuda_ops.gram_sym_acc(G, F_t, out=G)
    FY += _corr(F_t, Y_t).to(torch.float32)
    Yf = Y_t.to(torch.float32)
    # dtype=f32 so bf16 feature slabs accumulate their column sums at the
    # same precision as the G/FY folds (cos features have near-zero means:
    # a bf16 sum would bias the centered solve).
    fsum += F_t.sum(dim=0, dtype=torch.float32)
    ysum += Yf.sum(dim=0)
    return G, FY, yty + (Yf * Yf).sum(), fsum, ysum


def gram_stats(
    X,
    Y,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    valid: Optional[int] = None,
    labelize: Optional[Callable] = None,
    moments: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Accumulate (G = FᵀF, FY = FᵀY, yty = ΣY²) over row tiles of X.

    With ``moments=True`` also returns the per-column sums (fsum = Σᵢ fᵢ,
    ysum = Σᵢ yᵢ) accumulated in the same pass, the centered solvers'
    means (the streamed analog of BlockLinearMapper.scala:224-243's
    per-block StandardScalers). Returns (G, FY, yty) or
    (G, FY, yty, fsum, ysum).

    X: (n, d_in), or pre-tiled (T, tile_rows, d_in). Y: (n, k) /
    (T, tile_rows, k), or raw per-row labels of any trailing shape when
    ``labelize`` maps a label slice to the (rows, k) regression target per
    tile (a one-hot target then never exists at full n).

    The feature matrix F = featurize(X), (n, d_feat) conceptually, is made
    one (tile_rows, d_feat) slab at a time and never materialized. A ragged
    last tile is folded as it is: the kernel masks ragged rows, so unlike
    the reference's fold it is not padded to 512 rows.

    ``valid`` (an int) excludes trailing padding rows: tiles entirely
    inside it run unmasked, the boundary tile drops its rows past it
    (after featurizing: a zero input row still featurizes to cos(b) ≠ 0),
    and tiles past it are skipped. Returns G with both triangles valid.
    """
    X = as_tensor(X)
    Y = as_tensor(Y, X.device)
    if X.dim() == 3:
        num_tiles, tile_rows = int(X.shape[0]), int(X.shape[1])
        n = num_tiles * tile_rows
        tiles = [(X[t], Y[t], t * tile_rows) for t in range(num_tiles)]
    else:
        n = int(X.shape[0])
        tiles = [
            (X[s:s + tile_rows], Y[s:s + tile_rows], s) for s in range(0, n, tile_rows)
        ]
    if labelize is None:
        labelize = lambda y_t: y_t  # noqa: E731 — identity target map
    # The target width, from one row (the reference asks jax.eval_shape).
    k = int(labelize(tiles[0][1][:1]).shape[-1]) if tiles else int(Y.shape[-1])
    valid = n if valid is None else int(valid)

    carry = _new_carry(d_feat, k, X.device)
    for X_t, y_t, start in tiles:
        rows = int(X_t.shape[0])
        if start >= valid:
            break
        tile_valid = None if start + rows <= valid else valid - start
        carry = _tile_update(*carry, X_t, labelize(y_t), featurize, tile_valid)

    G, FY, yty, fsum, ysum = carry
    _mirror_upper(G)
    if moments:
        return G, FY, yty, fsum, ysum
    return G, FY, yty


def _mirror_upper(G: torch.Tensor) -> None:
    """Make G symmetric from its upper triangle, in place. The kernel writes
    upper-triangle tiles only; mirroring from triu is also exact for the
    plain path (G symmetric). One (d, d) temporary: the strict upper
    triangle."""
    upper = torch.triu(G, 1)
    G.triu_().add_(upper.T)
    del upper


def _new_carry(d_feat: int, k: int, device) -> Tuple[torch.Tensor, ...]:
    """Zero (G, FY, yty, fsum, ysum)."""
    return (
        torch.zeros((d_feat, d_feat), dtype=torch.float32, device=device),
        torch.zeros((d_feat, k), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device),
        torch.zeros((d_feat,), dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.float32, device=device),
    )


def bcd_from_gram(G, FY, block_size: int, lam: float, num_iter: int) -> torch.Tensor:
    """Block Gauss-Seidel ridge solve on accumulated normal equations.

    Returns W as (nb, block_size, k): the same iterate sequence as
    residual-form BCD (the residual is eliminated algebraically; see the
    module docstring). The per-block Cholesky factors are computed once,
    batched over the (nb, bs, bs) stack of diagonal blocks; every epoch
    costs nb (d, block) × (block, k) products against the cached G, no
    data.
    """
    d, k = FY.shape
    if num_iter < 1:
        raise ValueError(f"num_iter must be >= 1, got {num_iter}")
    if d % block_size:
        raise ValueError(f"feature dim {d} not divisible by {block_size}")
    nb = d // block_size
    lam = float(lam)

    # (nb, bs, bs) stack of diagonal blocks + factors (loop-invariant).
    diag = torch.stack([
        G[b * block_size:(b + 1) * block_size, b * block_size:(b + 1) * block_size]
        for b in range(nb)
    ])
    eye = torch.eye(block_size, dtype=G.dtype, device=G.device)
    chols, _ = torch.linalg.cholesky_ex(diag + lam * eye)

    W = torch.zeros((nb, block_size, k), dtype=G.dtype, device=G.device)
    S = torch.zeros((d, k), dtype=G.dtype, device=G.device)  # S = G @ W_flat, maintained
    for _ in range(num_iter):
        for b in range(nb):
            rows = slice(b * block_size, (b + 1) * block_size)
            Wb, Gbb = W[b], diag[b]
            # S_b = Σ_j G_bj W_j includes j = b; add G_bb W_b back to exclude it.
            rhs = FY[rows] - S[rows] + Gbb @ Wb
            Wb_new = _solve_psd(Gbb, rhs, lam, chol=chols[b])
            # Column block of G via the transposed row block (G symmetric):
            # the row block is contiguous, a column block a strided read.
            S += G[rows].T @ (Wb_new - Wb)
            W[b] = Wb_new
    return W


def _fit_core(X, Y, featurize, d_feat, tile_rows, block_size, lam, num_iter, valid,
              labelize, center):
    """Shared fit body: tile folds → (optional rank-1 centering) → BCD on
    the normal equations. Returns (W, loss, yty, fmean, ymean);
    fmean/ymean are None when ``center`` is False."""
    X = as_tensor(X)
    n_true = valid if valid is not None else (
        X.shape[0] if X.dim() == 2 else X.shape[0] * X.shape[1]
    )
    stats = gram_stats(X, Y, featurize, d_feat, tile_rows, valid=valid, labelize=labelize,
                       moments=center)
    G, FY, yty = stats[:3]
    fsum, ysum = stats[3:] if center else (None, None)
    W, loss, fmean, ymean = _solve_from_stats_core(
        G, FY, yty, fsum, ysum, n_true, lam, block_size, num_iter, center
    )
    return W, loss, yty, fmean, ymean


def streaming_bcd_fit(
    X,
    Y,
    *,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    block_size: int,
    lam: float,
    num_iter: int,
    valid: Optional[int] = None,
    labelize: Optional[Callable] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streamed fit: tiles → (G, FY, yty) → BCD epochs.

    X may be (n, d_in) or pre-tiled (T, tile_rows, d_in); see
    :func:`gram_stats` for the ``valid`` / ``labelize`` contracts. Returns
    (W, train_loss, yty) with W: (nb, block_size, k). The train loss
    ||Y − FW||²/n comes algebraically from the accumulated stats,
    (yty − 2·tr(Wᵀ FY) + tr(Wᵀ G W))/n: two small products, no data pass.

    ``mesh``: fold each shard's rows over the mesh's data axis and psum the
    stats once (:func:`gram_stats_mesh`), then solve; X (n, d_in) rows
    must divide over the axis (pad and pass ``valid``); ``labelize`` is
    not taken on this path (pre-apply it to Y).
    """
    if mesh is not None:
        if labelize is not None:
            raise ValueError(
                "labelize is not supported with mesh=; pre-apply it to Y "
                "(the mesh fold shards Y rows alongside X)"
            )
        n_true = valid if valid is not None else int(X.shape[0])
        G, FY, yty = gram_stats_mesh(X, Y, featurize, d_feat, tile_rows, mesh,
                                     n_true=valid)
        W, loss, _, _ = _solve_from_stats_core(G, FY, yty, None, None, n_true, lam,
                                               block_size, num_iter, False)
        return W, loss, yty
    W, loss, yty, _, _ = _fit_core(X, Y, featurize, d_feat, tile_rows, block_size, lam,
                                   num_iter, valid, labelize, False)
    return W, loss, yty


def _solve_from_stats_core(G, FY, yty, fsum, ysum, n_true, lam, block_size, num_iter,
                           center):
    """Solve tail shared by the fit entry points: (optional rank-1
    centering) → BCD on the normal equations → loss. ``G`` must have both
    triangles valid, and is centred in place when ``center``. Returns
    (W, loss, fmean, ymean), fmean/ymean None when not centering."""
    fmean = ymean = None
    if center:
        G, FY, yty, fmean, ymean = center_gram_stats(G, FY, yty, fsum, ysum, n_true)
    W = bcd_from_gram(G, FY, block_size, lam, num_iter)
    Wf = W.reshape(G.shape[0], W.shape[2])
    loss = (yty - 2.0 * torch.vdot(Wf.flatten(), FY.flatten())
            + torch.vdot(Wf.flatten(), (G @ Wf).flatten())) / n_true
    return W, loss, fmean, ymean


def center_gram_stats(G, FY, yty, fsum, ysum, n):
    """Rank-1-correct accumulated stats to their mean-centered form.

    With μ = fsum/n and ȳ = ysum/n over the n valid rows (padding rows
    contribute zero to every accumulator):

        Gc   = Σ(fᵢ−μ)(fᵢ−μ)ᵀ = G  − fsum·fsumᵀ/n
        FYc  = Σ(fᵢ−μ)(yᵢ−ȳ)ᵀ = FY − fsum·ysumᵀ/n
        ytyc = Σ‖yᵢ−ȳ‖²        = yty − ysum·ysum/n

    exactly: centering costs two rank-1 updates instead of a second data
    pass. G and FY are corrected in place (the reference returns new
    arrays; the fit owns its stats, and at d = 16384 a centred copy of G is
    another 1.07 GB). Returns (Gc, FYc, ytyc, fmean, ymean).
    """
    n = float(n)
    fmean = fsum / n
    ymean = ysum / n
    G.addr_(fsum, fmean, alpha=-1)
    FY.addr_(fsum, ymean, alpha=-1)
    ytyc = yty - torch.dot(ysum, ymean)
    return G, FY, ytyc, fmean, ymean


def streaming_bcd_fit_centered(
    X,
    Y,
    *,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    block_size: int,
    lam,
    num_iter: int,
    valid: Optional[int] = None,
    labelize: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean-centered streamed fit, the streamed form of
    ``BlockLeastSquaresEstimator`` semantics (per-block feature centering +
    label centering + intercept, BlockLinearMapper.scala:224-243): column
    sums accumulate in the same tile pass as G/FY, the normal equations get
    rank-1 centering corrections, and BCD runs on the centered system.

    Returns (W, fmean, ymean, loss): predictions are
    (F − fmean) @ W_flat + ymean, the affine model BlockLinearMapper
    applies.
    """
    W, loss, _, fmean, ymean = _fit_core(X, Y, featurize, d_feat, tile_rows, block_size,
                                         lam, num_iter, valid, labelize, True)
    return W, fmean, ymean, loss


def _fold_device(bank, device) -> torch.device:
    """Where a segment fold runs: ``device`` when given, else where the
    featurizer's parameters lie (a cosine bank's ``Wrf``, or the first
    tensor of a composed featurizer's members), else the default device."""
    if device is not None:
        return resolve_device(device)
    for t in _bank_tensors(bank):
        return t.device
    return resolve_device(None)


def _bank_tensors(bank):
    """The tensors a featurizer holds (its own attributes, and its
    members' for a composed one): its identity in a checkpoint's
    fingerprint, and the device it runs on."""
    owners = [bank] + list(getattr(bank, "members", []) or [])
    out = []
    for owner in owners:
        for value in getattr(owner, "__dict__", {}).values():
            if isinstance(value, torch.Tensor):
                out.append(value)
    return out


def _dense_segment_fold(carry, X_seg, Y_seg, valid_rows: int, featurize, tile_rows: int):
    """Fold one segment of pre-tiled rows (T, tile_rows, d_in) into the
    (G, FY, yty, fsum, ysum) carry, tile by tile in order. ``valid_rows``
    counts the segment's true rows: the boundary tile drops its rows past
    it, and tiles past it (phantom tiles of the last segment) are skipped,
    which contributes exactly what the reference's masked scan does.
    Integer rows (uint8 image shards) are widened to float32."""
    for t in range(int(X_seg.shape[0])):
        tile_valid = min(max(valid_rows - t * tile_rows, 0), tile_rows)
        if tile_valid == 0:
            break
        X_t, Y_t = X_seg[t], Y_seg[t]
        if not X_t.is_floating_point():
            X_t = X_t.to(torch.float32)
        carry = _tile_update(*carry, X_t, Y_t.to(torch.float32), featurize,
                             None if tile_valid == tile_rows else tile_valid)
    return carry


def streaming_bcd_fit_segments(
    segment_source,
    num_segments: Optional[int] = None,
    n_true: Optional[int] = None,
    bank=None,
    d_feat: Optional[int] = None,
    tile_rows: Optional[int] = None,
    block_size: Optional[int] = None,
    lam=0.0,
    num_iter: int = 1,
    center: bool = True,
    inflight: int = 2,
    prefetch_depth: int = 2,
    prefetch_stats=None,
    checkpoint=None,
    device=None,
):
    """Disk-bounded dense streamed fit: fold (G, FY, moments) over segments
    delivered one at a time (e.g. :class:`~keystone_tpu_torch.data.shards.
    DiskDenseShards` over memory-mapped tiles), then solve with
    (optionally centred) BCD on the normal equations. n is bounded by disk,
    not by host RAM or device memory.

    ``segment_source``: a :class:`~keystone_tpu_torch.data.prefetch.
    ShardSource` (``num_segments``, ``n_true`` and ``tile_rows`` then
    default from it, and a background reader prefetches segment k+1 while
    segment k is copied and folded; ``prefetch_depth`` bounds the staged
    host buffers, 0 loads serially with the same bits), or a callable
    ``segment_source(s) -> (X_seg (T, tile_rows, d_in), Y_seg
    (T, tile_rows, k), valid_rows)``, loaded serially (a callable makes no
    thread-safety promise). ``bank`` is the featurize callable applied to
    each tile (on the card a cosine bank launches ``cosine_features``, and
    every tile ``gram_sym_acc``). ``device``: where the fold runs; None
    means the featurizer's device (see :func:`_fold_device`). ``inflight``:
    segments the host may run ahead of the card. Returns (W, fmean, ymean,
    loss) when centred, else (W, None, None, loss).

    ``checkpoint``: a :class:`~keystone_tpu_torch.data.durable.
    CheckpointSpec` (or directory; None consults ``KEYSTONE_CHECKPOINT_DIR``)
    that snapshots the carry (G, FY, yty, fsum, ysum) and the segment
    cursor every ``every_segments`` segments. A fit killed mid-stream and
    re-run with the same spec resumes at the last snapshot with the
    uninterrupted run's bits (the carry round-trips as raw float32 bytes
    and the remaining segments fold in the same order); the snapshot is
    cleared on success.
    """
    from keystone_tpu_torch.data.durable import (
        fingerprint_token,
        resolve_checkpoint,
        source_fingerprint,
    )
    from keystone_tpu_torch.data.prefetch import (
        is_shard_source,
        iter_segments,
        stage_segment,
        to_device_segment,
    )

    checkpoint = resolve_checkpoint(checkpoint)
    if is_shard_source(segment_source):
        if num_segments is None:
            num_segments = segment_source.num_segments
        if n_true is None:
            n_true = segment_source.n_true
        if tile_rows is None:
            tile_rows = getattr(segment_source, "tile_rows", None)
    else:
        prefetch_depth = 0  # plain callables make no thread-safety promise
    if num_segments is None or n_true is None:
        raise ValueError("callable segment sources need explicit num_segments and n_true")
    if bank is None or d_feat is None or tile_rows is None or block_size is None:
        raise ValueError(
            "streamed segment fit needs bank, d_feat, block_size, and tile_rows "
            "(tile_rows defaults only from a ShardSource)"
        )
    device = _fold_device(bank, device)
    carry = None
    start = 0
    fingerprint = None
    if checkpoint is not None:
        # Geometry, featurizer identity (type and parameter digests) and
        # source identity: a stale snapshot from a different bank or a
        # re-ingested shard directory never seeds this fold.
        fingerprint = {
            "kind": "dense_bcd_segments",
            "num_segments": int(num_segments), "n_true": int(n_true),
            "d_feat": int(d_feat), "tile_rows": int(tile_rows),
            "bank": {
                "type": fingerprint_token(type(bank)),
                "params": fingerprint_token(_bank_tensors(bank)),
            },
            "source": source_fingerprint(segment_source),
        }
        arrays, start = checkpoint.restore(fingerprint)
        if arrays is not None:
            carry = tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    in_flight: deque = deque()
    for s, staged in iter_segments(
        segment_source, num_segments=num_segments, prefetch_depth=prefetch_depth,
        stats=prefetch_stats, start=start,
        stage=lambda payload: stage_segment(payload, device),
    ):
        t0 = time.perf_counter()
        # The span covers the same region as the `compute` busy counter; on
        # the card it closes when the segment's launches are queued, not
        # done (obs/calibrate.py keeps such rows out of the refit).
        with obs.span("fold.segment", segment=int(s),
                      **({"queued": True} if device.type == "cuda" else {})):
            X_seg, Y_seg, valid_rows = to_device_segment(staged, device, copy_stream)
            del staged
            if carry is None:
                carry = _new_carry(d_feat, int(Y_seg.shape[-1]), device)
            carry = _dense_segment_fold(carry, X_seg, Y_seg, int(valid_rows), bank,
                                        int(tile_rows))
            del X_seg, Y_seg
            if copy_stream is not None:
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > max(int(inflight), 1):
                    in_flight.popleft().synchronize()
        if prefetch_stats is not None:
            # The `compute` site: copy, fold dispatch and the inflight
            # bound's blocking.
            prefetch_stats.add_busy("compute", time.perf_counter() - t0)
        if checkpoint is not None:
            checkpoint.maybe_save(carry, s, num_segments, fingerprint, stats=prefetch_stats)
    if carry is None:
        raise ValueError("the segment source delivered no segments")
    G, FY, yty, fsum, ysum = carry
    _mirror_upper(G)
    W, loss, fmean, ymean = _solve_from_stats_core(
        G, FY, yty, fsum, ysum, int(n_true), lam, block_size, num_iter, center,
    )
    if checkpoint is not None:
        # The fit completed: a later fit with this fingerprint starts
        # fresh. Only this fit's snapshot goes.
        checkpoint.clear(fingerprint)
    return W, fmean, ymean, loss


def streaming_predict(X, W, featurize: Callable, tile_rows: int) -> torch.Tensor:
    """Predictions F @ W_flat computed tile-wise (F never materialized).

    W: (nb, block, k) from the fit. X may be (n, d_in) or pre-tiled
    (T, tile_rows, d_in); predictions come back as (n, k) float32 either
    way, each tile's written into its rows of one output buffer. The
    product is the mappers' (``linear.mapper_product``: float32 through
    ``row_stable_matmul``), so a row's prediction has the same bits in a
    full tile and in the ragged last one.
    """
    from keystone_tpu_torch.ops.learning.linear import mapper_product

    X = as_tensor(X)
    Wf = W.reshape(-1, W.shape[2])
    if X.dim() == 3:
        X = X.reshape(X.shape[0] * X.shape[1], X.shape[2])
    n = int(X.shape[0])
    out = torch.empty((n, Wf.shape[1]), dtype=torch.float32, device=X.device)
    for s in range(0, n, tile_rows):
        F_t = featurize(X[s:s + tile_rows])
        out[s:s + tile_rows] = mapper_product(F_t, Wf.to(F_t.dtype))
        # Free this slab before the next is made: rebinding F_t would hold
        # two slabs (4 GiB at the TIMIT geometry) for the next featurize.
        del F_t
    return out


def _sharded(x, mesh, axis) -> mesh_lib.ShardedRows:
    if isinstance(x, mesh_lib.ShardedRows):
        return x
    return mesh_lib.shard_rows(as_tensor(x), mesh, axis)


def _valid_views(Xs: mesh_lib.ShardedRows, n_true: Optional[int]):
    """Each shard's rows before the global row ``n_true`` (a view), and
    their counts: padding rows never reach a kernel."""
    rows = Xs.shard_rows
    n = Xs.shape[0] if n_true is None else int(n_true)
    counts = [min(max(n - i * rows, 0), rows) for i in range(Xs.num_shards)]
    return [s[:c] for s, c in zip(Xs.shards, counts)], counts


def gram_stats_mesh(
    X,
    Y,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    mesh,
    n_true: Optional[int] = None,
    moments: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Mesh-parallel :func:`gram_stats`: rows sharded over ``data``; each
    shard folds its own tiles (``gram_sym_acc`` on the card), then one
    ``psum`` of (G, FY, yty) (and the column sums with ``moments``) in
    shard order on the axis's first device: the treeReduce analog, one
    collective a fit.

    X (n_pad, d_in) and Y (n_pad, k): :class:`~keystone_tpu_torch.parallel.
    mesh.ShardedRows` or tensors whose rows divide over the axis.
    ``n_true``: the true global row count when X was padded to shard
    evenly; each shard's rows past it are dropped after featurizing (a
    zero row featurizes to cos(b) ≠ 0), and a shard entirely past it
    folds nothing.
    """
    axis = mesh_lib.DATA_AXIS
    Xs, Ys = _sharded(X, mesh, axis), _sharded(Y, mesh, axis)
    local_rows, n_padded = Xs.shard_rows, Xs.shape[0]

    def local(xs, ys):
        valid = None
        if n_true is not None and n_true != n_padded:
            start = mesh_lib.axis_index(axis) * local_rows
            valid = min(max(int(n_true) - start, 0), local_rows)
        return gram_stats(xs, ys, featurize, d_feat, min(tile_rows, local_rows),
                          valid=valid, moments=moments)

    n_out = 5 if moments else 3
    return mesh_lib.shard_map(local, mesh, in_specs=(axis, axis),
                              out_specs=(None,) * n_out)(Xs, Ys)


def streaming_bcd_fit_mesh(
    X,
    Y,
    *,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    block_size: int,
    lam: float,
    num_iter: int,
    mesh,
    n_true: Optional[int] = None,
) -> torch.Tensor:
    """Mesh streamed fit: sharded tile folds + one psum + the solve.
    Pass the true global row count as ``n_true`` when the rows were padded
    to shard evenly. Returns W (nb, block_size, k)."""
    G, FY, _ = gram_stats_mesh(X, Y, featurize, d_feat, tile_rows, mesh, n_true=n_true)
    return bcd_from_gram(G, FY, block_size, lam, num_iter)


def streaming_bcd_fit_mesh_centered(
    X,
    Y,
    *,
    featurize: Callable,
    d_feat: int,
    tile_rows: int,
    block_size: int,
    lam,
    num_iter: int,
    mesh,
    n_true: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mesh form of :func:`streaming_bcd_fit_centered`: sharded tile folds
    (column sums psum'd beside G/FY, still one collective a fit), rank-1
    centering corrections, the solve. Returns (W, fmean, ymean)."""
    G, FY, yty, fsum, ysum = gram_stats_mesh(X, Y, featurize, d_feat, tile_rows, mesh,
                                             n_true=n_true, moments=True)
    n = n_true if n_true is not None else int(X.shape[0])
    Gc, FYc, _, fmean, ymean = center_gram_stats(G, FY, yty, fsum, ysum, n)
    return bcd_from_gram(Gc, FYc, block_size, lam, num_iter), fmean, ymean


def _block_bcd_sweep(xs, ys, Wrf, brf, *, n: int, block_size: int, lam: float,
                     num_iter: int, feat_dtype: torch.dtype, center: bool, solve_device):
    """The block-streamed sweep over row shards: ``xs`` / ``ys`` are each
    shard's valid rows, on its device (one shard without a mesh), ``n``
    their total. Every block step makes each shard's slab, sums the
    shards' partials in shard order (``psum``) on ``solve_device(b)``,
    solves there, and updates each shard's residual rows. On one shard
    the psums are copies, and the sweep is the reference's 1-device mesh
    program. Returns (W, M, ymean) on the first shard's device; M and
    ymean are None unless centred."""
    psum = mesh_lib.psum
    d_feat = int(Wrf.shape[0])
    if d_feat % block_size:
        raise ValueError(f"d_feat {d_feat} not divisible by {block_size}")
    nb, bs = d_feat // block_size, block_size
    acc = _acc_dtype(feat_dtype)
    kernels = acc == torch.float32  # float32 and bf16 slabs; float64 takes plain contractions
    xs = [x.to(torch.float32).contiguous() for x in xs]
    dev0 = xs[0].device
    # The bank on each shard's device (the reference replicates it).
    banks = {}
    for x in xs:
        if x.device not in banks:
            banks[x.device] = (Wrf.to(x.device), brf.to(x.device))
    R = [y.to(acc, copy=True) for y in ys]
    ymean = None
    if center:
        ymean = psum([r.sum(dim=0) for r in R], dev0) / n
        for r in R:
            r -= ymean.to(r.device)
    W = torch.zeros((nb, bs, R[0].shape[1]), dtype=acc, device=dev0)
    M = torch.zeros((nb, bs), dtype=acc, device=dev0) if center else None
    # The Gramian and Cholesky stash, kept only where a later epoch reads it.
    stash = [None] * nb

    for epoch in range(max(int(num_iter), 1)):
        for b in range(nb):
            rows = slice(b * bs, (b + 1) * bs)
            sd = solve_device(b)
            F = [cuda_ops.cosine_features(x, banks[x.device][0][rows], banks[x.device][1][rows],
                                          compute_dtype=torch.float32, out_dtype=feat_dtype)
                 for x in xs]
            mu = None
            if epoch == 0:
                if kernels:
                    # R rounded to F's dtype, as the reference's correlation reads it.
                    parts = [cuda_ops.gram_corr_sym(f, r.to(f.dtype)) for f, r in zip(F, R)]
                else:
                    parts = [(f.T.to(acc) @ f.to(acc), _corr(f, r)) for f, r in zip(F, R)]
                gram = psum([g for g, _ in parts], sd)
                corr = psum([c for _, c in parts], sd)
                del parts
                if center:
                    fsum = psum([f.sum(dim=0, dtype=torch.float32).to(acc) for f in F], sd)
                    mu = fsum / n
                    gram.addr_(fsum, mu, alpha=-1)
                    M[b] = mu
                chol = _psd_factor(gram, lam)
                if num_iter > 1:
                    stash[b] = (gram, chol)
            else:
                gram, chol = stash[b]
                corr = psum([cuda_ops.block_corr(f, 0, bs, r) if kernels else _corr(f, r)
                             for f, r in zip(F, R)], sd)
                if center:
                    mu = M[b].to(sd)
            if center:
                corr.addr_(mu, psum([r.sum(dim=0) for r in R], sd), alpha=-1)
            w_old = W[b].to(sd)
            w_new = _solve_psd(gram, corr + gram @ w_old, lam, chol=chol)
            dw = w_new - w_old
            for i, f in enumerate(F):
                dwi = dw.to(f.device)
                if kernels:
                    R[i] = cuda_ops.block_residual_update(f, 0, bs, dwi.to(f.dtype), R[i])
                else:
                    R[i] = R[i] - f.to(acc) @ dwi.to(f.dtype).to(acc)
                if center:
                    R[i] += mu.to(f.device) @ dwi
            W[b] = w_new
            # Free this step's slabs before the next are made: rebinding F
            # would hold two (2.1 GB each at 131,072 rows of a 4,096 block).
            del F
    return W, M, ymean


def streaming_block_bcd_mesh(
    X,
    Y,
    Wrf,
    brf,
    *,
    block_size: int,
    lam: float,
    num_iter: int,
    mesh=None,
    n_true: Optional[int] = None,
    feat_dtype: torch.dtype = torch.float32,
    center: bool = False,
):
    """The block-streamed program: cosine-featurize + block coordinate
    descent where each feature block is made for its step and freed.

    X (n, d_in) and Y (n, k) rows; the bank Wrf (d_feat, d_in), brf
    (d_feat,). Each block step b:

        F_b = cos(X Wrf_bᵀ + brf_b)        (n, block) slab, freed after
        W_b ← (F_bᵀF_b + λI)⁻¹ (F_bᵀR + F_bᵀF_b W_b)
        R   ← R − F_b ΔW_b

    so neither the (n, d_feat) features nor the (d_feat, d_feat) Gramian
    ever exist; what stays resident is X, Y, R, one slab and the
    epoch-invariant (nb, block, block) Gramian and Cholesky stash. Epoch 1
    makes each block's Gramian, later epochs reuse the stash. The features
    are computed in float32 and rounded to ``feat_dtype`` (float32 or
    bfloat16; float64 takes plain contractions, as
    ``linalg._bcd_block_update`` does).

    Kernels on CUDA tensors: ``cosine_features`` on the bank's row slice (a
    view) for every slab, ``gram_corr_sym`` for epoch 1's Gramian and
    correlation in one launch, ``block_corr`` for later epochs'
    correlations and ``block_residual_update`` for every step's residual.

    ``center=True`` gives BlockLeastSquares semantics: the block's column
    sum rides epoch 1's pass (in float32, from bf16 slabs too), its Gramian
    is centred (G − fsum μᵀ) before it is factored, each correlation is
    FᵀR − μ(ΣR)ᵀ on the R the step reads, and the residual update adds
    back μᵀΔW. Returns W (nb, block, k), or (W, fmean, ymean) when centred:
    predictions are (F − fmean) @ W_flat + ymean.

    ``n_true`` drops the padding rows past it. The reference zeroes their
    features and residual rows; a view of the rows before ``n_true`` gives
    the same function.

    ``mesh`` (more than one shard on ``data``): X and Y rows sharded over
    the axis (:class:`~keystone_tpu_torch.parallel.mesh.ShardedRows`, or
    tensors whose rows divide over it); every kernel launches once a shard
    on the shard's rows, and the block's Gramian and correlation (with the
    column and residual sums when centred) are psum'd once a step onto
    the axis's first device, where the block solves. The weights come
    back there.
    """
    if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS) > 1:
        axis = mesh_lib.DATA_AXIS
        Xs, Ys = _sharded(X, mesh, axis), _sharded(Y, mesh, axis)
        xs, counts = _valid_views(Xs, n_true)
        live = [i for i, c in enumerate(counts) if c]
        xs = [xs[i] for i in live]
        ys = [Ys.shards[i][:counts[i]] for i in live]
        solve_dev = mesh.axis_devices(axis)[0]
        n = sum(counts)
    else:
        X = as_tensor(X)
        n = int(X.shape[0]) if n_true is None else int(n_true)
        xs, ys = [X[:n]], [as_tensor(Y, X.device)[:n]]
        solve_dev = X.device
    dev = xs[0].device
    Wrf, brf = as_tensor(Wrf, dev), as_tensor(brf, dev)
    W, M, ymean = _block_bcd_sweep(
        xs, ys, Wrf, brf, n=n, block_size=block_size, lam=float(lam), num_iter=num_iter,
        feat_dtype=feat_dtype, center=center, solve_device=lambda b: solve_dev)
    W = W.to(solve_dev)
    if center:
        return W, M.reshape(-1).to(solve_dev), ymean.to(solve_dev)
    return W


def streaming_block_bcd_mesh_2d(
    X,
    Y,
    Wrf,
    brf,
    *,
    block_size: int,
    lam: float,
    num_iter: int,
    mesh,
    n_true: Optional[int] = None,
    feat_dtype: torch.dtype = torch.float32,
    center: bool = False,
):
    """2-D (data × model) form of :func:`streaming_block_bcd_mesh`: rows
    shard over both axes flattened, data major (the reference's
    ``P((data, model))``), so every shard computes on every block step;
    block b's owner along ``model`` is ``b // (nb / model_size)``
    (contiguous, as the bank's natural sharding), and its Gramian and
    factor stash and its solves live on the owner's device (row 0 of the
    ``data`` axis), so a device holds nb / model_size blocks' stash.

    Returns the (nb, bs, k) block weights on the first device (the
    reference returns them sharded over ``model``); with ``center=True``
    (W, fmean (nb, bs), ymean), as the reference's 2-D form does.
    """
    data_ax, model_ax = mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS
    d_feat = int(as_tensor(Wrf).shape[0])
    if d_feat % block_size:
        raise ValueError(f"d_feat {d_feat} not divisible by {block_size}")
    nb = d_feat // block_size
    mc = mesh_lib.axis_size(mesh, model_ax)
    if nb % mc:
        raise ValueError(f"nb {nb} not divisible by model axis {mc}")
    nb_local = nb // mc
    axes = tuple(a for a in (data_ax, model_ax) if a in mesh.shape)
    Xs, Ys = _sharded(X, mesh, axes), _sharded(Y, mesh, axes)
    xs, counts = _valid_views(Xs, n_true)
    live = [i for i, c in enumerate(counts) if c]
    owners = mesh.axis_devices(model_ax) if model_ax in mesh.shape else [Xs.device]
    dev = Xs.device
    W, M, ymean = _block_bcd_sweep(
        [xs[i] for i in live], [Ys.shards[i][:counts[i]] for i in live],
        as_tensor(Wrf, dev), as_tensor(brf, dev), n=sum(counts), block_size=block_size,
        lam=float(lam), num_iter=num_iter, feat_dtype=feat_dtype, center=center,
        solve_device=lambda b: owners[b // nb_local])
    if center:
        return W, M, ymean
    return W
