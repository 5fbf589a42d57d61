"""L-BFGS ridge least-squares solvers: dense, sparse gather and sparse gram.

Port of ``keystone_tpu/ops/learning/lbfgs.py``, one device (reference:
nodes/learning/LBFGS.scala:14-281 and Gradient.scala:10-123; loss =
½‖XW − Y‖²/n + ½λ‖W‖²).

The objective is the ridge quadratic, so no line search is needed: the
step along the two-loop L-BFGS direction is exact, ``α = −gᵀp / pᵀHp``,
with one Hessian apply ``Hp`` an iteration, and the gradient updates
incrementally (``g += α·Hp``). The engines differ only in the Hessian
apply:

  - dense: ``Aᵀ(A P)/n + λP`` (two products);
  - sparse gather: the same through ``sparse_matmul`` / ``sparse_matmul_t``,
    one gather and one segment-sum pass over the COO an iteration;
  - sparse gram: ``G P/n + λP`` on G = AᵀA folded once over densified row
    chunks (``ops/sparse.py::sparse_gram_fold``, which runs every chunk
    through the hand-written ``gram_corr_sym_acc`` kernel on the card).

The reference runs the loop as one compiled ``while_loop``; here it is a
host loop whose stop test (``count < iterations and ‖g‖ > tol``) reads the
gradient norm once an iteration. The masked circular history and the
``ys > 0`` guard are kept as written, so the iterates match the
reference's to rounding.

``run_lbfgs_gram_streamed`` also folds from disk: a ``segment_source``
(``DiskCOOShards``, its prefetchable ``COOShardSource`` form, or a
callable) delivers one segment of chunks at a time, prefetched on the
data-plane runtime's read lane and copied to the card from page-locked
memory on a side stream, and a segmented fold snapshots its carry under a
``CheckpointSpec`` (or ``KEYSTONE_CHECKPOINT_DIR``) and resumes with the
uninterrupted fold's bits.

``run_lbfgs_gram_streamed(mesh=)`` partitions the chunk stream over a
one-host mesh's axis (``parallel/mesh.py``): each device folds its own
contiguous chunks into its own carry through ``gram_corr_sym_acc``, and one
``psum`` of the carries a fit, in shard order, precedes the solve.

Waiting in ROADMAP: the hybrid resident + streamed tail
(``run_lbfgs_gram_hybrid``, A.7). ``cost`` and ``resident_bytes`` price with
the gather overhead of the weight family active at construction
(``cost.py``; EC2 by default, 8.0); the calibration plane refits it from
fits timed on the card (``scripts/torch_fit_cost_weights.py``).
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch import obs, resolve_device
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.cost import CostModel, sparse_gather_overhead
from keystone_tpu_torch.ops.learning.linear import LinearMapper, SparseLinearMapper
from keystone_tpu_torch.ops.sparse import (
    _coo,
    gram_finalize,
    is_sparse_dataset,
    sparse_gram_fold,
    sparse_gram_init,
    sparse_matmul,
    sparse_matmul_t,
)
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.workflow import LabelEstimator
from keystone_tpu_torch.workflow.fusion import DeviceFit, masked_center

logger = logging.getLogger("keystone_tpu_torch.lbfgs")

_LBFGS_HISTORY = 10  # standard L-BFGS memory

def _matmul(X, P):
    """X @ P where X is a dense tensor or a padded-COO dict (never densified)."""
    if isinstance(X, dict):
        return sparse_matmul(X["indices"], X["values"], P)
    return X @ P


def _rmatmul(X, V, d: int):
    """Xᵀ @ V for dense or padded-COO X."""
    if isinstance(X, dict):
        return sparse_matmul_t(X["indices"], X["values"], V, d)
    return X.T @ V


def least_squares_loss(W, X, Y, lam: float, n: int):
    """½‖XW − Y‖²/n + ½λ‖W‖² (LBFGS.scala:105-119). Padding rows of X and Y
    are zero and contribute nothing; only the divisor uses the true n."""
    residual = _matmul(X, W) - Y
    return 0.5 * (residual * residual).sum() / n + 0.5 * lam * (W * W).sum()


def run_lbfgs(
    X,
    Y,
    lam: float = 0.0,
    num_iterations: int = 100,
    convergence_tol: float = 1e-4,
    n: Optional[int] = None,
    W_init=None,
):
    """Minimize the ridge least-squares loss with L-BFGS.

    X: (n_pad, d) features — a dense tensor or a padded-COO dict
    ``{"indices", "values"}`` (sparse input needs ``W_init``, whose row
    count fixes d), in which case every data pass is a gather and a
    segment sum and the dense design matrix never exists. Y: (n_pad, k).
    Computes in the common dtype of the features and labels, on the
    features' device. Returns W (d, k).
    """
    if isinstance(X, dict):
        values = as_tensor(X["values"])
        indices = as_tensor(X["indices"], values.device)
        Y = as_tensor(Y, values.device)
        dtype = torch.promote_types(values.dtype, Y.dtype)
        X = {"indices": indices, "values": values.to(dtype)}
        n_rows = indices.shape[0]
        if W_init is None:
            raise ValueError(
                "sparse run_lbfgs needs W_init (or use SparseLBFGSwithL2, "
                "which sizes the model from num_features)"
            )
    else:
        X = as_tensor(X)
        Y = as_tensor(Y, X.device)
        dtype = torch.promote_types(X.dtype, Y.dtype)
        X = X.to(dtype)
        n_rows = X.shape[0]
    Y = Y.to(dtype)
    n = n or n_rows
    device = Y.device
    W0 = (
        as_tensor(W_init, device).to(dtype)
        if W_init is not None
        else torch.zeros((X.shape[1], Y.shape[1]), dtype=dtype, device=device)
    )
    W, final_loss = _lbfgs_body(X, Y, W0, lam, num_iterations, convergence_tol, n)
    logger.info("LBFGS final loss: %s", float(final_loss))
    return W


def _lbfgs_quad_loop(hvp, AtB, W0, num_iterations: int, tol: float):
    """The L-BFGS loop on the ridge quadratic, generic over the Hessian
    apply: ``hvp`` may be the data-pass form Aᵀ(A·)/n + λ· or the Gramian
    form G·/n + λ· — the same operator, so the iterates coincide up to
    summation order. The history is circular: pair i of the last
    ``min(count, history)`` lives in slot ``(count − 1 − i) mod history``;
    slots past the valid pairs hold zeros and contribute exactly nothing."""
    history = _LBFGS_HISTORY
    dtype, device = W0.dtype, W0.device
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    # The stop test compares in the loop's dtype, as the reference's
    # traced tolerance does.
    tol = float(torch.tensor(tol, dtype=dtype))

    def vdot(a, b):
        return (a * b).sum()

    def direction(grad, S, Yh, rho, count):
        """Two-loop recursion over the circular (history, d, k) buffers."""
        m = min(count, history)
        q = grad
        alphas = []
        for i in range(m):  # newest -> oldest
            slot = (count - 1 - i) % history
            a = rho[slot] * vdot(S[slot], q)
            q = q - a * Yh[slot]
            alphas.append(a)
        last = (count - 1) % history
        ys = vdot(S[last], Yh[last])
        yy = vdot(Yh[last], Yh[last])
        # Guard on ys > 0 (not just count): a degenerate zero pair stored
        # after an alpha = 0 step falls back to the steepest-descent scaling
        # instead of zeroing the direction forever.
        gamma = torch.where(ys > 0, ys / torch.clamp_min(yy, 1e-30), one)
        r = gamma * q
        for i in reversed(range(m)):  # oldest -> newest
            slot = (count - 1 - i) % history
            beta = rho[slot] * vdot(Yh[slot], r)
            r = r + (alphas[i] - beta) * S[slot]
        return -r

    d, k = W0.shape
    W = W0
    grad = hvp(W0) - AtB
    S = torch.zeros((history, d, k), dtype=dtype, device=device)
    Yh = torch.zeros((history, d, k), dtype=dtype, device=device)
    rho = torch.zeros((history,), dtype=dtype, device=device)
    count = 0
    gnorm = torch.linalg.norm(grad)
    # The span records the iterations the stop test let run (the loop reads
    # the gradient norm each iteration, so its wall is the device's too).
    with obs.span("lbfgs.solve", d=int(d), k=int(k)) as span:
        while count < num_iterations and float(gnorm) > tol:
            p = direction(grad, S, Yh, rho, count)
            Hp = hvp(p)
            denom = vdot(p, Hp)
            alpha = torch.where(denom > 0, -vdot(grad, p) / denom, zero)
            s = alpha * p
            y = alpha * Hp  # grad(W + s) − grad(W) for the quadratic
            W = W + s
            grad = grad + y
            slot = count % history
            sy = vdot(s, y)
            S[slot] = s
            Yh[slot] = y
            rho[slot] = torch.where(sy > 0, 1.0 / sy, zero)
            count += 1
            gnorm = torch.linalg.norm(grad)
        span.set(iterations=count)
    return W


def _lbfgs_body(X, Y, W0, lam, num_iterations, tol, n):
    """L-BFGS fit on the data: one Hessian apply is a pass over X (for
    padded-COO X a gather pass and a segment-sum pass). Returns (W, loss)."""
    d = W0.shape[0]

    def hvp(P):
        return _rmatmul(X, _matmul(X, P), d) / n + lam * P

    AtB = _rmatmul(X, Y, d) / n  # constant term of the gradient
    W = _lbfgs_quad_loop(hvp, AtB, W0, num_iterations, tol)
    return W, least_squares_loss(W, X, Y, lam, n)


def _lbfgs_gram_core(G, AtY, yty, W0, lam, num_iterations, tol, n):
    """L-BFGS on the accumulated normal equations: hvp = G·/n + λ·, the
    same operator as the data-pass form, at one (d, d) × (d, k) product an
    iteration. The loss ½‖AW − Y‖²/n + ½λ‖W‖² comes from G, AtY and yty,
    with no data pass."""

    def hvp(P):
        return G @ P / n + lam * P

    W = _lbfgs_quad_loop(hvp, AtY / n, W0, num_iterations, tol)
    data_loss = 0.5 * ((W * (G @ W)).sum() - 2.0 * (W * AtY).sum() + yty) / n
    return W, data_loss + 0.5 * lam * (W * W).sum()


class DenseLBFGSwithL2(LabelEstimator, CostModel):
    """Dense-input L-BFGS ridge solver with mean-centering intercepts
    (reference: LBFGS.scala:135-192)."""

    def __init__(self, lam: float = 0.0, num_iterations: int = 100,
                 convergence_tol: float = 1e-4):
        self.lam = lam
        self.num_iterations = num_iterations
        self.convergence_tol = convergence_tol

    @property
    def weight(self) -> int:
        return self.num_iterations + 1

    def device_fit_fn(self):
        """Fit-fusion contract (workflow/fusion.py): mean-centering + the
        L-BFGS loop on the featurized tensor, so upstream featurization
        runs straight into the fit."""

        def fit_fn(F, Y, n_true: int):
            Fc, Yc, fmean, ymean = masked_center(F, Y, n_true)
            dtype = torch.promote_types(Fc.dtype, Yc.dtype)
            W0 = torch.zeros((Fc.shape[1], Yc.shape[1]), dtype=dtype, device=Fc.device)
            W, _ = _lbfgs_body(Fc.to(dtype), Yc.to(dtype), W0, self.lam,
                               self.num_iterations, self.convergence_tol, n_true)
            return W, fmean, ymean

        def build(params):
            W, fmean, ymean = params
            return LinearMapper(W, b_opt=ymean, feature_scaler=StandardScalerModel(fmean))

        return DeviceFit(fit_fn, build)

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        feature_scaler = StandardScaler(normalize_std_dev=False).fit(data)
        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels)
        A = as_tensor(feature_scaler.batch_apply(data).array)
        B = as_tensor(label_scaler.batch_apply(labels).array, A.device)
        W = run_lbfgs(A, B, lam=self.lam, num_iterations=self.num_iterations,
                      convergence_tol=self.convergence_tol, n=data.n)
        return LinearMapper(W, b_opt=label_scaler.mean, feature_scaler=feature_scaler)

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight) -> float:
        """Analytic cost model (LBFGS.scala:175-191)."""
        flops = n * d * k / num_machines
        bytes_scanned = n * d / num_machines
        network = 2.0 * d * k * math.log2(max(num_machines, 2))
        return self.num_iterations * (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model: the dense matrix plus its centered copy (f32),
        labels twice, and the L-BFGS history pairs (2 x history x d x k)."""
        return (
            8.0 * n * d / num_machines
            + 8.0 * n * k / num_machines
            + 8.0 * _LBFGS_HISTORY * d * k
        )


def _resident_chunk_fn(cid, idx_t, val_t, Y_t):
    """Chunk source slicing pre-tiled resident buffers."""
    return idx_t[cid], val_t[cid], Y_t[cid]


def run_lbfgs_gram_streamed(
    chunk_fn,
    num_chunks: int,
    d: int,
    k: int,
    lam: float = 0.0,
    num_iterations: int = 100,
    convergence_tol: float = 1e-4,
    n: Optional[int] = None,
    val_dtype=torch.float32,
    operands=(),
    max_chunks_per_dispatch: Optional[int] = None,
    segment_source=None,
    inflight: int = 2,
    prefetch_depth: int = 2,
    pipeline: bool = True,
    prefetch_stats=None,
    checkpoint=None,
    mesh=None,
    mesh_axis: Optional[str] = None,
    device=None,
):
    """Streamed sparse ridge fit: fold G = AᵀA over COO chunks once
    (``sparse.sparse_gram_fold``; chunks may be sliced from resident tiles,
    regenerated or loaded from disk, so the full dataset need never exist on
    the device), then run the same L-BFGS iterates as the gather engine
    against G. Returns (W (d, k), final_loss).

    ``chunk_fn(cid, *operands)`` returns ``(indices, values, Y)`` of chunk
    ``cid``. ``val_dtype`` is the densified slab's dtype (float32 or
    bfloat16). ``pipeline``: densify chunk i+1 before folding chunk i (two
    slabs resident) or one chunk at a time.

    ``max_chunks_per_dispatch``: fold in segments of that many chunk ids;
    ids past ``num_chunks`` in the last, ragged segment are folded with
    zero values and labels and so contribute exactly zero: the segmented
    result has the bits of the single one. ``chunk_fn`` must accept those
    ids.

    ``segment_source``: the disk tier, where neither the device nor host
    RAM holds the dataset, only a segment of chunks at a time. Accepts a
    :class:`~keystone_tpu_torch.data.shards.DiskCOOShards` or its
    prefetchable ``as_source(chunks_per_segment)`` form (segment k+1 is
    read on a background thread while segment k is copied and folded;
    ``prefetch_depth`` bounds the staged host buffers, 0 reads serially
    with the same bits), or a callable ``segment_source(cid0, seg) ->
    (idx_t, val_t, Y_t)`` (loaded serially). ``chunk_fn`` then receives
    segment-relative ids, and liveness is decided by the absolute id.
    ``max_chunks_per_dispatch`` defaults from a source's
    ``chunks_per_segment``. ``device``: where a segment source's chunks
    are folded (None: the default device); ``inflight``: segments the host
    may run ahead of the card; ``prefetch_stats``: a
    :class:`~keystone_tpu_torch.data.prefetch.PrefetchStats` to fill.

    ``checkpoint``: a :class:`~keystone_tpu_torch.data.durable.
    CheckpointSpec` (or directory; None consults
    ``KEYSTONE_CHECKPOINT_DIR``) snapshotting the (G, AtY, yty) carry and
    the segment cursor every ``every_segments`` segments. A fit killed
    mid-stream and re-run with the same spec resumes with the
    uninterrupted fit's bits. It needs a segmented fit: an explicit
    checkpoint with the whole fold in one pass raises; the variable is
    ignored there, as in the reference.

    ``mesh``: a :class:`~keystone_tpu_torch.parallel.mesh.Mesh`. The chunk
    stream partitions contiguously over ``mesh_axis`` (default ``data``):
    device j folds chunks ``[j·cpd, (j+1)·cpd)`` (``cpd = ceil(num_chunks
    / m)``) into its own (G, AtY, yty) carry with no collective, and one
    ``psum`` of the carries a fit, in device order on the axis's first
    device, precedes the solve. Resident ``operands`` are split over
    their leading chunk axis, each device's part on its device; a
    ``segment_source`` must then be a sequence of per-device sources whose
    segment ``s`` carries device j's segment-relative chunks, read on
    per-device ``read.d<j>`` lanes (``data/prefetch.py::
    iter_mesh_segments``). ``chunk_fn`` receives device-local (resident)
    or segment-relative (streamed) ids. ``checkpoint=`` raises on the mesh
    path, as in the reference.
    """
    from keystone_tpu_torch.data.durable import (
        fingerprint_token,
        resolve_checkpoint,
        source_fingerprint,
    )
    from keystone_tpu_torch.data.prefetch import (
        COOShardSource,
        is_shard_source,
        iter_segments,
        stage_segment,
        to_device_segment,
    )

    if n is None:
        raise ValueError("streamed fit needs the true row count n")
    if mesh is not None:
        if checkpoint is not None:
            raise ValueError(
                "mesh-sharded streamed fits do not checkpoint yet: the carry is a "
                "per-device partial on every device (a snapshot would need a "
                "gather); drop checkpoint= or mesh="
            )
        return _run_lbfgs_gram_streamed_mesh(
            chunk_fn, int(num_chunks), int(d), int(k), mesh, mesh_axis=mesh_axis, lam=lam,
            num_iterations=num_iterations, convergence_tol=convergence_tol, n=n,
            val_dtype=val_dtype, operands=operands,
            max_chunks_per_dispatch=max_chunks_per_dispatch,
            segment_sources=segment_source, inflight=inflight,
            prefetch_depth=prefetch_depth, prefetch_stats=prefetch_stats,
        )
    explicit_checkpoint = checkpoint is not None
    checkpoint = resolve_checkpoint(checkpoint)
    num_chunks, seg = int(num_chunks), max_chunks_per_dispatch
    source = None
    if segment_source is not None and not callable(segment_source):
        if is_shard_source(segment_source):
            source = segment_source
        elif hasattr(segment_source, "segment_source"):
            # A DiskCOOShards-like object: group its chunks into segments.
            source = COOShardSource(segment_source, seg if seg else min(num_chunks, 8))
        else:
            raise TypeError(
                "segment_source must be callable, a ShardSource, or have "
                f".segment_source; got {type(segment_source).__name__}"
            )
        if seg is None:
            seg = source.chunks_per_segment
        elif seg != source.chunks_per_segment:
            raise ValueError(
                f"max_chunks_per_dispatch {seg} != the source's chunks_per_segment "
                f"{source.chunks_per_segment}"
            )
    if segment_source is None and (seg is None or seg >= num_chunks):
        if explicit_checkpoint:
            raise ValueError(
                "checkpointing needs a segmented fit: pass max_chunks_per_dispatch "
                "(or a segment_source) so there are fold boundaries to snapshot at"
            )

        def live_chunk(cid):
            return chunk_fn(cid, *operands)

        carry = sparse_gram_fold(None, range(num_chunks), live_chunk, d, k,
                                 val_dtype=val_dtype, pipeline=pipeline)
        return _gram_solve(carry, d, k, lam, num_iterations, convergence_tol, n)
    if seg is None:
        raise ValueError("segment_source requires max_chunks_per_dispatch")
    seg = int(seg)
    num_segs = -(-num_chunks // seg)

    if segment_source is not None:
        device = resolve_device(device)
        copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    carry = None
    start_seg = 0
    fingerprint = None
    if checkpoint is not None:
        # Geometry, fold identity (chunk_fn, dtype and engine flags,
        # operand shapes) and source identity: a stale snapshot from a
        # different chunk source never seeds this fold. Resident operands
        # are fingerprinted by shape and dtype only; disk sources carry a
        # free content digest through their recorded checksums.
        fingerprint = {
            "kind": "coo_gram_segments", "num_chunks": num_chunks,
            "d": int(d), "k": int(k), "seg": seg, "n": int(n),
            "val_dtype": str(val_dtype).replace("torch.", ""),
            "pipeline": bool(pipeline),
            "chunk_fn": fingerprint_token(chunk_fn),
            "operands": [
                {"shape": [int(v) for v in getattr(o, "shape", ())],
                 "dtype": str(getattr(o, "dtype", "?")).replace("torch.", "")}
                for o in operands
            ],
            "source": source_fingerprint(source if source is not None else segment_source),
        }
        arrays, start_seg = checkpoint.restore(fingerprint)
        if arrays is not None:
            if segment_source is None:
                # Where the resident chunks lie: the operands', or else
                # (chunks made by chunk_fn) the first chunk's.
                tensors = [o for o in operands if isinstance(o, torch.Tensor)]
                device = tensors[0].device if tensors else chunk_fn(0, *operands)[1].device
            carry = tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)
    in_flight: deque = deque()

    def fold_segment(s, cid0, chunk_at):
        """Fold chunk ids [cid0, cid0 + seg); ``chunk_at(rel)`` gives chunk
        cid0 + rel, and ids past the end fold zeros."""
        nonlocal carry
        t0 = time.perf_counter()
        with obs.span("fold.segment", segment=int(s)) as span:
            def chunk(rel):
                indices, values, Yc = chunk_at(rel)
                if cid0 + rel >= num_chunks:
                    return indices, torch.zeros_like(values), torch.zeros_like(Yc)
                return indices, values, Yc

            carry = sparse_gram_fold(carry, range(seg), chunk, d, k,
                                     val_dtype=val_dtype, pipeline=pipeline)
            if carry[0].is_cuda:
                # The span closes when the launches are queued, not done
                # (obs/calibrate.py keeps such rows out of the refit).
                span.set(queued=True)
            if segment_source is not None and carry[0].is_cuda:
                # At most `inflight` segments queued ahead of the card.
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > max(int(inflight), 1):
                    in_flight.popleft().synchronize()
        if prefetch_stats is not None:
            prefetch_stats.add_busy("compute", time.perf_counter() - t0)
        if checkpoint is not None:
            checkpoint.maybe_save(carry, s, num_segs, fingerprint, stats=prefetch_stats)

    def stage(payload):
        return stage_segment(payload, device)

    if source is not None:
        for s, staged in iter_segments(source, prefetch_depth=prefetch_depth,
                                       stats=prefetch_stats, start=start_seg, stage=stage):
            ops = to_device_segment(staged, device, copy_stream)
            fold_segment(s, s * seg, lambda rel, ops=ops: chunk_fn(rel, *ops))
    else:
        for s in range(start_seg, num_segs):
            cid0 = s * seg
            if segment_source is not None:
                ops = to_device_segment(stage(segment_source(cid0, seg)), device, copy_stream)
                fold_segment(s, cid0, lambda rel, ops=ops: chunk_fn(rel, *ops))
            else:
                fold_segment(s, cid0, lambda rel, c0=cid0: chunk_fn(c0 + rel, *operands))
    result = _gram_solve(carry, d, k, lam, num_iterations, convergence_tol, n)
    if checkpoint is not None:
        checkpoint.clear(fingerprint)  # this fit's snapshot only
    return result


def _mesh_fold_axis(mesh, mesh_axis: Optional[str]) -> str:
    """Resolve (and validate) the fold's data-parallel mesh axis."""
    from keystone_tpu_torch.parallel import mesh as mesh_lib

    axis = mesh_axis or mesh_lib.DATA_AXIS
    if axis not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no {axis!r} axis to shard the chunk stream over"
        )
    return axis


def _mesh_gram_init(d: int, k: int, mesh, axis: str):
    """Zero (G_raw, AtY, yty) carries, one on each device of ``axis``."""
    return [sparse_gram_init(d, k, device=dev) for dev in mesh.axis_devices(axis)]


def _gram_fold_program_mesh(chunk_fn, num_chunks: int, d: int, k: int, seg: int,
                            val_dtype, pipeline: bool, mesh, axis: str,
                            segment_relative: bool):
    """Mesh segment fold: each device folds ``seg`` chunk ids of its
    contiguous shard (local ids ``[cid0, cid0 + seg)``, global chunk
    ``j·cpd + local``) into its own carry, through ``gram_corr_sym_acc``.
    No collective runs here: the one psum a fit is
    :func:`_gram_mesh_solve_program`'s. Ids past a device's shard, or past
    ``num_chunks``, fold zero values and labels, so no chunk is folded
    twice or skipped. ``segment_relative``: each device's operands hold
    only this segment's chunks (the streamed path); else its whole
    resident part, sliced by the local id."""
    m = int(mesh.shape[axis])
    cpd = -(-int(num_chunks) // m)

    def fold(carries, cid0: int, device_operands):
        out = []
        for j, (carry, ops) in enumerate(zip(carries, device_operands)):
            base = j * cpd

            def cf(loc, ops=ops, base=base):
                indices, values, Yc = chunk_fn(loc - cid0 if segment_relative else loc, *ops)
                if loc < cpd and base + loc < num_chunks:
                    return indices, values, Yc
                return indices, torch.zeros_like(values), torch.zeros_like(Yc)

            out.append(sparse_gram_fold(carry, range(cid0, cid0 + seg), cf, d, k,
                                        val_dtype=val_dtype, pipeline=pipeline))
        return out

    return fold


def _gram_mesh_solve_program(d: int, k: int, lam, num_iterations, convergence_tol, n,
                             mesh, axis: str):
    """The fit's one cross-device collective: a psum of the carries in
    device order on the axis's first device, then the solve: the
    one-device fold's iterates up to the reduction's reassociation."""
    from keystone_tpu_torch.parallel.mesh import psum

    dev = mesh.axis_devices(axis)[0]

    def run(carries):
        reduced = tuple(psum([c[i] for c in carries], dev) for i in range(3))
        return _gram_solve(reduced, d, k, lam, num_iterations, convergence_tol, n)

    return run


def _run_lbfgs_gram_streamed_mesh(
    chunk_fn, num_chunks, d, k, mesh, *, mesh_axis, lam, num_iterations,
    convergence_tol, n, val_dtype, operands, max_chunks_per_dispatch,
    segment_sources, inflight, prefetch_depth, prefetch_stats,
):
    """Mesh driver for :func:`run_lbfgs_gram_streamed`: one fold a local
    segment over every device's shard, at most ``inflight`` segments
    queued ahead of the cards, then one psum and the solve."""
    from keystone_tpu_torch.data.prefetch import (
        iter_mesh_segments,
        stage_segment,
        to_device_segment,
    )

    axis = _mesh_fold_axis(mesh, mesh_axis)
    m = int(mesh.shape[axis])
    devices = mesh.axis_devices(axis)
    cpd = -(-int(num_chunks) // m)
    dev_tag = f"{axis}[0-{m - 1}]"
    in_flight: deque = deque()

    def step(fold, carries, cid0, device_operands):
        t0 = time.perf_counter()
        # One fold covers every device's shard: the span carries the device
        # group's tag, as the reference's.
        with obs.span("fold.segment", chunk0=int(cid0), device=dev_tag,
                      num_devices=m) as span:
            carries = fold(carries, cid0, device_operands)
            if carries[0][0].is_cuda:
                span.set(queued=True)
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > max(int(inflight), 1):
                    in_flight.popleft().synchronize()
        if prefetch_stats is not None:
            prefetch_stats.add_busy("compute", time.perf_counter() - t0)
        return carries

    carries = _mesh_gram_init(d, k, mesh, axis)
    solve = _gram_mesh_solve_program(d, k, lam, num_iterations, convergence_tol, n, mesh, axis)

    if segment_sources is not None:
        seg = max_chunks_per_dispatch
        sources = list(segment_sources)
        if len(sources) != m:
            raise ValueError(
                f"mesh fold over {axis}={m} needs {m} per-device segment sources, "
                f"got {len(sources)}"
            )
        if seg is None:
            raise ValueError(
                "mesh segment sources need max_chunks_per_dispatch (the per-device "
                "chunks carried by one segment)"
            )
        fold = _gram_fold_program_mesh(chunk_fn, num_chunks, d, k, int(seg), val_dtype,
                                       int(seg) > 1, mesh, axis, True)
        stages = [lambda p, dev=dev: stage_segment(p, dev) for dev in devices]
        for s, payloads in iter_mesh_segments(sources, prefetch_depth=prefetch_depth,
                                              stats=prefetch_stats, stage=stages):
            ops = [to_device_segment(p, dev) for p, dev in zip(payloads, devices)]
            carries = step(fold, carries, s * int(seg), ops)
        return solve(carries)

    # Resident path: device j's part holds its contiguous chunks, padded
    # (indices -1, values and labels 0) to whole segments, on its device.
    seg = int(max_chunks_per_dispatch) if max_chunks_per_dispatch else cpd
    seg = max(min(seg, cpd), 1)
    local = -(-cpd // seg) * seg
    device_operands = []
    for j, dev in enumerate(devices):
        part = []
        for o in operands:
            o = as_tensor(o)
            piece = o[j * cpd:min((j + 1) * cpd, int(o.shape[0]))]
            pad = local - int(piece.shape[0])
            if pad:
                fill = -1 if not (piece.is_floating_point() or piece.is_complex()) else 0
                piece = torch.cat([piece, torch.full((pad,) + tuple(piece.shape[1:]), fill,
                                                     dtype=piece.dtype, device=piece.device)])
            part.append(piece.to(dev))
        device_operands.append(tuple(part))
    fold = _gram_fold_program_mesh(chunk_fn, num_chunks, d, k, seg, val_dtype, False,
                                   mesh, axis, False)
    for cid0 in range(0, cpd, seg):
        carries = step(fold, carries, cid0, device_operands)
    return solve(carries)


def _gram_solve(carry, d: int, k: int, lam, num_iterations, convergence_tol, n):
    """L-BFGS on the folded (G_raw, AtY, yty) carry: (W, final loss)."""
    G, AtY, yty = carry
    W0 = torch.zeros((d, k), dtype=torch.float32, device=G.device)
    return _lbfgs_gram_core(gram_finalize(G), AtY, yty, W0, lam, num_iterations,
                            convergence_tol, n)


# The most padded-COO lanes (rows x width) a gram-fit chunk holds: 2^28,
# about 3 GB of densify-sort temporaries. Rows up to 4,096 lanes wide keep
# the full gram_chunk_rows.
_GRAM_CHUNK_LANES = 1 << 28


class SparseLBFGSwithL2(LabelEstimator, CostModel):
    """Sparse-input L-BFGS ridge solver (reference: LBFGS.scala:208-281).

    Padded-COO input runs the whole optimization through the sparse
    substrate, never the dense design matrix. The reference's append-ones
    intercept is kept: every row gets one extra active lane at column d
    with value 1. Dense input takes the dense core.

    ``solver`` picks the iteration engine for sparse input:
      - "gather" (default, the reference-shaped path): every iteration is a
        gather + segment-sum data pass;
      - "gram": fold G = AᵀA once over densified row chunks of
        ``gram_chunk_rows`` (``sparse.sparse_gram_fold``, through the
        ``gram_corr_sym_acc`` kernel on the card), then the same iterates
        against G at one (d+1)² × (d+1, k) product an iteration.

    ``gram_dtype``: the densified slab's dtype — None follows the values
    (bf16 values fold in bf16), "f32" or "bf16" (the bench's engine:
    values quantized to bf16 inside the fold).

    ``compress="int16_bf16"`` (gram only) encodes the operands in the
    compressed-resident tier (``data/resident.py``, 4 bytes an nnz) before
    the fold; its decode is the fold's densify, and it gives the bits of
    ``gram_dtype="bf16"``. Every index, the intercept lane's d included,
    must fit int16: encode raises at the boundary rather than wrap.
    """

    # The reference's calibration of the gram engine against the gather
    # engine (fold + 20 iterations ≈ 4.5 gather iterations), kept so the
    # port's cost matches the reference's; the calibration plane's refit
    # does not fit it (ROADMAP A.17b).
    _GRAM_FOLD_ITER_EQUIV = 4.5

    def __init__(
        self,
        lam: float = 0.0,
        num_iterations: int = 100,
        convergence_tol: float = 1e-4,
        num_features: Optional[int] = None,
        solver: str = "gather",
        gram_chunk_rows: int = 65536,
        gram_dtype: Optional[str] = None,
        compress: Optional[str] = None,
    ):
        if solver not in ("gather", "gram"):
            raise ValueError(f'solver must be "gather" or "gram", got {solver!r}')
        if gram_dtype not in (None, "f32", "bf16"):
            raise ValueError(f'gram_dtype must be None, "f32" or "bf16", got {gram_dtype!r}')
        if compress not in (None, "int16_bf16"):
            raise ValueError(f'compress must be None or "int16_bf16", got {compress!r}')
        if compress is not None and solver != "gram":
            raise ValueError(
                'compress requires solver="gram" (the gather engine reads COO lanes '
                "directly and has no densify to fuse the decode into)"
            )
        if compress is not None and gram_dtype == "f32":
            raise ValueError(
                'compress="int16_bf16" stores bf16 values — an exact-f32 fold over '
                "them would pay full precision for already-quantized data; drop one "
                "of the two"
            )
        self.lam = lam
        self.num_iterations = num_iterations
        self.convergence_tol = convergence_tol
        self.num_features = num_features
        self.solver = solver
        self.compress = compress
        self.gram_chunk_rows = gram_chunk_rows
        self.gram_dtype = gram_dtype
        self._sparse_overhead = sparse_gather_overhead()

    @property
    def weight(self) -> int:
        return self.num_iterations + 1

    def fit(self, data: Dataset, labels: Dataset):
        if is_sparse_dataset(data):
            indices, values = _coo(data)
            B = as_tensor(labels.array, values.device)
            d = self.num_features or int(indices.max()) + 1
            npad = indices.shape[0]
            # Append-ones column at index d learns the intercept jointly
            # (LBFGS.scala:208-281); padding rows get an inactive (−1) lane.
            valid = torch.arange(npad, device=values.device) < data.n
            lane = torch.where(valid, d, -1).to(indices.dtype)
            idx1 = torch.cat([indices, lane[:, None]], dim=1)
            val1 = torch.cat([values, valid.to(values.dtype)[:, None]], dim=1)
            if self.solver == "gram":
                W1 = self._fit_gram(idx1, val1, B, d + 1, data.n)
            else:
                dtype = torch.promote_types(values.dtype, B.dtype)
                W1 = run_lbfgs(
                    {"indices": idx1, "values": val1}, B, lam=self.lam,
                    num_iterations=self.num_iterations,
                    convergence_tol=self.convergence_tol, n=data.n,
                    W_init=torch.zeros((d + 1, B.shape[1]), dtype=dtype, device=values.device),
                )
            return SparseLinearMapper(W1[:-1], b_opt=W1[-1])

        A = as_tensor(data.array)
        B = as_tensor(labels.array, A.device)
        ones = (torch.arange(A.shape[0], device=A.device) < data.n).to(A.dtype)[:, None]
        W1 = run_lbfgs(torch.cat([A, ones], dim=1), B, lam=self.lam,
                       num_iterations=self.num_iterations,
                       convergence_tol=self.convergence_tol, n=data.n)
        return LinearMapper(W1[:-1], b_opt=W1[-1])

    def _fit_gram(self, idx1, val1, B, d1: int, n: int):
        """Gram-engine fit over resident padded-COO tensors: tile the rows
        into chunks (the tail padded with inactive lanes), fold G once,
        iterate on it. With ``compress="int16_bf16"`` the tiles are the
        compressed-resident tier's."""
        from keystone_tpu_torch.data.resident import CompressedCOOChunks, raw_chunk_tiles

        # Wide rows (a dense matrix in padded-COO form: the selector's
        # Sparsify chains on dense features) take shorter chunks, so that a
        # chunk's densify sort stays near _GRAM_CHUNK_LANES lanes.
        c = min(self.gram_chunk_rows, idx1.shape[0],
                max(_GRAM_CHUNK_LANES // max(int(idx1.shape[1]), 1), 1))
        if self.compress == "int16_bf16":
            chunks = CompressedCOOChunks.encode(idx1, val1, B, chunk_rows=c, d=d1, n_true=n)
            operands = chunks.operands()
        else:
            operands = raw_chunk_tiles(idx1, val1, B, c)
        if self.gram_dtype == "f32":
            # Explicit f32 wins even over bf16 values: the slabs upcast
            # losslessly and the fold computes in f32.
            val_dtype = torch.float32
        elif self.compress is not None or self.gram_dtype == "bf16" or (
            val1.dtype == torch.bfloat16
        ):
            val_dtype = torch.bfloat16
        else:
            val_dtype = torch.float32
        W, final_loss = run_lbfgs_gram_streamed(
            _resident_chunk_fn, int(operands[0].shape[0]), d1, B.shape[1],
            lam=self.lam, num_iterations=self.num_iterations,
            convergence_tol=self.convergence_tol, n=n, val_dtype=val_dtype,
            operands=operands,
            # The operands already hold the whole dataset: a second slab
            # would be pure extra memory, with no regeneration to overlap.
            pipeline=False,
        )
        logger.info("LBFGS(gram) final loss: %s", float(final_loss))
        return W

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight, network_weight,
             sparse_overhead: Optional[float] = None) -> float:
        """Analytic cost model (LBFGS.scala:264-280). The gram engine is
        priced as an iteration-equivalent of the gather engine (fold once,
        then data-free iterations). ``sparse_overhead`` (the gather
        engine's random-access multiplier on the sequential mem rate)
        defaults to the reference's EC2 value."""
        if sparse_overhead is None:
            sparse_overhead = self._sparse_overhead
        flops = n * sparsity * d * k / num_machines
        bytes_scanned = n * d * sparsity / num_machines
        network = 2.0 * d * k * math.log2(max(num_machines, 2))
        per_iter = (
            sparse_overhead * max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )
        if self.solver == "gram":
            iters_equiv = min(self._GRAM_FOLD_ITER_EQUIV, self.num_iterations)
            return iters_equiv * per_iter + mem_weight * d * d / num_machines
        return self.num_iterations * per_iter

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model: padded-COO operand (int32 index + f32 value per
        stored cell, or the compressed tier's 4 B/nnz when ``compress`` is
        set, infeasible past the int16 boundary), labels, history pairs;
        the gram engine adds its d² f32 Gramian."""
        if self.compress is not None:
            from keystone_tpu_torch.data import resident as resident_mod

            # +1: the append-ones intercept lane lives at index d.
            if not resident_mod.compressible_dim(d + 1):
                return float("inf")
            bytes_per_nnz = resident_mod.COMPRESSED_BYTES_PER_NNZ
        else:
            bytes_per_nnz = 8.0
        coo = bytes_per_nnz * n * d * sparsity / num_machines
        gram = 4.0 * d * d if self.solver == "gram" else 0.0
        return coo + 4.0 * n * k / num_machines + 8.0 * _LBFGS_HISTORY * d * k + gram
