"""Randomized sketched least-squares engines: SRHT sketch-and-precondition
and the Iterative Hessian Sketch.

Port of ``keystone_tpu/ops/learning/sketch.py``, one device (PAPERS.md:
"Faster Least Squares Approximation", "Iterative Hessian Sketch in Input
Sparsity Time"). Both engines stream the same padded-COO chunk tiles the
gram fold consumes (``data.resident.raw_chunk_tiles`` /
:class:`~keystone_tpu_torch.data.resident.CompressedCOOChunks`):

- :class:`SketchedLeastSquares` — each chunk is densified, sign-flipped,
  mixed with a padded real FFT (``stats.srht_chunk_sketch``, cuFFT on the
  card) and row-sampled; the stacked samples are a block-diagonal SRHT of
  the row stream. One QR of the ridge-augmented sketch gives a
  preconditioner, then preconditioned CG iterates on the original operator
  (a gather and a segment-sum pass an iteration): the sketch buys
  conditioning, not the answer.
- :class:`IterativeHessianSketch` — each outer iteration draws a fresh
  CountSketch and makes one pass over the chunk tiles that folds the
  sketched rows ``S A`` (the hand-written ``cuda_ops.countsketch_scatter``
  kernel, accumulating in place) and the exact gradient operand ``AᵀA X``
  together, then takes the guarded Newton-sketch step
  ``X -= (SAᵀSA/n + λI)⁻¹ g``. A step that raises the exact gradient norm
  is rolled back and the fit stops. ``passes`` on the estimator records how
  many fold passes its last fit made, ``steps`` how many Newton steps its
  model kept (0 when the first step was rolled back: the zero model).

The reference's ``lax.scan`` folds are host loops here (the SRHT fold
writes each chunk's sample into a preallocated (nchunks·m_pc, d₁) sketch);
its ``fori_loop`` CG is a host loop of ``torch.where`` updates with no read
on the host. The reference's flattened-scatter fallback and its
``pallas_direct_ok`` guard have no counterpart: a CPU tensor takes the
kernel's plain version, a CUDA tensor launches the kernel or raises, and
the accumulator is (m, d₁) on both.

**Random draws.** The reference draws from ``jax.random``, whose Threefry
bits cannot be made without JAX. The port draws from a ``torch.Generator``
on the CPU seeded from ``seed`` and the step's place — (chunk) for SRHT,
(outer, chunk) for the sparse IHS fold, (outer) for the dense IHS — mixed
by numpy's ``SeedSequence``, then moves the draws to the data's device, so
a card run and a CPU run draw the same numbers. ``draws=`` replaces them:
a callable that returns the draws the reference makes at that step,
``draws(cid) -> (signs (c,), bins (m_pc,))`` for SRHT,
``draws(t, cid) -> (bucket (c,), sign (c,))`` for the sparse IHS and
``draws(t) -> (bucket (n_pad,), sign (n_pad,))`` for the dense IHS (tests
feed the reference's own through ``interop.numpy_draws``).

**Unordered sums.** On the card ``index_add_`` (the gradient operand's
scatter, the dense IHS's segment sum) adds in atomic order, so two card
fits of one seed agree to float reassociation, not bit for bit; the
CountSketch kernel and everything on the CPU are reproducible bit for bit.

``cost`` and ``resident_bytes`` price with the overheads of the weight
family active at construction (``cost.py``; EC2 by default: SRHT 10.0,
CountSketch 6.0, gather 8.0); ``cost.LeastSquaresEstimator`` offers these
engines under ``allow_approximate``.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.ops.learning.cost import (
    CostModel,
    countsketch_overhead,
    sparse_gather_overhead,
    srht_sketch_overhead,
)
from keystone_tpu_torch.ops.learning.linear import LinearMapper, SparseLinearMapper
from keystone_tpu_torch.ops.sparse import (
    _coo,
    _dense_rows,
    is_sparse_dataset,
    sparse_matmul,
    sparse_matmul_t,
)
from keystone_tpu_torch.ops.stats import padded_pow2, srht_chunk_sketch
from keystone_tpu_torch.workflow import LabelEstimator

logger = logging.getLogger("keystone_tpu_torch.sketch")

# Ridge floor added to sketched Gramians / preconditioners so lam=0
# problems still factor (matches linear.SketchedLeastSquaresEstimator).
_EPS = 1e-8



# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


def _generator(seed: int, *path: int) -> torch.Generator:
    """A CPU generator for the draws at ``path`` under ``seed``: the words
    are mixed by numpy's SeedSequence, as the reference folds them into its
    key, so each step's draws depend only on (seed, path)."""
    state = np.random.SeedSequence([int(seed), *(int(p) for p in path)]).generate_state(
        2, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def _rademacher(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 2, (n,), generator=gen).to(torch.float32).mul_(2.0).sub_(1.0)


def bucket_sign_draws(seed: int, path, rows: int, m: int):
    """The port's own CountSketch draws at ``path``: a bucket in [0, m) and
    a ±1 sign a row, on the CPU."""
    gen = _generator(seed, *path)
    return torch.randint(0, m, (rows,), generator=gen), _rademacher(rows, gen)


def _on(draw, device, dtype) -> torch.Tensor:
    return as_tensor(draw).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _densify(idx, val, d: int) -> torch.Tensor:
    """(c, w) padded-COO lanes -> (c, d) float32 slab; −1 / out-of-range
    lanes masked. Duplicates of a column within a row add in lane order
    and each column is written once (``ops/sparse.py::_dense_rows``), so
    the slab has the same bits on every run and device."""
    return _dense_rows(idx, val, d, torch.float32)


def _append_intercept(indices, values, n: int, d: int):
    """Append-ones intercept lane at column d (LBFGS.scala:208-281);
    padding rows get an inactive (−1) lane."""
    npad = indices.shape[0]
    valid = torch.arange(npad, device=values.device) < n
    lane = torch.where(valid, d, -1).to(device=indices.device, dtype=indices.dtype)
    idx1 = torch.cat([indices, lane[:, None]], dim=1)
    val1 = torch.cat([values, valid.to(values.dtype)[:, None]], dim=1)
    return idx1, val1


def _pcg(matvec, precond, b, iters: int, tol: float):
    """Preconditioned CG on ``matvec(x) = b``, all k right-hand sides at once
    (per-column alpha/beta). Columns freeze once their residual drops below
    ``tol * ||b||``; the remaining iterations are no-ops for them, so a
    converged column cannot divide by a vanishing curvature. A host loop of
    ``torch.where`` updates with no read on the host."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum(dim=0)
    bnorm = torch.sqrt((b * b).sum(dim=0))
    floor = tol * torch.clamp_min(bnorm, 1e-30)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(int(iters)):
        active = torch.sqrt((r * r).sum(dim=0)) > floor
        Hp = matvec(p)
        pHp = (p * Hp).sum(dim=0)
        alpha = torch.where(active, rz / torch.where(pHp == 0, 1.0, pHp), zero)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = (r * z).sum(dim=0)
        beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz), zero)
        p = torch.where(active, z + beta * p, p)
        rz = rz_new
    return x


def _chol_precond(R):
    """x -> R⁻¹ R⁻ᵀ x for upper-triangular R (two triangular solves): the
    SRHT preconditioner apply. It depends on R only through RᵀR, so R's
    row signs (LAPACK's and cuSOLVER's may differ) do not matter."""

    def apply(v):
        y = torch.linalg.solve_triangular(R.T, v, upper=False)
        return torch.linalg.solve_triangular(R, y, upper=True)

    return apply


def _labels(labels: Dataset, device) -> torch.Tensor:
    return as_tensor(labels.array, device).to(torch.float32)


def _dense_with_ones(data: Dataset):
    A = as_tensor(data.array).to(torch.float32)
    ones = (torch.arange(A.shape[0], device=A.device) < data.n).to(A.dtype)[:, None]
    return torch.cat([A, ones], dim=1)


class SketchedLeastSquares(LabelEstimator, CostModel):
    """SRHT sketch-and-precondition ridge solver (Drineas et al.).

    Streams the row chunks once to build the block-SRHT sketch ``S A``
    (sign-flip -> padded rfft along the row axis -> sample ``m/nchunks``
    frequency bins per chunk) plus ``AᵀB`` in the same loop, takes
    ``R = qr([SA/√n; √λ I])`` as a preconditioner for the ridge Hessian
    ``AᵀA/n + λI``, then runs preconditioned CG with one gather +
    segment-sum data pass per iteration.

    ``sketch_size`` is the total sketched row count ``m`` (default
    ``sketch_factor * (d+1)``). ``draws``: see the module docstring.
    """

    def __init__(
        self,
        lam: float = 0.0,
        sketch_size: Optional[int] = None,
        sketch_factor: int = 2,
        pcg_iters: int = 12,
        convergence_tol: float = 1e-6,
        seed: int = 0,
        chunk_rows: int = 8192,
        num_features: Optional[int] = None,
        draws: Optional[Callable] = None,
    ):
        self.lam = lam
        self.sketch_size = sketch_size
        self.sketch_factor = sketch_factor
        self.pcg_iters = pcg_iters
        self.convergence_tol = convergence_tol
        self.seed = seed
        self.chunk_rows = chunk_rows
        self.num_features = num_features
        self.draws = draws
        self._sketch_overhead = srht_sketch_overhead()
        self._gather_overhead = sparse_gather_overhead()

    @property
    def weight(self) -> int:
        return self.pcg_iters + 1

    def _resolve_m(self, d1: int) -> int:
        return int(self.sketch_size or self.sketch_factor * d1)

    def fit(self, data: Dataset, labels: Dataset):
        if is_sparse_dataset(data):
            indices, values = _coo(data)
            B = _labels(labels, values.device)
            d = self.num_features or int(indices.max()) + 1
            idx1, val1 = _append_intercept(indices, values, data.n, d)
            W1 = self._fit_sparse(idx1, val1, B, d + 1, data.n)
            return SparseLinearMapper(W1[:-1], b_opt=W1[-1])
        A1 = _dense_with_ones(data)
        W1 = self._fit_dense(A1, _labels(labels, A1.device), data.n)
        return LinearMapper(W1[:-1], b_opt=W1[-1])

    def _chunk_draws(self, cid: int, c: int, m_pc: int, half: int, device):
        if self.draws is not None:
            signs, bins = self.draws(cid)
        else:
            gen = _generator(self.seed, cid)
            signs = _rademacher(c, gen)
            bins = torch.randint(0, half, (m_pc,), generator=gen)
        return _on(signs, device, torch.float32), _on(bins, device, torch.int64)

    def _sketch_stream(self, chunk_fn, nchunks: int, c: int, d1: int, k: int, device):
        """One pass over the row chunks producing the stacked block-SRHT
        sketch (nchunks·m_pc, d1) and AᵀB — the only pass that densifies,
        one chunk slab at a time."""
        p = padded_pow2(c)
        m_pc = max(1, min(-(-self._resolve_m(d1) // nchunks), p // 2))
        # E[(Re F z)_k²] ≈ ‖z‖²/2 under random signs, so √(2/m_pc) makes
        # each chunk's sampled block an isometry in expectation.
        scale = math.sqrt(2.0 / m_pc)
        SA = torch.empty((nchunks * m_pc, d1), dtype=torch.float32, device=device)
        AtB = torch.zeros((d1, k), dtype=torch.float32, device=device)
        for cid in range(nchunks):
            dense, y = chunk_fn(cid)
            signs, bins = self._chunk_draws(cid, c, m_pc, p // 2, device)
            SA[cid * m_pc:(cid + 1) * m_pc] = srht_chunk_sketch(dense, signs, bins, scale)
            AtB += dense.T @ y.to(torch.float32)
            del dense
        return SA, AtB

    def _solve(self, SA, AtB, matvec, n: int, d1: int):
        """QR the (scaled, ridge-augmented) sketch, PCG on the original
        operator."""
        ridge = math.sqrt(self.lam + _EPS)
        M = torch.cat([SA / math.sqrt(n),
                       ridge * torch.eye(d1, dtype=SA.dtype, device=SA.device)])
        R = torch.linalg.qr(M, mode="r").R
        del M  # 3.2 GB at the Amazon row, not needed by the CG
        return _pcg(matvec, _chol_precond(R), AtB / n, iters=self.pcg_iters,
                    tol=self.convergence_tol)

    def _fit_sparse(self, idx1, val1, B, d1: int, n: int):
        from keystone_tpu_torch.data.resident import raw_chunk_tiles

        c = min(self.chunk_rows, idx1.shape[0])
        idx_t, val_t, Y_t = raw_chunk_tiles(idx1, val1, B, c)
        SA, AtB = self._sketch_stream(
            lambda cid: (_densify(idx_t[cid], val_t[cid], d1), Y_t[cid]),
            int(idx_t.shape[0]), c, d1, B.shape[1], B.device,
        )
        del idx_t, val_t, Y_t

        def matvec(V):
            rows = sparse_matmul(idx1, val1, V)
            return sparse_matmul_t(idx1, val1, rows, d1) / n + self.lam * V

        return self._solve(SA, AtB, matvec, n, d1)

    def _fit_dense(self, A1, B, n: int):
        npad, d1 = A1.shape
        c = min(self.chunk_rows, npad)
        nchunks = -(-npad // c)

        def chunk(cid):
            # The ragged last chunk pads with zero rows, as the reference's
            # tiles do.
            A_c, Y_c = A1[cid * c:(cid + 1) * c], B[cid * c:(cid + 1) * c]
            pad = c - A_c.shape[0]
            if pad:
                A_c = torch.cat([A_c, A_c.new_zeros((pad, d1))])
                Y_c = torch.cat([Y_c, Y_c.new_zeros((pad, Y_c.shape[1]))])
            return A_c, Y_c

        SA, AtB = self._sketch_stream(chunk, nchunks, c, d1, B.shape[1], A1.device)

        def matvec(V):
            return A1.T @ (A1 @ V) / n + self.lam * V

        return self._solve(SA, AtB, matvec, n, d1)

    def cost(
        self, n, d, k, sparsity, num_machines,
        cpu_weight, mem_weight, network_weight,
        sketch_overhead: Optional[float] = None,
        gather_overhead: Optional[float] = None,
    ) -> float:
        """One sketch pass (densify scatter at the SRHT random-write rate
        plus the bandwidth-bound FFT mixing passes), one QR of the (m, d)
        sketch, then ``pcg_iters`` gather-engine data passes."""
        if sketch_overhead is None:
            sketch_overhead = self._sketch_overhead
        if gather_overhead is None:
            gather_overhead = self._gather_overhead
        m = self._resolve_m(int(d) + 1)
        nnz = n * sparsity * d
        sketch = (
            sketch_overhead * mem_weight * nnz
            + mem_weight * 3.0 * n * d
        ) / num_machines
        qr = cpu_weight * 2.0 * m * d * d / num_machines
        per_pass = (
            gather_overhead
            * max(cpu_weight * nnz * k, mem_weight * nnz) / num_machines
        )
        network = (
            network_weight * 2.0 * d * k
            * math.log2(max(num_machines, 2)) * self.pcg_iters
        )
        return sketch + qr + self.pcg_iters * per_pass + network

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Padded-COO operands, the stacked sketch + its QR workspace, one
        densified chunk slab (transient but live at peak), labels."""
        m = self._resolve_m(int(d) + 1)
        slab = 4.0 * min(self.chunk_rows, n) * d
        return (
            8.0 * n * d * sparsity / num_machines
            + 4.0 * n * k / num_machines
            + 8.0 * m * d
            + slab
        )


class IterativeHessianSketch(LabelEstimator, CostModel):
    """Iterative Hessian Sketch in input-sparsity time (Pilanci &
    Wainwright; CountSketch per Clarkson & Woodruff).

    Each outer iteration draws a fresh CountSketch (one bucket and one sign
    a row) and makes one O(nnz) pass over the COO chunk tiles that folds
    both the sketched rows ``S A`` (``cuda_ops.countsketch_scatter``, into
    one (m, d₁) accumulator in place) and the exact-gradient operand
    ``AᵀA X`` — no densified slab ever exists. The step solves the sketched
    normal equations ``(SAᵀSA/n + λI) Δ = −g`` by Cholesky and is guarded:
    a step is kept only while the exact gradient norm still shrinks (one
    read on the host an outer iteration), so a too-small sketch degrades
    to fewer accepted steps, never divergence. ``passes`` holds the number
    of fold passes of the last fit and ``steps`` the number of steps its
    model kept.

    ``compress="int16_bf16"`` folds over the compressed-resident tier
    (``data/resident.py``, 4 B/nnz); each chunk is cast back to int32 and
    float32 before the kernel.
    """

    def __init__(
        self,
        lam: float = 0.0,
        sketch_size: Optional[int] = None,
        sketch_factor: int = 4,
        outer_iters: int = 3,
        seed: int = 0,
        chunk_rows: int = 65536,
        num_features: Optional[int] = None,
        compress: Optional[str] = None,
        draws: Optional[Callable] = None,
    ):
        if compress not in (None, "int16_bf16"):
            raise ValueError(
                f'compress must be None or "int16_bf16", got {compress!r}'
            )
        self.lam = lam
        self.sketch_size = sketch_size
        self.sketch_factor = sketch_factor
        self.outer_iters = outer_iters
        self.seed = seed
        self.chunk_rows = chunk_rows
        self.num_features = num_features
        self.compress = compress
        self.draws = draws
        self.passes = 0
        self.steps = 0
        self._cs_overhead = countsketch_overhead()
        self._gather_overhead = sparse_gather_overhead()

    @property
    def weight(self) -> int:
        return self.outer_iters + 1

    def _resolve_m(self, d1: int) -> int:
        return int(self.sketch_size or self.sketch_factor * d1)

    def fit(self, data: Dataset, labels: Dataset):
        if is_sparse_dataset(data):
            indices, values = _coo(data)
            B = _labels(labels, values.device)
            d = self.num_features or int(indices.max()) + 1
            idx1, val1 = _append_intercept(indices, values, data.n, d)
            W1 = self._fit_sparse(idx1, val1, B, d + 1, data.n)
            return SparseLinearMapper(W1[:-1], b_opt=W1[-1])
        A1 = _dense_with_ones(data)
        W1 = self._fit_dense(A1, _labels(labels, A1.device), data.n)
        return LinearMapper(W1[:-1], b_opt=W1[-1])

    def _draw(self, path, rows: int, m: int, device):
        if self.draws is not None:
            bucket, sign = self.draws(*path)
        else:
            bucket, sign = bucket_sign_draws(self.seed, path, rows, m)
        return _on(bucket, device, torch.int64), _on(sign, device, torch.float32)

    def _guarded_newton(self, fold, AtB, n: int, d1: int):
        """The outer loop shared by the sparse and dense fits: ``fold(X, t)``
        returns (SA, AᵀA X); the exact gradient's norm guards each step."""
        k = AtB.shape[1]
        X = torch.zeros((d1, k), dtype=torch.float32, device=AtB.device)
        X_prev, prev_gnorm = X, None
        self.passes = self.steps = 0
        for t in range(self.outer_iters):
            SA, AtAX = fold(X, t)
            self.passes += 1
            g = AtAX / n - AtB / n + self.lam * X
            del AtAX
            gnorm = float(torch.linalg.norm(g))
            if prev_gnorm is not None and gnorm >= prev_gnorm:
                # Roll back the step that RAISED the exact gradient norm: a
                # rank-deficient sketch (m << d) can overshoot through the
                # sketched Hessian's null space, and the returned model must
                # never be worse than an iterate already held.
                logger.info(
                    "IHS guard: gradient norm %.3g >= %.3g at outer %d; "
                    "rolling back and stopping", gnorm, prev_gnorm, t,
                )
                X = X_prev
                self.steps -= 1
                break
            prev_gnorm = gnorm
            X_prev = X
            X = X - self._sketched_newton_step(SA, g, n, d1)
            self.steps += 1
            del SA
        logger.info("IHS: %d fold passes, %d Newton steps kept", self.passes, self.steps)
        return X

    def _fit_sparse(self, idx1, val1, B, d1: int, n: int):
        from keystone_tpu_torch.data.resident import CompressedCOOChunks, raw_chunk_tiles

        c = min(self.chunk_rows, idx1.shape[0])
        if self.compress == "int16_bf16":
            idx_t, val_t, _ = CompressedCOOChunks.encode(
                idx1, val1, B, chunk_rows=c, d=d1, n_true=n).operands()
        else:
            idx_t, val_t, _ = raw_chunk_tiles(idx1, val1, B, c)
        nchunks = int(idx_t.shape[0])
        m = self._resolve_m(d1)
        AtB = sparse_matmul_t(idx1, val1, B, d1)
        device = B.device

        def fold(X, t):
            """One streamed pass: the CountSketch fold and AᵀA X, together."""
            SA = torch.zeros((m, d1), dtype=torch.float32, device=device)
            AtAX = torch.zeros_like(X)
            for cid in range(nchunks):
                # The compressed tier's decode: int16 -> int32, bf16 -> f32.
                idxi = idx_t[cid].to(torch.int32)
                valf = val_t[cid].to(torch.float32)
                bucket, sign = self._draw((t, cid), c, m, device)
                cuda_ops.countsketch_scatter(idxi, valf, bucket, sign, m, d1, out=SA)
                # Exact-gradient operand on the same chunk: gather rows of
                # X, then scatter back (a ghost row d1 takes the pad lanes).
                rows = sparse_matmul(idxi, valf, X)
                AtAX += sparse_matmul_t(idxi, valf, rows, d1)
            return SA, AtAX

        return self._guarded_newton(fold, AtB, n, d1)

    def _fit_dense(self, A1, B, n: int):
        npad, d1 = A1.shape
        m = self._resolve_m(d1)
        AtB = A1.T @ B

        def fold(X, t):
            bucket, sign = self._draw((t,), npad, m, A1.device)
            SA = torch.zeros((m, d1), dtype=torch.float32, device=A1.device)
            SA.index_add_(0, bucket, A1 * sign[:, None])
            return SA, A1.T @ (A1 @ X)

        return self._guarded_newton(fold, AtB, n, d1)

    def _sketched_newton_step(self, SA, g, n: int, d1: int):
        H = SA.T @ SA
        H /= n
        H.diagonal().add_(self.lam + _EPS)
        L = torch.linalg.cholesky(H)
        del H
        return torch.cholesky_solve(g, L)

    def cost(
        self, n, d, k, sparsity, num_machines,
        cpu_weight, mem_weight, network_weight,
        sketch_overhead: Optional[float] = None,
        gather_overhead: Optional[float] = None,
    ) -> float:
        """Per outer: one fused O(nnz) scatter pass (CountSketch fold at the
        scatter rate + the gradient's gather/scatter priced like a
        gather-engine iteration), the sketched gram ``2 m d²`` and its
        ``d³/3`` Cholesky; plus the one-time AᵀB pass."""
        if sketch_overhead is None:
            sketch_overhead = self._cs_overhead
        if gather_overhead is None:
            gather_overhead = self._gather_overhead
        m = self._resolve_m(int(d) + 1)
        nnz = n * sparsity * d
        gather_pass = (
            gather_overhead
            * max(cpu_weight * nnz * k, mem_weight * nnz) / num_machines
        )
        per_outer = (
            sketch_overhead * mem_weight * nnz / num_machines
            + cpu_weight * (2.0 * m * d * d + 2.0 * d ** 3 / 3.0)
            / num_machines
            + gather_pass
        )
        network = (
            network_weight * d * k * self.outer_iters
            * math.log2(max(num_machines, 2))
        )
        return self.outer_iters * per_outer + gather_pass + network

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """COO operands (compressed tier: 4 B/nnz, infeasible past the int16
        index boundary), the CountSketch accumulator (m·d f32 — the
        dominant term), sketched Gramian + its Cholesky copy, labels."""
        if self.compress is not None:
            from keystone_tpu_torch.data import resident as resident_mod

            if not resident_mod.compressible_dim(d + 1):
                return float("inf")
            bytes_per_nnz = resident_mod.COMPRESSED_BYTES_PER_NNZ
        else:
            bytes_per_nnz = 8.0
        m = self._resolve_m(int(d) + 1)
        return (
            bytes_per_nnz * n * d * sparsity / num_machines
            + 4.0 * n * k / num_machines
            + 4.0 * m * d
            + 8.0 * d * d
        )
