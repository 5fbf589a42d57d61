"""Kernel ridge regression via blockwise Gauss-Seidel (arXiv:1602.05310).

Port of ``keystone_tpu/ops/learning/kernel.py`` (reference:
nodes/learning/KernelRidgeRegression.scala:37-275, KernelMatrix.scala:17-90,
KernelGenerator.scala:18-206, KernelBlockLinearMapper.scala:28-115).

The n×n kernel matrix is never materialized. Every Gaussian kernel block —
the fit's diagonal blocks, the apply's train-block columns — comes from the
``gaussian_kernel_block`` CUDA kernel, and every step of the sweep takes its
residual ``K(train, block)ᵀ W`` from ``gaussian_resid_block``, which
contracts the kernel block tile by tile without storing it
(``ops/cuda_ops.py``; their plain versions on CPU tensors). The reference's
one-program ``lax.scan`` sweep is a Python loop over the block order here;
its batched diagonal pre-pass is one kernel launch per block and one
batched Cholesky over the (blocks, bs, bs) stack.

Where the reference pads the rows to a whole number of blocks
(``KernelRidgeRegression.fit``), the port keeps the n true rows and masks:
the kernels mask ragged edges, a ragged last block's diagonal is
identity-ghosted to (bs, bs) as in the reference, and its ghost rows solve
to exactly zero, so the (blocks, bs, k) weight stack is the reference's.

On a mesh whose ``data`` axis has more than one shard (``Dataset.shard``)
the fit runs the mesh sweep (the reference's ``_krr_mesh_program``): rows,
labels and the dual model stay row-sharded, each step's residual is one
``gaussian_resid_block`` launch a shard on that shard's rows, the partials
meet in one ``psum`` in shard order, and the (bs, bs) solve runs on the
axis's first device, where ``parallel/linalg.py``'s mesh BCD solves. The
mapper then applies by the ring (``parallel/ring.ring_kernel_apply``).

``kernel_dtype="bf16x3"`` is the reference's 3-pass product, which it
computes outside Pallas on purpose (Mosaic has no 3-pass lowering, and a
fused hi/lo variant measured slower): three bf16 ``torch`` products with
float32 accumulation and a float32 epilogue (:func:`gaussian_block_bf16x3`),
not a port of a kernel. ``profile=True`` runs the reference's stepwise path,
timing its phases.

Nyström KRR (:class:`NystromKernelRidge`, :class:`NystromKernelMapper`)
takes its landmark kernel blocks K(X, L) and K(L, L) from the same
``gaussian_kernel_block`` kernel, the padding rows masked out, and solves
the m × m normal equations with the reference's scale-relative jitter.
Its landmarks are k-means++ centres (the port's
``KMeansPlusPlusEstimator``, numpy's seeding draws) or a uniform row
sample drawn by numpy's ``default_rng(seed).choice``, so both packages
pick the same landmarks. float64 rows (the CPU tests) take a plain float64
kernel block: the CUDA kernel is float32 or bf16, as the port's block
solvers send float64 operands to plain contractions. The normal equations
are assembled and solved in float64 whatever the rows' dtype (ROADMAP C.7:
on CIFAR's features float32 ones miss α by 2e-2 of its norm at 600 rows
and 64 landmarks, and by 75 to 110 times it at 50,000 and 2,048).
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel import ring
from keystone_tpu_torch.parallel.linalg import _psd_factor, _solve_psd
from keystone_tpu_torch.utils import profiling
from keystone_tpu_torch.workflow import LabelEstimator, Transformer

logger = logging.getLogger("keystone_tpu_torch.kernel")

KERNEL_DTYPES = ("f32", "bf16x3", "bf16")


# ---------------------------------------------------------------------------
# Gaussian kernel
# ---------------------------------------------------------------------------


def _compute_dtype(kernel_dtype: str) -> torch.dtype:
    return torch.bfloat16 if kernel_dtype == "bf16" else torch.float32


def _bf16_parts(X: torch.Tensor):
    """X (float32) as hi + lo, both bf16: hi = X rounded, lo = the rest
    rounded."""
    hi = X.to(torch.bfloat16)
    return hi, (X - hi.to(torch.float32)).to(torch.bfloat16)


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ bᵀ of bf16 operands, accumulated and returned in float32: on the
    card one bf16 product on the tensor cores with a float32 output; on the
    CPU, which has no such product, the operands widened to float32 (the
    products of bf16 values are exact there)."""
    if a.device.type == "cuda":
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
        return torch.addmm(out, a, b.T, beta=0, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32).T


def gaussian_block_bf16x3(X, Y, x_norms, y_norms, gamma: float) -> torch.Tensor:
    """K(X, Y) with the cross term X·Yᵀ in the 3-pass bf16 decomposition
    hi·hi + (hi·lo + lo·hi): bf16 parts, float32 accumulation, about 2⁻¹⁶
    relative operand error (kernel entries within about 1e-5 of float32's).
    The norms, the exp epilogue and the result stay float32. The reference
    computes this mode with XLA, not Pallas (Mosaic has no 3-pass lowering,
    and a fused hi/lo kernel measured slower), so this is three ``torch``
    products and an epilogue, not a port of a kernel."""
    xh, xl = _bf16_parts(X.to(torch.float32))
    yh, yl = _bf16_parts(Y.to(torch.float32))
    dot = _bf16_product(xh, yh) + (_bf16_product(xh, yl) + _bf16_product(xl, yh))
    sq = x_norms.to(torch.float32)[:, None] + y_norms.to(torch.float32)[None, :] - 2.0 * dot
    return torch.exp(-float(gamma) * torch.clamp_min(sq, 0.0))


class GaussianKernelTransformer:
    """Holds the train rows; produces kernel blocks on demand. Blocks are
    row ranges of the n train rows: a ragged last block is shorter."""

    def __init__(self, gamma: float, train_X, n_train: int, kernel_dtype: str = "f32"):
        self.gamma = float(gamma)
        self.n_train = int(n_train)
        self.train_X = as_tensor(train_X).to(torch.float32)[: self.n_train]
        self.kernel_dtype = kernel_dtype
        self._train_norms = ring.row_norms(self.train_X)
        self._compute_dtype = _compute_dtype(kernel_dtype)
        # The kernels' operand: rounded to bf16 once here, not per block.
        self._train_op = self.train_X.to(self._compute_dtype).contiguous()

    def operand(self, X) -> torch.Tensor:
        """Rows as the kernels read them (float32, or bf16 for "bf16")."""
        return as_tensor(X, self.train_X.device).to(self._compute_dtype).contiguous()

    def kernel(self, X, Y, x_norms, y_norms) -> torch.Tensor:
        """K(X, Y) of operands as :meth:`operand` makes them, float32."""
        if self.kernel_dtype == "bf16x3":
            return gaussian_block_bf16x3(X, Y, x_norms, y_norms, self.gamma)
        return cuda_ops.gaussian_kernel_block(X, Y, x_norms, y_norms, self.gamma,
                                              self._compute_dtype)

    def residual(self, X, Y, x_norms, y_norms, W) -> torch.Tensor:
        """K(X, Y)ᵀ W: the ``gaussian_resid_block`` kernel, which never
        stores the block; bf16x3 makes the block and contracts it, as the
        reference's 3-pass engine does."""
        if self.kernel_dtype == "bf16x3":
            return self.kernel(X, Y, x_norms, y_norms).T @ W.to(torch.float32)
        return cuda_ops.gaussian_resid_block(X, Y, x_norms, y_norms, W, self.gamma,
                                             self._compute_dtype)

    def _block(self, start: int, size: int):
        stop = min(start + size, self.n_train)
        return self._train_op[start:stop], self._train_norms[start:stop]

    def column_block(self, start: int, size: int):
        """K(train, train[start:start+size]) — (n_train, valid columns)."""
        Xb, nb = self._block(start, size)
        return self.kernel(self._train_op, Xb, self._train_norms, nb)

    def test_block(self, test_X, start: int, size: int, test_norms=None):
        """K(test, train[start:start+size]). ``test_norms`` (the squared row
        norms of test_X) may be passed to skip recomputing them per block."""
        test_X = as_tensor(test_X, self.train_X.device)
        if test_norms is None:
            test_norms = ring.row_norms(test_X, torch.float32)
        Xb, nb = self._block(start, size)
        return self.kernel(self.operand(test_X), Xb, test_norms, nb)

    def diag_block(self, start: int, size: int):
        """K(train[start:start+size], train[start:start+size])."""
        Xb, nb = self._block(start, size)
        return self.kernel(Xb, Xb, nb, nb)


class GaussianKernelGenerator:
    """Factory binding γ; ``fit(data)`` captures the training rows
    (reference: KernelGenerator.scala:18-60).

    ``kernel_dtype`` picks the cross term's recipe; the norms, the exp
    epilogue, the result and the solves stay float32 in every mode:
      - ``"f32"``: float32 operands, the default;
      - ``"bf16x3"``: the 3-pass bf16 decomposition
        (:func:`gaussian_block_bf16x3`), entries within about 1e-5 of f32's;
      - ``"bf16"``: bf16 operands, f32 accumulation. The entry error (about
        γ·‖x‖‖y‖·2⁻⁸) can exceed a small λ and make K + λI indefinite, and
        the block Gauss-Seidel sweep then diverges (the reference's
        ``_gaussian_block``).
    """

    def __init__(self, gamma: float, kernel_dtype: str = "f32"):
        if kernel_dtype not in KERNEL_DTYPES:
            raise ValueError(
                f'kernel_dtype must be "f32", "bf16x3" or "bf16", got {kernel_dtype!r}')
        self.gamma = gamma
        self.kernel_dtype = kernel_dtype

    def fit(self, data: Dataset) -> GaussianKernelTransformer:
        return GaussianKernelTransformer(self.gamma, data.array, data.n, self.kernel_dtype)


# ---------------------------------------------------------------------------
# KRR solver
# ---------------------------------------------------------------------------


def _diag_factor_prepass(transformer: GaussianKernelTransformer, lam: float, bs: int,
                         num_blocks: int):
    """Per-block (gram, Cholesky) pre-pass: every diagonal block made once
    (identity-ghosted to (bs, bs) for a ragged last block) and the whole
    (num_blocks, bs, bs) stack factored in one batched call before the
    sweep, which then reuses the stashed factors on every visit — the
    reference's stash discipline (``kernel.py::_diag_factor_prepass``)."""
    X = transformer.train_X
    grams = torch.eye(bs, dtype=torch.float32, device=X.device).repeat(num_blocks, 1, 1)
    for block in range(num_blocks):
        start = block * bs
        K_bb = transformer.diag_block(start, bs)
        v = K_bb.shape[0]
        grams[block, :v, :v] = K_bb
    return grams, _psd_factor(grams, lam)


def _solve_block(Y, start: int, stop: int, residual, gram, chol, w_old, lam: float,
                 bs: int):
    """One Gauss-Seidel block update: the new (bs, k) block weights from the
    block's residual ``K(train, block)ᵀ W`` (its valid rows), with the
    stashed factor ``chol`` of ``gram`` (or a fresh one where None)."""
    v = stop - start
    # Ghost rows of the right-hand side stay zero; with gram's identity
    # ghost diagonal they solve to exactly zero, so W's invariant holds.
    rhs = torch.zeros((bs, Y.shape[1]), dtype=Y.dtype, device=Y.device)
    rhs[:v] = Y[start:stop] - (residual - (gram.T @ w_old)[:v])
    return _solve_psd(gram, rhs, lam, chol=chol)


class _Sweep:
    """The fit's Gauss-Seidel sweep over row shards: the reference's fused
    sweep on one device (one shard, the transformer's own rows) and its
    ``_krr_mesh_program`` over rows sharded on the ``data`` axis.

    Each step's residual ``K(rows, block)ᵀ W`` is one
    ``gaussian_resid_block`` launch a shard on that shard's rows, the
    partials meet in one ``psum`` in shard order (of one shard: a copy),
    and the (bs, bs) solve runs on the first shard's device, where the
    transformer's rows lie and where the replicated work (the diagonal
    pre-pass, the solves, the weight stack) runs, as
    ``parallel/linalg.py``'s mesh BCD places its solve. The dual model W
    stays row-sharded as the rows are. On a mesh, each distinct device of
    the shards holds the gathered rows (``mesh.all_gather``, as the
    reference gathers X) from which a step takes the block's rows."""

    def __init__(self, transformer: GaussianKernelTransformer, Y, bs: int,
                 xs: Optional[mesh_lib.ShardedRows] = None,
                 gathered: Optional[List[torch.Tensor]] = None):
        self.t = transformer
        self.Y, self.n, self.bs = Y, transformer.n_train, int(bs)
        own = (transformer._train_op, transformer._train_norms)
        self.block_rows = {transformer.train_X.device: own}
        if xs is None:
            self.devices, self.rows = [transformer.train_X.device], self.n
            self.x, self.norms = [own[0]], [own[1]]
            return
        self.devices = [s.device for s in xs.shards]
        self.rows = xs.shard_rows
        cd = transformer._compute_dtype
        shards = [s.to(torch.float32) for s in xs.shards]
        self.x = [s.to(cd).contiguous() for s in shards]
        self.norms = [ring.row_norms(s) for s in shards]
        for dev, full in zip(self.devices, gathered):
            if dev not in self.block_rows:
                rows = full[: self.n].to(torch.float32)
                self.block_rows[dev] = (rows.to(cd).contiguous(), ring.row_norms(rows))

    def weights_from_stack(self, w_stack) -> List[torch.Tensor]:
        """Each shard's rows of the dual model W, from the (num_blocks, bs,
        k) block stack (zeros on a fresh fit; W is the stack's first n
        rows): the resume hook. Rows past n (the mesh's padding) belong to
        no block and stay zero."""
        k = w_stack.shape[2]
        flat = w_stack.reshape(-1, k)[: self.n]
        W = []
        for j, dev in enumerate(self.devices):
            w = torch.zeros((self.rows, k), dtype=torch.float32, device=dev)
            lo, hi = j * self.rows, min((j + 1) * self.rows, self.n)
            if lo < hi:
                w[: hi - lo] = flat[lo:hi].to(dev)
            W.append(w)
        return W

    def run(self, order, grams, chols, lam: float, w_stack):
        """Gauss-Seidel steps over ``order`` (block indices), updating the
        stack ``w_stack`` in place; returns it. A sweep that starts from a
        saved stack continues exactly where it stopped."""
        W = self.weights_from_stack(w_stack)
        bs, ln, first = self.bs, self.rows, self.devices[0]
        for block in (int(b) for b in order):
            start = block * bs
            stop = min(start + bs, self.n)
            parts = []
            for j, dev in enumerate(self.devices):
                Xb, nb = self.block_rows[dev]
                # A shard's padding rows are zero, and K(0, y) = exp(-γ‖y‖²)
                # is not, but their rows of W are zero too: they add nothing.
                parts.append(self.t.residual(self.x[j], Xb[start:stop], self.norms[j],
                                             nb[start:stop], W[j]))
            residual = mesh_lib.psum(parts, first)
            w_new = _solve_block(self.Y, start, stop, residual, grams[block], chols[block],
                                 w_stack[block], lam, bs)
            # Scatter into every shard owning rows of the block: blocks need
            # not align with shard boundaries.
            for j, dev in enumerate(self.devices):
                lo, hi = max(start, j * ln), min(stop, (j + 1) * ln)
                if lo < hi:
                    W[j][lo - j * ln:hi - j * ln] = w_new[lo - start:hi - start].to(dev)
            w_stack[block] = w_new
        return w_stack


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class KernelBlockLinearMapper(Transformer):
    """Apply the dual model to test data block by block
    (reference: KernelBlockLinearMapper.scala:28-115). ``w_locals`` are the
    (block_size, k) block weights; a ragged last block's ghost rows are
    zero and are not read.

    On a mesh whose ``data`` axis has more than one shard the apply runs
    the ring (``parallel/ring.ring_kernel_apply``): the train rows and the
    flattened W are sharded once for each (model, mesh) pair and cached.
    The cache is the model's working state only: it is not pickled (so
    neither saved, exported, paged by the zoo nor shipped to a fleet)."""

    def __init__(self, w_locals: List, block_size: int,
                 kernel_transformer: GaussianKernelTransformer, n_train: int):
        device = kernel_transformer.train_X.device
        self.w_locals = [as_tensor(w, device) for w in w_locals]
        self.block_size = block_size
        self.kernel_transformer = kernel_transformer
        self.n_train = n_train
        self._ring_operands = None  # (mesh, train rows, W), each sharded

    def __getstate__(self):
        # The blocks are views of one weight stack, and pickle writes a
        # view's whole storage (ROADMAP C.12): each block on its own.
        state = self.__dict__.copy()
        state["_ring_operands"] = None
        state["w_locals"] = [w.clone() for w in self.w_locals]
        return state

    def apply(self, x):
        return self.batch_apply(Dataset(as_tensor(x)[None])).to_numpy()[0]

    def _ring_apply(self, data: Dataset, mesh) -> Dataset:
        p = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        ops = getattr(self, "_ring_operands", None)
        if ops is None or ops[0] is not mesh:
            kt = self.kernel_transformer
            W = torch.cat([w.to(torch.float32) for w in self.w_locals])[: self.n_train]
            # The padding train rows have nonzero kernel values but zero
            # model rows, so they add nothing to the product.
            Xtr, _ = mesh_lib.pad_rows(kt.train_X[: self.n_train], p)
            W, _ = mesh_lib.pad_rows(W, p)
            ops = self._ring_operands = (mesh, mesh_lib.shard_rows(Xtr, mesh),
                                         mesh_lib.shard_rows(W, mesh))
        X = _on_mesh(data.array, mesh).map(lambda s: s.to(torch.float32))
        out = ring.ring_kernel_apply(X, ops[1], ops[2], self.kernel_transformer.gamma, mesh=mesh)
        return Dataset(out, n=data.n, mesh=mesh)._rezero_padding()

    def batch_apply(self, data: Dataset) -> Dataset:
        mesh = data.mesh
        if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS) > 1:
            return self._ring_apply(data, mesh)
        kt = self.kernel_transformer
        X = as_tensor(data.array, kt.train_X.device)
        norms = ring.row_norms(X, torch.float32)
        X_op = kt.operand(X)
        out = None
        for bi, w in enumerate(self.w_locals):
            Kb = kt.test_block(X_op, bi * self.block_size, w.shape[0], test_norms=norms)
            w = w[: Kb.shape[1]].to(torch.float32)
            out = Kb @ w if out is None else out.addmm_(Kb, w)
        return Dataset(out, n=data.n)._rezero_padding()


def _on_mesh(x, mesh) -> mesh_lib.ShardedRows:
    """``x`` row-sharded over ``mesh``'s ``data`` axis: a sharded array as
    it is, anything else zero-padded to the axis and sharded."""
    if isinstance(x, mesh_lib.ShardedRows):
        return x
    p = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    return mesh_lib.shard_rows(mesh_lib.pad_rows(as_tensor(x), p)[0], mesh)


class KernelRidgeRegression(LabelEstimator):
    """Solve (K + λI) W = Y by Gauss-Seidel block coordinate descent
    (reference: KernelRidgeRegression.scala:37-235).

    On a mesh whose ``data`` axis has more than one shard the fit runs
    the mesh sweep (:class:`_Sweep`) on the sharded rows, which it
    never gathers into one tensor but through ``mesh.all_gather`` for the
    blocks' rows, as the reference does.

    ``profile=True`` runs the reference's stepwise path instead of the
    fused sweep: each block's column and diagonal kernel blocks made
    afresh (``gaussian_kernel_block``), a synchronize and an
    ``EPOCH_%d_BLOCK_%d`` log line a block, and the ``kernel_gen`` /
    ``block_solve`` seconds of ``profiling.PhaseTimer("krr_fit")`` logged
    at the end. It runs on one device (a sharded fit's rows gathered onto
    the first).

    ``checkpoint_path``: run the sweep in segments of
    ``checkpoint_every_blocks`` block updates and, after each, write the
    (position, weight stack) pair atomically there; a later fit with the
    same geometry, hyperparameters, block order and data resumes from it
    and deletes it on success (the reference's ``_fit_checkpointed``), on
    one device or on a mesh.
    """

    def __init__(
        self,
        kernel_generator: GaussianKernelGenerator,
        lam: float,
        block_size: int,
        num_epochs: int,
        block_permuter: Optional[int] = None,
        profile: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_blocks: int = 25,
    ):
        if profile and checkpoint_path is not None:
            raise ValueError(
                "profile=True forces the stepwise path; checkpointing "
                "segments the fused path — pick one"
            )
        self.kernel_generator = kernel_generator
        self.lam = lam
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.block_permuter = block_permuter
        self.profile = profile
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_blocks = int(checkpoint_every_blocks)

    def _orders(self, num_blocks: int) -> List[List[int]]:
        """Each epoch's block order (shuffled by ``block_permuter``'s numpy
        generator, epoch after epoch, as the reference draws them)."""
        rng = (np.random.default_rng(self.block_permuter)
               if self.block_permuter is not None else None)
        orders = []
        for _ in range(self.num_epochs):
            order = list(range(num_blocks))
            if rng is not None:
                rng.shuffle(order)
            orders.append(order)
        return orders

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        n_train = data.n
        bs = self.block_size
        num_blocks = -(-n_train // bs)
        lam = float(self.lam)
        orders = self._orders(num_blocks)
        if self.profile:
            return self._fit_stepwise(data, labels, orders, num_blocks)
        order_arr = np.array([b for o in orders for b in o], dtype=np.int32)
        mesh = data.mesh
        if mesh is not None and mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS) > 1:
            xs, ys = _on_mesh(data.array, mesh), _on_mesh(labels.array, mesh)
            gathered = mesh_lib.all_gather(list(xs.shards))
            X = gathered[0][:n_train].to(torch.float32)
            Y = mesh_lib.all_gather(list(ys.shards))[0][:n_train].to(X.device, torch.float32)
            transformer = self.kernel_generator.fit(Dataset(X))
            sweep = _Sweep(transformer, Y, bs, xs, gathered)
        else:
            X = as_tensor(data.array).to(torch.float32)[:n_train]
            Y = as_tensor(labels.array, X.device).to(torch.float32)[:n_train]
            transformer = self.kernel_generator.fit(Dataset(X))
            sweep = _Sweep(transformer, Y, bs)
        k = Y.shape[1]
        grams, chols = _diag_factor_prepass(transformer, lam, bs, num_blocks)

        def run_segment(seg, stack):
            return sweep.run(seg, grams, chols, lam, stack)

        stack0 = torch.zeros((num_blocks, bs, k), dtype=torch.float32, device=X.device)
        if self.checkpoint_path is None or order_arr.shape[0] == 0:
            w_stack = run_segment(order_arr, stack0)
        else:
            w_stack = self._fit_checkpointed(
                run_segment, stack0, X, Y, order_arr, num_blocks, bs, k, n_train
            )
        w_locals = [w_stack[i] for i in range(num_blocks)]
        return KernelBlockLinearMapper(w_locals, bs, transformer, n_train)

    def _fit_stepwise(self, data: Dataset, labels: Dataset, orders, num_blocks: int
                      ) -> KernelBlockLinearMapper:
        """The reference's stepwise, per-block path (``profile=True``)."""
        n, bs, lam = data.n, self.block_size, float(self.lam)
        X = as_tensor(data.array).to(torch.float32)[:n]
        Y = as_tensor(labels.array, X.device).to(torch.float32)[:n]
        transformer = self.kernel_generator.fit(Dataset(X))
        k = Y.shape[1]
        W = torch.zeros((n, k), dtype=torch.float32, device=X.device)
        w_locals = [torch.zeros((bs, k), dtype=torch.float32, device=X.device)
                    for _ in range(num_blocks)]
        eye = torch.eye(bs, dtype=torch.float32, device=X.device)
        timer = profiling.PhaseTimer("krr_fit")
        for epoch, order in enumerate(orders):
            for block in order:
                t0 = time.perf_counter()
                start = block * bs
                stop = min(start + bs, n)
                v = stop - start
                with timer.phase("kernel_gen"):
                    K_block = transformer.column_block(start, bs)
                    K_bb = transformer.diag_block(start, bs)
                    # Attribute the kernels' time here, not to the solve.
                    _sync(X.device)
                with timer.phase("block_solve"):
                    gram = eye.clone()
                    gram[:v, :v] = K_bb
                    w_new = _solve_block(Y, start, stop, K_block.T @ W, gram, None,
                                         w_locals[block], lam, bs)
                    W[start:stop] = w_new[:v]
                    w_locals[block] = w_new
                    _sync(X.device)
                logger.info("EPOCH_%d_BLOCK_%d took %.3f seconds", epoch, block,
                            time.perf_counter() - t0)
        timer.log_summary()
        return KernelBlockLinearMapper(w_locals, bs, transformer, n)

    # -- mid-solver checkpoint/resume ------------------------------------

    def _fingerprint(self, X, Y, order_arr, num_blocks, bs, k, n_train) -> str:
        """Geometry + hyperparameter + block-order + data digest: a
        checkpoint may only resume the fit that wrote it. Data is pinned by
        a bitwise sample of up to 64 evenly spaced (X, Y) rows."""
        h = hashlib.sha256()
        h.update(np.asarray(order_arr, dtype=np.int32).tobytes())
        spec = (
            f"n={int(n_train)} d={X.shape[1]} bs={bs} k={k} nb={num_blocks} "
            f"gamma={float(self.kernel_generator.gamma)!r} "
            f"lam={float(self.lam)!r} epochs={self.num_epochs} "
            f"permuter={self.block_permuter!r} "
            f"dtypes={X.dtype}/{Y.dtype} "
            f"kdtype={self.kernel_generator.kernel_dtype}"
        )
        h.update(spec.encode())
        idx = np.unique(np.linspace(0, max(int(n_train) - 1, 0), 64).astype(np.int64))
        rows = torch.from_numpy(idx).to(X.device)
        h.update(X[rows].cpu().numpy().tobytes())
        h.update(Y[rows].cpu().numpy().tobytes())
        return h.hexdigest()

    def _fit_checkpointed(self, run_segment, stack, X, Y, order_arr, num_blocks,
                          bs, k, n_train):
        """Run the sweep in segments, persisting (position, stack) after
        each; resume from ``checkpoint_path`` when a compatible checkpoint
        exists. The write is atomic (tmp + rename), so a preemption
        mid-save leaves the previous checkpoint intact."""
        path = self.checkpoint_path
        fp = self._fingerprint(X, Y, order_arr, num_blocks, bs, k, n_train)
        total = int(order_arr.shape[0])
        pos = 0
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as ck:
                if str(ck["fingerprint"]) != fp:
                    raise ValueError(
                        f"checkpoint at {path} was written by a different KRR fit "
                        "(geometry/hyperparameters/block order differ); delete it "
                        "or point checkpoint_path elsewhere"
                    )
                pos = int(ck["pos"])
                stack = torch.from_numpy(ck["stack"]).to(stack.device)
            logger.info("KRR resume from %s: block update %d/%d", path, pos, total)

        every = max(self.checkpoint_every_blocks, 1)
        while pos < total:
            seg = order_arr[pos:pos + every]
            stack = run_segment(seg, stack)
            pos += int(seg.shape[0])
            if pos < total:
                tmp = f"{path}.tmp.npz"  # .npz: stops savez renaming it
                np.savez(tmp, pos=pos, stack=stack.cpu().numpy(), fingerprint=fp)
                os.replace(tmp, path)
        if os.path.exists(path):
            os.remove(path)  # completed: the model supersedes the checkpoint
        return stack

    @property
    def weight(self) -> int:
        return self.num_epochs + 1


# ---------------------------------------------------------------------------
# Nyström-approximated KRR (reference: kernel.py's NystromKernelRidge)
# ---------------------------------------------------------------------------


def _landmark_block(X, L, x_norms, l_norms, gamma: float) -> torch.Tensor:
    """K(X, L) in the rows' dtype: the ``gaussian_kernel_block`` kernel for
    float32 rows (its plain version on CPU tensors), the same formula in
    float64 for float64 rows."""
    if X.dtype == torch.float64:
        sq = x_norms[:, None] + l_norms[None, :] - 2.0 * (X @ L.T)
        return torch.exp(-float(gamma) * torch.clamp_min(sq, 0.0))
    return cuda_ops.gaussian_kernel_block(X, L, x_norms, l_norms, gamma)


class NystromKernelMapper(Transformer):
    """Predict with a landmark model: f(x) = K(x, L) α."""

    def __init__(self, landmarks, alpha, gamma: float):
        self.landmarks = as_tensor(landmarks)
        self.alpha = as_tensor(alpha, self.landmarks.device)
        self.gamma = float(gamma)
        self._lm_norms = (self.landmarks * self.landmarks).sum(dim=1)

    def apply(self, x):
        return self.batch_apply(Dataset(as_tensor(x)[None])).to_numpy()[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        X = as_tensor(data.array, self.landmarks.device).to(self.landmarks.dtype)
        K = _landmark_block(X, self.landmarks, (X * X).sum(dim=1), self._lm_norms, self.gamma)
        return Dataset(K @ self.alpha.to(K.dtype), n=data.n)._rezero_padding()


def _nystrom_fit_kernel(X, Y, L, gamma: float, lam: float, n_valid: int) -> torch.Tensor:
    """Nyström KRR normal equations: (K_nmᵀ K_nm + λ K_mm) α = K_nmᵀ Y.

    The landmark kernel blocks come from :func:`_landmark_block` in the
    rows' dtype; padding rows of X and Y are zero, but their kernel values
    exp(−γ‖0 − l‖²) are not, so K_nm's rows past ``n_valid`` are masked
    out. The jitter is the reference's, relative to the system's scale:
    duplicate landmarks make the left side exactly singular, and an
    absolute 1e-8 would vanish below one ulp at float32 magnitudes of
    order n.

    The m × m system is assembled and solved in float64 and α returned in
    the kernel blocks' and labels' dtype (ROADMAP C.7). The reference does
    both in that dtype, but on standardised CIFAR features the system is
    ill-conditioned (1.4e6 at 600 rows and 64 landmarks), and float32 sums
    of K_nmᵀ K_nm alone move α by 2e-2 of its norm there (the predictions
    K α by 4e-6); at 50,000 rows and 2,048 landmarks float32 misses α
    entirely."""
    x_norms = (X * X).sum(dim=1)
    l_norms = (L * L).sum(dim=1)
    K_nm = _landmark_block(X, L, x_norms, l_norms, gamma)
    dtype = torch.promote_types(K_nm.dtype, Y.dtype)
    mask = (torch.arange(X.shape[0], device=X.device) < n_valid).to(torch.float64)
    K_nm = K_nm.to(torch.float64) * mask[:, None]
    K_mm = _landmark_block(L, L, l_norms, l_norms, gamma).to(torch.float64)
    m = L.shape[0]
    lhs = K_nm.T @ K_nm + lam * K_mm
    jitter = 1e-6 * (torch.trace(lhs) / m + 1.0)
    lhs = lhs + jitter * torch.eye(m, dtype=torch.float64, device=Y.device)
    return torch.linalg.solve(lhs, K_nm.T @ Y.to(torch.float64)).to(dtype)


class NystromKernelRidge(LabelEstimator):
    """Kernel ridge regression by the Nyström landmark approximation
    (Williams & Seeger, NIPS 2000): m landmarks reduce the n × n dual
    problem to an m × m solve after one K(X, L) pass, O(n·m) kernel work
    instead of O(n²).

    Landmarks are k-means++ centres (``KMeansPlusPlusEstimator(m, 10,
    seed)``, cast back to the data's dtype) or, with
    ``kmeans_landmarks=False``, m distinct rows drawn by numpy's
    ``default_rng(seed).choice``; either way the reference's landmarks. The
    fit runs on the data's device."""

    def __init__(self, kernel_generator: GaussianKernelGenerator, lam: float,
                 num_landmarks: int, kmeans_landmarks: bool = True, seed: int = 0):
        self.kernel_generator = kernel_generator
        self.lam = lam
        self.num_landmarks = num_landmarks
        self.kmeans_landmarks = kmeans_landmarks
        self.seed = seed

    def landmarks(self, data: Dataset) -> torch.Tensor:
        """The m landmark rows the fit uses (m = min(num_landmarks, n))."""
        from keystone_tpu_torch.ops.learning.clustering import KMeansPlusPlusEstimator

        X = as_tensor(data.array)
        m = min(self.num_landmarks, data.n)
        if self.kmeans_landmarks:
            km = KMeansPlusPlusEstimator(m, 10, seed=self.seed).fit(data)
            return km.means.to(X.device, X.dtype)
        idx = np.random.default_rng(self.seed).choice(data.n, m, replace=False)
        return X[torch.from_numpy(idx).to(X.device)]

    def fit(self, data: Dataset, labels: Dataset) -> NystromKernelMapper:
        L = self.landmarks(data)
        X = as_tensor(data.array)
        Y = as_tensor(labels.array, X.device)
        # Align the row counts: data and labels may carry different padding.
        n_pad = max(X.shape[0], Y.shape[0])
        X = torch.nn.functional.pad(X, (0, 0, 0, n_pad - X.shape[0]))
        Y = torch.nn.functional.pad(Y, (0, 0, 0, n_pad - Y.shape[0]))
        alpha = _nystrom_fit_kernel(X, Y, L, float(self.kernel_generator.gamma),
                                    float(self.lam), data.n)
        return NystromKernelMapper(L, alpha, self.kernel_generator.gamma)

    @property
    def weight(self) -> int:
        return 2
