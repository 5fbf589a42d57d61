"""Kernel ridge regression via blockwise Gauss-Seidel (arXiv:1602.05310),
on one device.

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

Not ported yet (ROADMAP A.8): the ``"bf16x3"`` kernel dtype (XLA-only in
the reference), the stepwise ``profile=True`` path, the mesh sweep
(``_krr_mesh_program``), the ring apply and ``NystromKernelRidge``.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops import cuda_ops
from keystone_tpu_torch.parallel.linalg import _psd_factor, _solve_psd
from keystone_tpu_torch.workflow import LabelEstimator, Transformer

logger = logging.getLogger("keystone_tpu_torch.kernel")


# ---------------------------------------------------------------------------
# Gaussian kernel
# ---------------------------------------------------------------------------


def _compute_dtype(kernel_dtype: str) -> torch.dtype:
    return torch.bfloat16 if kernel_dtype == "bf16" else torch.float32


def _norms(X) -> torch.Tensor:
    Xf = X.to(torch.float32)
    return (Xf * Xf).sum(dim=1)


class GaussianKernelTransformer:
    """Holds the train rows; produces kernel blocks on demand. Blocks are
    row ranges of the n train rows: a ragged last block is shorter."""

    def __init__(self, gamma: float, train_X, n_train: int, kernel_dtype: str = "f32"):
        self.gamma = float(gamma)
        self.n_train = int(n_train)
        self.train_X = as_tensor(train_X).to(torch.float32)[: self.n_train]
        self.kernel_dtype = kernel_dtype
        self._train_norms = _norms(self.train_X)
        self._compute_dtype = _compute_dtype(kernel_dtype)
        # The kernels' operand: rounded to bf16 once here, not per block.
        self._train_op = self.train_X.to(self._compute_dtype).contiguous()

    def operand(self, X) -> torch.Tensor:
        """Rows as the kernels read them (float32, or bf16 for "bf16")."""
        return as_tensor(X, self.train_X.device).to(self._compute_dtype).contiguous()

    def _block(self, start: int, size: int):
        stop = min(start + size, self.n_train)
        return self._train_op[start:stop], self._train_norms[start:stop]

    def column_block(self, start: int, size: int):
        """K(train, train[start:start+size]) — (n_train, valid columns)."""
        Xb, nb = self._block(start, size)
        return cuda_ops.gaussian_kernel_block(
            self._train_op, Xb, self._train_norms, nb, self.gamma, self._compute_dtype
        )

    def test_block(self, test_X, start: int, size: int, test_norms=None):
        """K(test, train[start:start+size]). ``test_norms`` (the squared row
        norms of test_X) may be passed to skip recomputing them per block."""
        test_X = as_tensor(test_X, self.train_X.device)
        if test_norms is None:
            test_norms = _norms(test_X)
        Xb, nb = self._block(start, size)
        return cuda_ops.gaussian_kernel_block(
            self.operand(test_X), Xb, test_norms, nb, self.gamma, self._compute_dtype
        )

    def diag_block(self, start: int, size: int):
        """K(train[start:start+size], train[start:start+size])."""
        Xb, nb = self._block(start, size)
        return cuda_ops.gaussian_kernel_block(Xb, Xb, nb, nb, self.gamma, self._compute_dtype)


class GaussianKernelGenerator:
    """Factory binding γ; ``fit(data)`` captures the training rows
    (reference: KernelGenerator.scala:18-60).

    ``kernel_dtype="bf16"`` rounds the kernels' operands to bf16 (products
    accumulate in f32; the solves stay f32). See the reference's
    ``_gaussian_block`` for its error model: with a small λ the kernel's
    error can make K + λI indefinite. ``"bf16x3"`` (the reference's XLA
    3-pass product) is not ported yet.
    """

    def __init__(self, gamma: float, kernel_dtype: str = "f32"):
        if kernel_dtype == "bf16x3":
            raise NotImplementedError(
                'kernel_dtype="bf16x3" (the reference\'s XLA 3-pass bf16 product) is '
                'not ported yet (ROADMAP A.8); use "f32" or "bf16"'
            )
        if kernel_dtype not in ("f32", "bf16"):
            raise ValueError(f'kernel_dtype must be "f32" or "bf16", got {kernel_dtype!r}')
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


def _krr_sweep(transformer: GaussianKernelTransformer, Y, order, grams, chols,
               lam: float, bs: int, w_stack):
    """Gauss-Seidel steps over ``order`` (block indices), updating the
    (num_blocks, bs, k) stack ``w_stack`` in place; returns it. The dual
    model W (n, k) is the stack's first n rows, so a resumed sweep that
    starts from a saved stack continues exactly where it stopped."""
    n, k = Y.shape
    W = w_stack.reshape(-1, k)[:n].clone()
    X, norms = transformer._train_op, transformer._train_norms
    for block in (int(b) for b in order):
        start = block * bs
        stop = min(start + bs, n)
        v = stop - start
        residual = cuda_ops.gaussian_resid_block(
            X, X[start:stop], norms, norms[start:stop], W, transformer.gamma,
            transformer._compute_dtype,
        )
        gram, w_old = grams[block], w_stack[block]
        # Ghost rows of the right-hand side stay zero; with gram's identity
        # ghost diagonal they solve to exactly zero, so W's invariant holds.
        rhs = torch.zeros((bs, k), dtype=Y.dtype, device=Y.device)
        rhs[:v] = Y[start:stop] - (residual - (gram.T @ w_old)[:v])
        w_new = _solve_psd(gram, rhs, lam, chol=chols[block])
        W[start:stop] = w_new[:v]
        w_stack[block] = w_new
    return w_stack


class KernelBlockLinearMapper(Transformer):
    """Apply the dual model to test data block by block
    (reference: KernelBlockLinearMapper.scala:28-115). ``w_locals`` are the
    (block_size, k) block weights; a ragged last block's ghost rows are
    zero and are not read."""

    def __init__(self, w_locals: List, block_size: int,
                 kernel_transformer: GaussianKernelTransformer, n_train: int):
        device = kernel_transformer.train_X.device
        self.w_locals = [as_tensor(w, device) for w in w_locals]
        self.block_size = block_size
        self.kernel_transformer = kernel_transformer
        self.n_train = n_train

    def apply(self, x):
        return self.batch_apply(Dataset(as_tensor(x)[None])).to_numpy()[0]

    def batch_apply(self, data: Dataset) -> Dataset:
        kt = self.kernel_transformer
        X = as_tensor(data.array, kt.train_X.device)
        norms = _norms(X)
        X_op = kt.operand(X)
        out = None
        for bi, w in enumerate(self.w_locals):
            Kb = kt.test_block(X_op, bi * self.block_size, w.shape[0], test_norms=norms)
            w = w[: Kb.shape[1]].to(torch.float32)
            out = Kb @ w if out is None else out.addmm_(Kb, w)
        return Dataset(out, n=data.n)._rezero_padding()


class KernelRidgeRegression(LabelEstimator):
    """Solve (K + λI) W = Y by Gauss-Seidel block coordinate descent
    (reference: KernelRidgeRegression.scala:37-235).

    ``checkpoint_path``: run the sweep in segments of
    ``checkpoint_every_blocks`` block updates and, after each, write the
    (position, weight stack) pair atomically there; a later fit with the
    same geometry, hyperparameters, block order and data resumes from it
    and deletes it on success (the reference's ``_fit_checkpointed``).
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
        if profile:
            raise NotImplementedError(
                "profile=True (the reference's stepwise per-phase timing path) is not "
                "ported yet (ROADMAP A.8)"
            )
        self.kernel_generator = kernel_generator
        self.lam = lam
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.block_permuter = block_permuter
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_blocks = int(checkpoint_every_blocks)

    def fit(self, data: Dataset, labels: Dataset) -> KernelBlockLinearMapper:
        n_train = data.n
        bs = self.block_size
        num_blocks = -(-n_train // bs)
        X = as_tensor(data.array).to(torch.float32)[:n_train]
        Y = as_tensor(labels.array, X.device).to(torch.float32)[:n_train]
        k = Y.shape[1]
        transformer = self.kernel_generator.fit(Dataset(X))

        rng = (np.random.default_rng(self.block_permuter)
               if self.block_permuter is not None else None)
        orders = []
        for _ in range(self.num_epochs):
            order = list(range(num_blocks))
            if rng is not None:
                rng.shuffle(order)
            orders.extend(order)
        order_arr = np.array(orders, dtype=np.int32)

        lam = float(self.lam)
        grams, chols = _diag_factor_prepass(transformer, lam, bs, num_blocks)

        def run_segment(seg, stack):
            return _krr_sweep(transformer, Y, seg, grams, chols, lam, bs, stack)

        stack0 = torch.zeros((num_blocks, bs, k), dtype=torch.float32, device=X.device)
        if self.checkpoint_path is None or order_arr.shape[0] == 0:
            w_stack = run_segment(order_arr, stack0)
        else:
            w_stack = self._fit_checkpointed(
                run_segment, stack0, X, Y, order_arr, num_blocks, bs, k, n_train
            )
        w_locals = [w_stack[i] for i in range(num_blocks)]
        return KernelBlockLinearMapper(w_locals, bs, transformer, n_train)

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
