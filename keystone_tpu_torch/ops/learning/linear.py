"""Dense linear models and the exact least-squares estimator.

Port of ``keystone_tpu/ops/learning/linear.py`` (reference:
nodes/learning/LinearMapper.scala, apply + NormalEquations solve;
LocalLeastSquaresEstimator.scala): :class:`LinearMapper` and
:class:`LinearMapEstimator`, whose fit also offers the fit-fusion contract
(``device_fit_fn``); :class:`SparseLinearMapper`, the model the sparse
L-BFGS and sketched fits return; :class:`LocalLeastSquaresEstimator`
(numpy ``lstsq`` in float64 on the host) and
:class:`SketchedLeastSquaresEstimator` (dense CountSketch sketch-and-solve
plus guarded refinement). The exact and sketched estimators carry the
analytic ``cost`` and ``resident_bytes`` models the solver selector
(``cost.py``) prices them by.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.cuda_ops import row_stable_matmul
from keystone_tpu_torch.ops.learning.cost import CostModel
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.workflow import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.fusion import DeviceFit, masked_center


def mapper_product(X, W):
    """A linear model's batched product ``X @ W``, the one the mappers'
    ``device_fn`` computes. Float32 operands go through
    :func:`~keystone_tpu_torch.ops.cuda_ops.row_stable_matmul`, whose rows
    do not depend on how many rows share the call, so every padding bucket
    of an exported plan, and a batch apply of the same plan, give a row the
    same bits (ROADMAP C.8). The kernel is float32; other dtypes keep
    torch's product, as the reference leaves the product to XLA."""
    if X.dtype == torch.float32 and W.dtype == torch.float32 and X.dim() == 2:
        return row_stable_matmul(X, W)
    return X @ W


class LinearMapper(Transformer):
    """x -> xᵀX + b, with optional feature scaling
    (reference: LinearMapper.scala:45-62). Its ``device_fn`` (center-scale
    + :func:`mapper_product` + intercept) lets apply chains fuse through
    the model."""

    def __init__(self, x, b_opt=None, feature_scaler: Optional[StandardScalerModel] = None):
        self.x = as_tensor(x)
        self.b_opt = None if b_opt is None else as_tensor(b_opt, self.x.device)
        self.feature_scaler = feature_scaler

    def apply(self, v):
        v = as_tensor(v, self.x.device)
        if self.feature_scaler is not None:
            v = self.feature_scaler.apply(v)
        out = v @ self.x
        if self.b_opt is not None:
            out = out + self.b_opt
        return out

    def device_fn(self):
        def fn(v):
            v = as_tensor(v, self.x.device)
            if self.feature_scaler is not None:
                v = self.feature_scaler.apply(v)
            out = mapper_product(v, self.x)
            return out if self.b_opt is None else out + self.b_opt

        return fn


class SparseLinearMapper(Transformer):
    """Sparse-input dense-model apply: ``out = X W + b`` over padded-COO
    batches through a model-row gather + nnz reduction, the design matrix
    never densified (reference: SparseLinearMapper.scala:13-50, the apply
    of SparseLBFGS's fitted models). Dense input falls through to a plain
    product, so the mapper slots in wherever a LinearMapper does."""

    def __init__(self, x, b_opt=None):
        self.x = as_tensor(x)
        self.b_opt = None if b_opt is None else as_tensor(b_opt, self.x.device)

    def apply(self, v):
        if isinstance(v, dict) and set(v.keys()) == {"indices", "values"}:
            idx = as_tensor(v["indices"], self.x.device).to(torch.int64)
            val = as_tensor(v["values"], self.x.device).to(self.x.dtype)
            # Out-of-range lanes are dropped, as sparse_matmul drops them.
            m = (idx >= 0) & (idx < self.x.shape[0])
            out = val[m] @ self.x[idx[m]]
        else:
            out = as_tensor(v, self.x.device) @ self.x
        if self.b_opt is not None:
            out = out + self.b_opt
        return out

    def batch_apply(self, data: Dataset) -> Dataset:
        from keystone_tpu_torch.ops.sparse import is_sparse_dataset, sparse_matmul

        if is_sparse_dataset(data):
            out = sparse_matmul(data.data["indices"], data.data["values"], self.x)
            if self.b_opt is not None:
                out = out + self.b_opt
            return Dataset(out, n=data.n)._rezero_padding()
        return data.map_batch(self.apply)


class LinearMapEstimator(LabelEstimator, CostModel):
    """Exact OLS/ridge via the normal equations
    (reference: LinearMapper.scala:64-98): mean-center features and labels,
    solve (AᵀA + λI) X = AᵀB, keep the label mean as intercept."""

    def __init__(self, lam: Optional[float] = None):
        self.lam = lam

    def device_fit_fn(self):
        """Fit-fusion contract (workflow/fusion.py): mean-centering + the
        normal-equations solve on the featurized matrix, so upstream
        featurization runs straight into the fit (the same pattern as
        ``BlockLeastSquaresEstimator.device_fit_fn``)."""

        def fit_fn(F, Y, n_true: int):
            Fc, Yc, fmean, ymean = masked_center(F, Y, n_true)
            Yc = Yc.to(Fc.dtype)
            x = linalg._solve_psd(Fc.T @ Fc, Fc.T @ Yc, float(self.lam or 0.0))
            return x, fmean, ymean

        def build(params):
            x, fmean, ymean = params
            return LinearMapper(x, b_opt=ymean, feature_scaler=StandardScalerModel(fmean))

        return DeviceFit(fit_fn, build)

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        feature_scaler = StandardScaler(normalize_std_dev=False).fit(data)
        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels)
        A = as_tensor(feature_scaler.batch_apply(data).array)
        B = as_tensor(label_scaler.batch_apply(labels).array, A.device)
        x = linalg.normal_equations_solve(A, B, self.lam or 0.0)
        return LinearMapper(x, b_opt=label_scaler.mean, feature_scaler=feature_scaler)

    def cost(
        self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight, network_weight
    ) -> float:
        """Analytic cost model (LinearMapper.scala:100-115)."""
        flops = n * d * (d + k) / num_machines
        bytes_scanned = n * d / num_machines + d * d
        network = d * (d + k)
        return max(cpu_weight * flops, mem_weight * bytes_scanned) + network_weight * network

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model: the matrix plus its centered copy (f32), labels,
        and the Gramian with its Cholesky factor."""
        return (
            8.0 * n * d / num_machines
            + 8.0 * n * k / num_machines
            + 8.0 * d * d
        )


class LocalLeastSquaresEstimator(LabelEstimator):
    """Collect-to-host exact least squares via LAPACK ``lstsq``
    (reference: LocalLeastSquaresEstimator.scala:16-61): the rows are
    centered and solved in float64 with numpy on the host, and the model
    comes back on the data's device in the data's dtype."""

    def __init__(self, lam: float = 0.0):
        self.lam = lam

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        arr = as_tensor(data.array)
        A = np.asarray(data.to_numpy(), dtype=np.float64)
        B = np.asarray(labels.to_numpy(), dtype=np.float64)
        a_mean = A.mean(axis=0)
        b_mean = B.mean(axis=0)
        A = A - a_mean
        B = B - b_mean
        if self.lam > 0:
            d = A.shape[1]
            A = np.vstack([A, np.sqrt(self.lam) * np.eye(d)])
            B = np.vstack([B, np.zeros((d, B.shape[1]))])
        x, *_ = np.linalg.lstsq(A, B, rcond=None)

        def back(v):
            return torch.from_numpy(np.ascontiguousarray(v)).to(device=arr.device,
                                                                dtype=arr.dtype)

        return LinearMapper(back(x), b_opt=back(b_mean),
                            feature_scaler=StandardScalerModel(back(a_mean)))


class SketchedLeastSquaresEstimator(LabelEstimator, CostModel):
    """Randomized (sketch-and-solve) least squares with optional iterative
    Hessian-sketch refinement (Drineas et al., "Faster Least Squares
    Approximation"; Pilanci & Wainwright).

    A CountSketch S with m = sketch_factor·d rows compresses the centered
    (A, B) in one pass — a segment sum of sign-flipped rows into their
    buckets (``index_add_``; on the card its atomics add in no fixed order,
    so card fits agree to float reassociation) — then the m × d sketched
    system solves by Cholesky. ``refine_iters`` guarded Hessian-sketch steps
    (exact full-data gradient, the sketched Gramian as preconditioner) close
    the gap to the exact solution; a step whose gradient norm stops
    shrinking ends the refinement.

    The buckets and signs (one each a row) come from a ``torch.Generator``
    on the CPU seeded with ``seed``; ``draws``, a callable returning
    ``(buckets (n_pad,), signs (n_pad,))``, replaces them (tests feed the
    reference's ``jax.random`` draws through ``interop.numpy_draws``).
    """

    def __init__(
        self,
        lam: float = 0.0,
        sketch_factor: int = 8,
        refine_iters: int = 2,
        seed: int = 0,
        draws: Optional[Callable] = None,
    ):
        self.lam = lam
        self.sketch_factor = sketch_factor
        self.refine_iters = refine_iters
        self.seed = seed
        self.draws = draws

    def _sketch_rows(self, n: int, d: int) -> int:
        return min(max(self.sketch_factor * d, d + 1), max(n, d + 1))

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        from keystone_tpu_torch.ops.learning.sketch import bucket_sign_draws

        feature_scaler = StandardScaler(normalize_std_dev=False).fit(data)
        label_scaler = StandardScaler(normalize_std_dev=False).fit(labels)
        A = as_tensor(feature_scaler.batch_apply(data).array)
        B = as_tensor(label_scaler.batch_apply(labels).array, A.device).to(A.dtype)
        n_pad, d = A.shape
        m = self._sketch_rows(data.n, d)
        if self.draws is not None:
            buckets, signs = self.draws()
        else:
            buckets, signs = bucket_sign_draws(self.seed, (), n_pad, m)
        buckets = as_tensor(buckets).to(device=A.device, dtype=torch.int64)
        signs = as_tensor(signs).to(device=A.device, dtype=A.dtype)
        # Padding rows are zero, so their scattered contribution is zero.
        SA = A.new_zeros((m, d)).index_add_(0, buckets, A * signs[:, None])
        SB = B.new_zeros((m, B.shape[1])).index_add_(0, buckets, B * signs[:, None])

        # One factorization serves both the initial sketched solve and the
        # refinement preconditioner.
        gram_s = SA.T @ SA
        gram_s.diagonal().add_(self.lam + 1e-8)
        chol = torch.linalg.cholesky(gram_s)
        x = torch.cholesky_solve(SA.T @ SB, chol)

        # x ← x − H_s⁻¹ (Aᵀ(Ax − B) + λx), kept only while the gradient
        # norm shrinks (one read on the host a step).
        prev_gnorm = None
        for _ in range(max(self.refine_iters, 0)):
            grad = A.T @ (A @ x - B) + self.lam * x
            gnorm = float(torch.linalg.norm(grad))
            if prev_gnorm is not None and gnorm >= prev_gnorm:
                break
            prev_gnorm = gnorm
            x = x - torch.cholesky_solve(grad, chol)
        return LinearMapper(x, b_opt=label_scaler.mean, feature_scaler=feature_scaler)

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight) -> float:
        """Sketch pass O(nd) + local solve O(m d²) + refinement passes
        O(ndk), with the same m clamp ``fit`` applies and a per-iteration
        d·k gradient all-reduce in the network term."""
        m = self._sketch_rows(n, d)
        flops = (n * d + m * d * d + self.refine_iters * n * d * k) / num_machines
        bytes_scanned = (1 + self.refine_iters) * n * d / num_machines
        network = d * (d + k) + self.refine_iters * d * k
        return max(cpu_weight * flops, mem_weight * bytes_scanned) + network_weight * network

    def resident_bytes(self, n, d, k, sparsity, num_machines) -> float:
        """Capacity model: the matrix, the (m, d) sketch, and the sketched
        Gramian + factor."""
        m = self._sketch_rows(n, d)
        return (
            4.0 * n * d / num_machines
            + 4.0 * n * k / num_machines
            + 4.0 * m * d
            + 8.0 * d * d
        )
