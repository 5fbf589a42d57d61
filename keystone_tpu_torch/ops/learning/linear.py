"""Dense linear models and the exact least-squares estimator.

Port of ``keystone_tpu/ops/learning/linear.py`` (reference:
nodes/learning/LinearMapper.scala, apply + NormalEquations solve):
:class:`LinearMapper` and :class:`LinearMapEstimator`, whose fit also
offers the fit-fusion contract (``device_fit_fn``), and
:class:`SparseLinearMapper`, the model the sparse L-BFGS fits return. The
local and sketched estimators of the reference module come with later
slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.stats import StandardScaler, StandardScalerModel
from keystone_tpu_torch.parallel import linalg
from keystone_tpu_torch.workflow import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.fusion import DeviceFit, masked_center


class LinearMapper(Transformer):
    """x -> xᵀX + b, with optional feature scaling
    (reference: LinearMapper.scala:45-62). Its ``device_fn`` (center-scale
    + GEMM + intercept) lets apply chains fuse through the model."""

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
        return self.apply


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


class LinearMapEstimator(LabelEstimator):
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
