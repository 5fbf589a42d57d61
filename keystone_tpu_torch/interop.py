"""Carry fitted or drawn parameters across from the JAX package.

The reference's random draws come from ``jax.random`` and the port's from
``torch.Generator``; the two give different numbers from the same seed. To
hold the port against the reference on the same model, a caller reads the
reference's parameters out as numpy arrays and builds the port's modules
from them here. Nothing here imports JAX or the JAX package: the inputs
are plain arrays.

Parameters by module (numpy arrays, or anything ``np.asarray`` takes):

  - ``CosineRandomFeaturesModel``: ``{"W": (num_out, num_in), "b": (num_out,)}``
  - ``StandardScalerModel``: ``{"mean": (d,), "std": (d,) or None}``
  - ``BlockLinearMapper``: ``{"xs": [(d_b, k), ...], "block_size": int,
    "b_opt": (k,) or None, "feature_scalers": [{"mean", "std"}, ...] or None}``
    — a fused flat fit's model has one mean-only scaler per block (its
    slice of the feature means) and ``b_opt`` the label means;
  - ``LinearMapper``: ``{"x": (d, k), "b_opt": (k,) or None,
    "feature_scaler": {"mean", "std"} or None}``
  - ``StreamingFeaturizedLinearModel`` over a ``CosineBankFeaturize``:
    ``{"W_stack": (nb, block, k), "fmean": (d,) or None, "ymean": (k,) or
    None, "Wrf": (d, d_in), "brf": (d,), "tile_rows": int, "feat_dtype":
    the bank's feature dtype (optional, float32 by default; "bfloat16", a
    numpy dtype of that name or a torch dtype)}``
  - ``ZCAWhitener``: ``{"whitener": (d, d), "means": (d,)}``
  - ``Convolver``: ``{"filters": (k, p²·c), "img_channels": int,
    "whitener": {"whitener", "means"} or None, "normalize_patches": bool,
    "var_constant": float}``
  - ``KernelBlockLinearMapper``: ``{"w_locals": [(block_size, k), ...],
    "block_size": int, "train_X": (n_train, d), "gamma": float,
    "kernel_dtype": "f32" or "bf16"}`` (the reference's train rows may
    carry padding rows past ``n_train``; pass the first ``n_train``)
  - ``SparseLinearMapper`` (a sparse L-BFGS fit): :func:`sparse_linear_mapper`
    with ``x (d, k)`` and ``b_opt (k,)``;
  - ``RandomSignNode``: ``{"signs": (d,)}`` (the reference draws them with
    ``jax.random.rademacher``), :func:`random_sign_node`;
  - ``LogisticRegressionModel``: ``{"weights": (d, k)}``,
    :func:`logistic_regression_model`;
  - ``PCATransformer``: ``{"pca_mat": (d, dims)}``, :func:`pca_transformer`;
    ``BatchPCATransformer``: ``{"pca_mat": (d, dims), "batch": True}``,
    :func:`batch_pca_transformer` (float32);
  - ``KMeansModel``: ``{"means": (k, d)}``, :func:`kmeans_model`;
  - ``GaussianMixtureModel``: ``{"means": (d, k), "variances": (d, k),
    "weights": (k,), "weight_threshold": float (optional, 1e-4)}``,
    :func:`gaussian_mixture_model` (float64, the dtype the estimator fits
    in);
  - ``FisherVector``: ``{"gmm": {the GMM's keys}}``, :func:`fisher_vector`;
  - ``CompressedCOOChunks``: :func:`coo_chunks` takes the reference object
    itself and reads its int16 indices, its bf16 values as their 16-bit
    patterns (so no ``ml_dtypes`` import is needed), its labels, ``n_true``
    and ``d``.

Random draws, not weights, are what the sketched estimators
(``SketchedLeastSquares``, ``IterativeHessianSketch``,
``SketchedLeastSquaresEstimator``) take from the reference: each has a
``draws=`` injection point, a callable returning the draws the reference
makes at that step. :func:`numpy_draws` wraps a callable that returns
numpy arrays (a caller's ``jax.random`` draws read out as numpy) into one
that returns tensors of the dtypes the estimators consume. Their fitted
models are ``LinearMapper`` / ``SparseLinearMapper``, carried across by
:func:`linear_mapper` and :func:`sparse_linear_mapper`.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.data.resident import CompressedCOOChunks
from keystone_tpu_torch.ops.images.conv import Convolver
from keystone_tpu_torch.ops.images.fisher import FisherVector
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.classifiers import LogisticRegressionModel
from keystone_tpu_torch.ops.learning.kernel import (
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
)
from keystone_tpu_torch.ops.learning.linear import LinearMapper, SparseLinearMapper
from keystone_tpu_torch.ops.learning.clustering import GaussianMixtureModel, KMeansModel
from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer, PCATransformer, ZCAWhitener
from keystone_tpu_torch.ops.learning.streaming_ls import (
    CosineBankFeaturize,
    StreamingFeaturizedLinearModel,
)
from keystone_tpu_torch.ops.stats import (
    CosineRandomFeaturesModel,
    RandomSignNode,
    StandardScalerModel,
)


def _f32(x, device) -> torch.Tensor:
    return as_tensor(np.array(x, dtype=np.float32), device)  # a writable copy


def cosine_features_model(W, b, device=None) -> CosineRandomFeaturesModel:
    device = resolve_device(device)
    return CosineRandomFeaturesModel(_f32(W, device), _f32(b, device))


def standard_scaler_model(mean, std=None, device=None) -> StandardScalerModel:
    device = resolve_device(device)
    return StandardScalerModel(
        _f32(mean, device), None if std is None else _f32(std, device)
    )


def block_linear_mapper(
    xs: Sequence,
    block_size: int,
    b_opt=None,
    feature_scalers: Optional[Sequence[Mapping[str, Any]]] = None,
    device=None,
) -> BlockLinearMapper:
    device = resolve_device(device)
    scalers = None
    if feature_scalers is not None:
        scalers = [
            standard_scaler_model(s["mean"], s.get("std"), device)
            for s in feature_scalers
        ]
    return BlockLinearMapper(
        [_f32(x, device) for x in xs],
        int(block_size),
        b_opt=None if b_opt is None else _f32(b_opt, device),
        feature_scalers=scalers,
    )


def linear_mapper(
    x, b_opt=None, feature_scaler: Optional[Mapping[str, Any]] = None, device=None
) -> LinearMapper:
    device = resolve_device(device)
    scaler = None
    if feature_scaler is not None:
        scaler = standard_scaler_model(feature_scaler["mean"], feature_scaler.get("std"), device)
    return LinearMapper(
        _f32(x, device), None if b_opt is None else _f32(b_opt, device), scaler
    )


def _feat_dtype(dtype) -> torch.dtype:
    """A feature dtype given as a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", str(dtype))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"feature dtype {dtype!r}: the bank takes float32 or bfloat16")
    return dtypes[name]


def streaming_linear_model(
    W_stack, fmean, ymean, Wrf, brf, tile_rows: int, device=None, feat_dtype=torch.float32,
) -> StreamingFeaturizedLinearModel:
    """The reference's fitted streamed model (a ``StreamingFeaturizedLinearModel``
    over a ``CosineBankFeaturize`` of ``feat_dtype`` features), rebuilt in
    the port."""
    device = resolve_device(device)
    return StreamingFeaturizedLinearModel(
        CosineBankFeaturize(_f32(Wrf, device), _f32(brf, device), _feat_dtype(feat_dtype)),
        _f32(W_stack, device),
        int(tile_rows),
        fmean=None if fmean is None else _f32(fmean, device),
        ymean=None if ymean is None else _f32(ymean, device),
    )


def zca_whitener(whitener, means, device=None) -> ZCAWhitener:
    device = resolve_device(device)
    return ZCAWhitener(_f32(whitener, device), _f32(means, device))


def convolver(filters, img_channels: int, whitener: Optional[Mapping[str, Any]] = None,
              normalize_patches: bool = True, var_constant: float = 10.0,
              device=None) -> Convolver:
    """The reference's ``Convolver`` (its packed filters and whitener)."""
    device = resolve_device(device)
    return Convolver(
        _f32(filters, device), img_x=-1, img_y=-1, img_channels=int(img_channels),
        whitener=None if whitener is None else zca_whitener(
            whitener["whitener"], whitener["means"], device),
        normalize_patches=bool(normalize_patches), var_constant=float(var_constant),
    )


def kernel_block_linear_mapper(w_locals: Sequence, block_size: int, train_X, gamma: float,
                               kernel_dtype: str = "f32",
                               device=None) -> KernelBlockLinearMapper:
    """The reference's fitted kernel ridge model: its block weights, the
    true train rows and γ."""
    device = resolve_device(device)
    X = _f32(train_X, device)
    transformer = GaussianKernelTransformer(float(gamma), X, X.shape[0], kernel_dtype)
    return KernelBlockLinearMapper(
        [_f32(w, device) for w in w_locals], int(block_size), transformer, X.shape[0]
    )


def sparse_linear_mapper(x, b_opt=None, device=None) -> SparseLinearMapper:
    """The reference's fitted ``SparseLinearMapper`` (its ``x`` and
    ``b_opt`` as arrays)."""
    device = resolve_device(device)
    return SparseLinearMapper(_f32(x, device), None if b_opt is None else _f32(b_opt, device))


def random_sign_node(signs, device=None) -> RandomSignNode:
    """The reference's ``RandomSignNode`` (its ±1 ``signs``)."""
    return RandomSignNode(_f32(signs, resolve_device(device)))


def logistic_regression_model(weights, device=None) -> LogisticRegressionModel:
    """The reference's fitted ``LogisticRegressionModel`` (its (d, k)
    ``weights``)."""
    return LogisticRegressionModel(_f32(weights, resolve_device(device)))


def coo_chunks(ref, device=None) -> CompressedCOOChunks:
    """A reference ``CompressedCOOChunks`` as the port's: the same int16
    indices, bf16 values (the same bits, read through a 16-bit view of the
    reference's numpy buffer) and float32 labels, on ``device``."""
    device = resolve_device(device)
    bits = np.ascontiguousarray(np.asarray(ref.val_t).view(np.int16))
    return CompressedCOOChunks(
        torch.from_numpy(np.ascontiguousarray(np.asarray(ref.idx_t, np.int16))).to(device),
        torch.from_numpy(bits).view(torch.bfloat16).to(device),
        _f32(ref.y_t, device),
        n_true=ref.n_true, d=ref.d,
    )


def pca_transformer(pca_mat, device=None) -> PCATransformer:
    return PCATransformer(_f32(pca_mat, resolve_device(device)))


def batch_pca_transformer(pca_mat, device=None) -> BatchPCATransformer:
    return BatchPCATransformer(_f32(pca_mat, resolve_device(device)))


def _f64(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float64)).to(device)


def kmeans_model(means, device=None) -> KMeansModel:
    return KMeansModel(_f64(means, resolve_device(device)))


def gaussian_mixture_model(means, variances, weights, weight_threshold: float = 1e-4,
                           device=None) -> GaussianMixtureModel:
    device = resolve_device(device)
    return GaussianMixtureModel(_f64(means, device), _f64(variances, device),
                                _f64(weights, device), weight_threshold)


def fisher_vector(gmm: Mapping[str, Any], device=None) -> FisherVector:
    return FisherVector(gaussian_mixture_model(
        gmm["means"], gmm["variances"], gmm["weights"], gmm.get("weight_threshold", 1e-4),
        device))


def numpy_draws(fn: Callable) -> Callable:
    """``fn(*step)`` returns a tuple of numpy arrays (the reference's draws
    at one step: SRHT signs and bins, or CountSketch buckets and signs);
    the result returns them as CPU tensors, integers as int64 and floats
    as float32. The estimators move them to the data's device."""

    def draws(*step):
        out = []
        for a in fn(*step):
            a = np.array(a)  # a writable copy
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
            out.append(torch.from_numpy(a).to(dtype))
        return tuple(out)

    return draws


def params_from_jax(params: Mapping[str, Any], device=None):
    """Build the port's module from one reference module's parameters (see
    the module docstring for the keys of each)."""
    keys = set(params)
    if "w_locals" in keys:
        return kernel_block_linear_mapper(
            params["w_locals"], params["block_size"], params["train_X"], params["gamma"],
            params.get("kernel_dtype", "f32"), device,
        )
    if "filters" in keys:
        return convolver(
            params["filters"], params["img_channels"], params.get("whitener"),
            params.get("normalize_patches", True), params.get("var_constant", 10.0), device,
        )
    if "gmm" in keys:
        return fisher_vector(params["gmm"], device)
    if {"means", "variances", "weights"} <= keys:
        return gaussian_mixture_model(params["means"], params["variances"], params["weights"],
                                      params.get("weight_threshold", 1e-4), device)
    if "pca_mat" in keys:
        if params.get("batch", False):
            return batch_pca_transformer(params["pca_mat"], device)
        return pca_transformer(params["pca_mat"], device)
    if {"whitener", "means"} <= keys:
        return zca_whitener(params["whitener"], params["means"], device)
    if "W_stack" in keys:
        return streaming_linear_model(
            params["W_stack"], params.get("fmean"), params.get("ymean"), params["Wrf"],
            params["brf"], params["tile_rows"], device,
            params.get("feat_dtype", torch.float32),
        )
    if {"W", "b"} <= keys:
        return cosine_features_model(params["W"], params["b"], device)
    if {"xs", "block_size"} <= keys:
        return block_linear_mapper(
            params["xs"], params["block_size"], params.get("b_opt"),
            params.get("feature_scalers"), device,
        )
    if "x" in keys:
        return linear_mapper(
            params["x"], params.get("b_opt"), params.get("feature_scaler"), device
        )
    if "mean" in keys:
        return standard_scaler_model(params["mean"], params.get("std"), device)
    if keys == {"means"}:
        return kmeans_model(params["means"], device)
    if keys == {"signs"}:
        return random_sign_node(params["signs"], device)
    if keys == {"weights"}:
        return logistic_regression_model(params["weights"], device)
    raise ValueError(f"no port module takes the parameters {sorted(keys)}")
