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
    None, "Wrf": (d, d_in), "brf": (d,), "tile_rows": int}``
  - ``ZCAWhitener``: ``{"whitener": (d, d), "means": (d,)}``
  - ``Convolver``: ``{"filters": (k, p²·c), "img_channels": int,
    "whitener": {"whitener", "means"} or None, "normalize_patches": bool,
    "var_constant": float}``
  - ``KernelBlockLinearMapper``: ``{"w_locals": [(block_size, k), ...],
    "block_size": int, "train_X": (n_train, d), "gamma": float,
    "kernel_dtype": "f32" or "bf16"}`` (the reference's train rows may
    carry padding rows past ``n_train``; pass the first ``n_train``)
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.images.conv import Convolver
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.kernel import (
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
)
from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.ops.learning.pca import ZCAWhitener
from keystone_tpu_torch.ops.learning.streaming_ls import (
    CosineBankFeaturize,
    StreamingFeaturizedLinearModel,
)
from keystone_tpu_torch.ops.stats import CosineRandomFeaturesModel, StandardScalerModel


def _f32(x, device) -> torch.Tensor:
    return as_tensor(np.asarray(x, dtype=np.float32), device)


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


def streaming_linear_model(
    W_stack, fmean, ymean, Wrf, brf, tile_rows: int, device=None
) -> StreamingFeaturizedLinearModel:
    """The reference's fitted streamed model (a ``StreamingFeaturizedLinearModel``
    over a ``CosineBankFeaturize``), rebuilt in the port."""
    device = resolve_device(device)
    return StreamingFeaturizedLinearModel(
        CosineBankFeaturize(_f32(Wrf, device), _f32(brf, device)),
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
    if {"whitener", "means"} <= keys:
        return zca_whitener(params["whitener"], params["means"], device)
    if "W_stack" in keys:
        return streaming_linear_model(
            params["W_stack"], params.get("fmean"), params.get("ymean"), params["Wrf"],
            params["brf"], params["tile_rows"], device,
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
    raise ValueError(f"no port module takes the parameters {sorted(keys)}")
