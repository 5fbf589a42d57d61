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
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
from keystone_tpu_torch.ops.learning.linear import LinearMapper
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


def params_from_jax(params: Mapping[str, Any], device=None):
    """Build the port's module from one reference module's parameters (see
    the module docstring for the keys of each)."""
    keys = set(params)
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
