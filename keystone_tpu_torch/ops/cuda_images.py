"""The image featurizer's hand-written CUDA kernel, with its plain PyTorch
version.

Port of ``keystone_tpu/ops/pallas_images.py``: :func:`conv_featurize` ↔
``pallas_images.conv_featurize`` (``csrc/conv_featurize.cu``), the whole
CIFAR featurization of ``Convolver`` in one kernel — im2col, per-patch
mean/variance normalisation, whitening-mean subtraction and the filter
product, with the patch matrix kept in shared memory and never written to
device memory. Patch columns are row-major over ``(px, py, c)``, the
contract of ``ops/images/conv.py``'s ``im2col`` and
``Convolver.pack_filters``.

The wrapper follows ``ops/cuda_ops.py``'s contract: for tensors on the CPU
it computes the plain version (:func:`conv_featurize_ref`, the reference's
XLA branch of ``Convolver._convolve``); for CUDA tensors it launches the
kernel or raises, and counts the launch in ``cuda_ops.launches
["conv_featurize"]``. The kernel is built and loaded by ``cuda_ops`` with
the others. :func:`conv_featurize_ok` is its guard, sized for the 227 KB
of shared memory one H100 block may use.
"""

from __future__ import annotations

from typing import Optional

import torch

from keystone_tpu_torch.ops import cuda_ops

# Shared memory one block of an H100 may use (232,448 bytes of the SM's 256 KB).
_SMEM_LIMIT_BYTES = 227 * 1024
# Tile constants of csrc/conv_featurize.cu: output pixels per tile, filters
# per register pass.
_PIXEL_TILE, _FILTER_PASS = 64, 128


def im2col(images, patch_size: int):
    """(n, X, Y, C) -> (n, X', Y', patch_size²·C) patches, flattened
    row-major over (px, py, c)."""
    n, X, Y, C = images.shape
    p = patch_size
    xo, yo = X - p + 1, Y - p + 1
    # (n, xo, Y, C, px) -> (n, xo, yo, C, px, py): two views, no copy yet.
    windows = images.unfold(1, p, 1).unfold(2, p, 1)
    return windows.permute(0, 1, 2, 4, 5, 3).reshape(n, xo, yo, p * p * C)


def normalize_patch_rows(patches, var_constant: float):
    """Per-patch mean/variance normalization, the reference's
    Stats.normalizeRows (utils/Stats.scala:112-123): subtract the mean,
    divide by sqrt(var + alpha) with the (d-1) variance denominator."""
    d = patches.shape[-1]
    centered = patches - patches.mean(dim=-1, keepdim=True)
    var = (centered * centered).sum(dim=-1, keepdim=True) / (d - 1.0)
    return centered / torch.sqrt(var + var_constant)


def conv_featurize_ref(images, filters, means=None, *, patch_size: int,
                       normalize_patches: bool = True, var_constant: float = 10.0):
    """Plain PyTorch version of :func:`conv_featurize`, in float32: the
    patch matrix made whole, normalised, centred on the whitening means and
    multiplied by the filters."""
    patches = im2col(images.to(torch.float32), patch_size)
    if normalize_patches:
        patches = normalize_patch_rows(patches, var_constant)
    if means is not None:
        patches = patches - means.to(torch.float32)
    return patches @ filters.to(torch.float32).T


def _smem_bytes(X: int, Y: int, C: int, p: int, k: int) -> int:
    """Shared memory one block of the kernel needs (csrc/conv_featurize.cu's
    ``smem_bytes``): the pixel tile's patch rows, the filters transposed and
    padded to a whole register pass, the image, the means and the tile's
    per-pixel mean and deviation."""
    d = p * p * C
    kp = -(-k // _FILTER_PASS) * _FILTER_PASS
    return 4 * (d * _PIXEL_TILE + d * kp + X * Y * C + d + 2 * _PIXEL_TILE)


def conv_featurize_ok(images, filters) -> bool:
    """Whether the kernel takes these operands (counterpart of
    ``pallas_images.conv_featurize_ok``, whose budget is the TPU's VMEM): a
    batch of images (n, X, Y, C), square p x p x C filters (k, p²·C) no
    larger than the images, and one block's working set within the
    227 KB of shared memory an H100 block may use."""
    if images.dim() != 4 or filters.dim() != 2:
        return False
    _, X, Y, C = images.shape
    k, d = filters.shape
    p = int(round((d / max(C, 1)) ** 0.5))
    if C < 1 or p < 1 or p * p * C != d or X < p or Y < p:
        return False
    return _smem_bytes(X, Y, C, p, k) <= _SMEM_LIMIT_BYTES


def conv_featurize(images, filters, means: Optional[torch.Tensor] = None, *,
                   patch_size: int, normalize_patches: bool = True,
                   var_constant: float = 10.0):
    """Fused im2col + normalize + whiten-center + filter product.

    images: (n, X, Y, C), taken as float32 (the reference narrows its
    float64 loader output the same way); filters: (k, p²·C) packed rows
    (the ``Convolver.pack_filters`` layout); means: optional (p²·C,)
    whitening means. Returns (n, X−p+1, Y−p+1, k) float32. On a CUDA tensor
    a shape the guard :func:`conv_featurize_ok` refuses raises.
    """
    operands = [images, filters] + ([] if means is None else [means])
    if all(t.device.type == "cpu" for t in operands):
        return conv_featurize_ref(images, filters, means, patch_size=patch_size,
                                  normalize_patches=normalize_patches,
                                  var_constant=var_constant)
    name = "conv_featurize"
    device = cuda_ops._cuda_operands(name, operands)
    if not conv_featurize_ok(images, filters):
        raise ValueError(
            f"{name}: images {tuple(images.shape)} and filters {tuple(filters.shape)} "
            "are not a batch of (n, X, Y, C) images and (k, p*p*C) filters whose "
            f"working set fits the {_SMEM_LIMIT_BYTES} bytes of shared memory of a block"
        )
    n, X, Y, C = images.shape
    k, d = filters.shape
    p = int(patch_size)
    if p * p * C != d:
        raise ValueError(f"{name}: patch_size {p} does not match filters of width {d}")
    img = images.to(torch.float32).contiguous()
    flt = filters.to(torch.float32).contiguous()
    mn = None
    if means is not None:
        mn = means.to(torch.float32).contiguous()
        if mn.shape != (d,):
            raise ValueError(f"{name}: means {tuple(means.shape)} must be ({d},)")
    out = torch.empty((n, X - p + 1, Y - p + 1, k), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    fn = cuda_ops._lib(name).kt_conv_featurize
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cuda_ops.launches[name] += 1
        err = fn(
            img.data_ptr(), flt.data_ptr(), None if mn is None else mn.data_ptr(),
            out.data_ptr(), n, X, Y, C, p, k, int(bool(normalize_patches)),
            float(var_constant), stream,
        )
    cuda_ops._check_launch(name, err)
    return out
