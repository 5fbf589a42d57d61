"""Image representation and utilities.

Port of ``keystone_tpu/utils/images.py``, the part that the image nodes of
``ops/images/conv.py`` and ``ops/images/core.py`` call. An image is a dense
``(x, y, channel)`` float tensor and a batch is ``(n, x, y, channel)``, the
reference's layout: axis 0 is the reference's ``x`` index and axis 1 its
``y``, so ``img[x, y, c]`` matches ``Image.get(x, y, c)``
(reference: utils/images/Image.scala, utils/ImageUtils.scala).

Not ported yet (they wait for the SIFT/HOG slice): ``ImageMetadata``,
``load_image``, ``conv2d_valid``, ``separable_conv2d_same``,
``gaussian_blur`` and ``crop_to_multiple``.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.data.dataset import as_tensor

# MATLAB rgb2gray / NTSC weights, exactly as the reference spells them
# (ImageUtils.toGrayScale: 0.2989 R + 0.5870 G + 0.1140 B on BGR data; these
# arrays are RGB, so the weights apply in R, G, B order).
_LUMA = (0.2989, 0.5870, 0.1140)


def as_float(img) -> torch.Tensor:
    """Promote to float32 unless the input is already float32 or wider
    (half-precision and integer images accumulate in float32)."""
    img = as_tensor(img)
    if not img.is_floating_point() or torch.finfo(img.dtype).bits < 32:
        img = img.to(torch.float32)
    return img


def to_grayscale(img) -> torch.Tensor:
    """(..., x, y, c) -> (..., x, y, 1) luminance (ImageUtils.toGrayScale)."""
    img = as_float(img)
    if img.shape[-1] == 1:
        return img
    if img.shape[-1] == 3:
        luma = torch.tensor(_LUMA, dtype=img.dtype, device=img.device)
        return (img @ luma)[..., None]
    return img.mean(dim=-1, keepdim=True)


def crop(img, start_x: int, start_y: int, end_x: int, end_y: int) -> torch.Tensor:
    """Crop [start_x, end_x) × [start_y, end_y) (ImageUtils.crop)."""
    return as_tensor(img)[start_x:end_x, start_y:end_y, :]


def flip_horizontal(img) -> torch.Tensor:
    """Mirror along the y (second) axis (ImageUtils.flipHorizontal)."""
    return torch.flip(as_tensor(img), dims=[1])


def flip_image(img) -> torch.Tensor:
    """Flip both spatial axes AND channels (ImageUtils.flipImage reverses x,
    y and c, MATLAB convnd-style, ImageUtils.scala:376-389; used to flip
    convolution filters)."""
    return torch.flip(as_tensor(img), dims=[0, 1, 2])
