"""Image representation and utilities.

Port of ``keystone_tpu/utils/images.py``, the part that the image nodes of
``ops/images/`` call. An image is a dense ``(x, y, channel)`` float tensor
and a batch is ``(n, x, y, channel)``, the reference's layout: axis 0 is
the reference's ``x`` index and axis 1 its ``y``, so ``img[x, y, c]``
matches ``Image.get(x, y, c)`` (reference: utils/images/Image.scala,
utils/ImageUtils.scala). The filters take one image or a batch: every
axis before the last three is a batch axis.

``load_image`` decodes a file or byte buffer through PIL for the image
loaders (numpy out, a loader-side step). Not ported yet:
``ImageMetadata``.
"""

from __future__ import annotations

import io
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from keystone_tpu_torch.data.dataset import as_tensor

def load_image(source: Union[str, bytes]) -> np.ndarray:
    """Decode an image file or byte buffer to an (x, y, c) float32 numpy
    array (the reference's javax.imageio path, utils/ImageUtils.scala)."""
    from PIL import Image as PILImage

    if isinstance(source, (bytes, bytearray)):
        pil = PILImage.open(io.BytesIO(source))
    else:
        pil = PILImage.open(source)
    arr = np.asarray(pil, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


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


def stack_images(data, device) -> torch.Tensor:
    """The (n, x, y, c) float32 tensor on ``device`` of a host dataset of
    labeled images (items with an ``image``)."""
    stack = np.stack([np.asarray(item.image, dtype=np.float32) for item in data.to_list()])
    return torch.from_numpy(stack).to(device)


def _planes(img: torch.Tensor) -> torch.Tensor:
    """(..., x, y, c) -> (B·c, 1, x, y): one single-channel plane a row."""
    x, y, c = img.shape[-3:]
    return img.reshape(-1, x, y, c).permute(0, 3, 1, 2).reshape(-1, 1, x, y)


def _unplanes(planes: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_planes` for output planes of a new spatial size."""
    c = like.shape[-1]
    x, y = planes.shape[-2:]
    out = planes.reshape(-1, c, x, y).permute(0, 2, 3, 1)
    return out.reshape(like.shape[:-3] + (x, y, c))


def conv2d_valid(img, kernel) -> torch.Tensor:
    """Per-channel 2-D valid cross-correlation of (..., x, y, c) images with
    one (kx, ky) kernel (ImageUtils.conv2D)."""
    img = as_float(img)
    kernel = as_tensor(kernel, img.device).to(img.dtype)
    out = F.conv2d(_planes(img), kernel[None, None])
    return _unplanes(out, img)


def separable_conv2d_same(img, x_filter, y_filter) -> torch.Tensor:
    """Separable same-size true convolution with zero padding, matching the
    reference's ImageUtils.conv2D (utils/images/ImageUtils.scala:226-320):
    the kernels are flipped (convolution, not correlation) and the output
    has the input's spatial size."""
    img = as_float(img)
    if img.ndim == 2:
        img = img[:, :, None]
    kx = torch.flip(as_tensor(x_filter, img.device).to(img.dtype), dims=[0])
    ky = torch.flip(as_tensor(y_filter, img.device).to(img.dtype), dims=[0])
    lx, ly = kx.shape[0], ky.shape[0]
    planes = _planes(img)
    planes = F.pad(planes, (0, 0, (lx - 1) // 2, lx - 1 - (lx - 1) // 2))
    planes = F.conv2d(planes, kx[None, None, :, None])
    planes = F.pad(planes, ((ly - 1) // 2, ly - 1 - (ly - 1) // 2, 0, 0))
    return _unplanes(F.conv2d(planes, ky[None, None, None, :]), img)


def gaussian_kernel_1d(sigma: float, radius: Optional[int] = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float) -> torch.Tensor:
    """Separable Gaussian smoothing with edge replication (the role of
    vl_imsmooth_f in the reference's native SIFT path,
    src/main/cpp/VLFeat.cxx:38-180), in float32."""
    img = as_tensor(img)
    if sigma <= 0:
        return img
    img = img.to(torch.float32)
    k = torch.from_numpy(gaussian_kernel_1d(sigma)).to(img.device)
    r = (k.shape[0] - 1) // 2
    planes = F.pad(_planes(img), (0, 0, r, r), mode="replicate")
    planes = F.conv2d(planes, k[None, None, :, None])
    planes = F.pad(planes, (r, r, 0, 0), mode="replicate")
    return _unplanes(F.conv2d(planes, k[None, None, None, :]), img)


def crop_to_multiple(img, multiple: int = 8):
    """Center-crop the spatial dims down to multiples of ``multiple``; an
    axis shorter than one multiple stays as it is. The reference buckets
    real-image archives this way so that images of similar size share
    compiled programs; here it keeps the same crops, so both packages see
    the same pixels. Numpy in, numpy out (a loader-side step)."""
    img = np.asarray(img)
    h, w = img.shape[0], img.shape[1]
    nh = (h // multiple) * multiple or h
    nw = (w // multiple) * multiple or w
    if nh == h and nw == w:
        return img
    top = (h - nh) // 2
    left = (w - nw) // 2
    return img[top:top + nh, left:left + nw]
