"""Separable image filters (port of utils/filters.py, the parts the port uses).

Filters are written as sums of shifted slices rather than float32
convolutions, so no TF32 rounding can enter on the card whatever
``torch.backends.cudnn.allow_tf32`` says.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _filter1d(img: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """SAME cross-correlation of (..., H, W) with a 1D odd kernel along
    ``dim`` (-2 rows, -1 cols); zero padding."""
    n = k.shape[0]
    r = n // 2
    pad = (r, r, 0, 0) if dim == -1 else (0, 0, r, r)
    p = F.pad(img, pad)
    size = img.shape[dim]
    out = None
    for i in range(n):
        tap = p.narrow(dim, i, size) * k[i]
        out = tap if out is None else out + tap
    return out


def conv2d_separable(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """Separable SAME convolution of (..., H, W): rows with ``ky`` then
    columns with ``kx`` (the JAX helper's order)."""
    kx = torch.as_tensor(kx, dtype=torch.float32, device=img.device)
    ky = torch.as_tensor(ky, dtype=torch.float32, device=img.device)
    return _filter1d(_filter1d(img.float(), ky, -2), kx, -1)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """7x7 sigma-2 by default: the smoothing ORB applies before BRIEF."""
    k = gaussian_kernel1d(sigma, radius)
    return conv2d_separable(img, k, k)


def box_filter(img: torch.Tensor, size: int, normalize: bool = True) -> torch.Tensor:
    k = [1.0 / size if normalize else 1.0] * size
    return conv2d_separable(img, k, k)


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (dx, dy) with OpenCV's 3x3 kernels."""
    deriv = [-1.0, 0.0, 1.0]
    smooth = [1.0, 2.0, 1.0]
    return conv2d_separable(img, deriv, smooth), conv2d_separable(img, smooth, deriv)


def maxpool2d_same(img: torch.Tensor, size: int) -> torch.Tensor:
    """Max over a size x size window centred on each pixel of (..., H, W)
    (padding never wins)."""
    r = size // 2
    shape = img.shape
    x = img.reshape(-1, 1, shape[-2], shape[-1])
    return F.max_pool2d(x, size, stride=1, padding=r).reshape(shape)


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with half-pixel centres, antialiased
    when it downsamples: ``jax.image.resize(..., "linear")``, which widens
    its triangle kernel by the scale factor on a downsample. An upsample
    takes the plain bilinear weights: PyTorch's antialiased path rounds them
    differently (1.8e-3 off jax on 0-255 images at 160x224 -> 448x640,
    against 3e-5 for the plain path)."""
    shape = img.shape
    x = img.float().reshape(-1, 1, shape[-2], shape[-1])
    down = height < shape[-2] or width < shape[-1]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=down)
    return out.reshape(*shape[:-2], height, width)


def map_coordinates_linear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(img, [y, x], order=1,
    mode="nearest")`` over a batch: sample (B, H, W) images, or (B, H, W, C)
    grids with channels last, at (B, H', W') coordinates -> (B, H', W'[,
    C]). Each of the four taps clamps its own index to the edge, so a
    coordinate past the border reads the edge value; the weights and the
    sum are taken in the reference's order."""
    B, H, W = img.shape[:3]
    chan = img.dim() == 4
    flat = img.reshape(B, H * W, -1) if chan else img.reshape(B, H * W)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    taps_y = ((y0.long(), 1 - wy1), (y0.long() + 1, wy1))
    taps_x = ((x0.long(), 1 - wx1), (x0.long() + 1, wx1))
    out = None
    for iy, wy in taps_y:
        for ix, wx in taps_x:
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, -1)
            if chan:
                vals = flat.gather(1, idx[..., None].expand(-1, -1, flat.shape[-1])).reshape(*y.shape, -1)
                term = (wy * wx)[..., None] * vals
            else:
                term = (wy * wx) * flat.gather(1, idx).reshape(y.shape)
            out = term if out is None else out + term
    return out
