"""Pinhole camera with Brown-Conrady distortion (port of core/camera.py).
Point ops are batched over leading dims (..., N, 2/3); :func:`remap_bilinear`
and :func:`undistort_image` over the leading dims of their images.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    """Intrinsics + distortion: ``K`` (3, 3), ``dist`` (5,) [k1, k2, p1, p2, k3]."""

    K: torch.Tensor
    dist: torch.Tensor
    width: int
    height: int

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    @classmethod
    def create(cls, K, dist=None, width: int = 0, height: int = 0, device="cuda",
               dtype=torch.float32) -> "PinholeCamera":
        K = torch.as_tensor(np.asarray(K, np.float64), dtype=dtype, device=device)
        d = np.zeros(5, np.float64)
        if dist is not None:
            dist = np.asarray(dist, np.float64).reshape(-1)
            d[: dist.shape[0]] = dist
        return cls(K=K, dist=torch.as_tensor(d, dtype=dtype, device=device), width=width, height=height)


class StereoRig(NamedTuple):
    """``T_left_right`` maps right-camera coordinates into the left camera."""

    left: PinholeCamera
    right: PinholeCamera
    T_left_right: torch.Tensor  # (4, 4)

    @property
    def baseline(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.T_left_right[:3, 3])


def distort_points(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown-Conrady distortion of normalised points (..., 2)."""
    k1, k2, p1, p2, k3 = dist.unbind(0)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_points(pts: torch.Tensor, cam: PinholeCamera, iters: int = 5) -> torch.Tensor:
    """Pixel points (..., 2) -> undistorted normalised points (..., 2)."""
    c = torch.stack([cam.cx, cam.cy])
    f = torch.stack([cam.fx, cam.fy])
    xn = (pts - c) / f
    x = xn
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    for _ in range(iters):
        xs, ys = x[..., 0], x[..., 1]
        r2 = xs * xs + ys * ys
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xs * ys + p2 * (r2 + 2.0 * xs * xs)
        dy = p1 * (r2 + 2.0 * ys * ys) + 2.0 * p2 * xs * ys
        x = (xn - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return x


def project_points(pts3d: torch.Tensor, cam: PinholeCamera, with_distortion: bool = True) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coordinates (..., 2)."""
    z = pts3d[..., 2:3]
    xn = pts3d[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    if with_distortion:
        xn = distort_points(xn, cam.dist)
    return xn * torch.stack([cam.fx, cam.fy]) + torch.stack([cam.cx, cam.cy])


def backproject_depth(pts2d: torch.Tensor, depth: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Pixels (..., 2) + depths (...,) -> camera-frame points (..., 3)."""
    x = (pts2d[..., 0] - cam.cx) / cam.fx * depth
    y = (pts2d[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def remap_bilinear(image: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Bilinear remap: sample ``image`` (..., H, W) at ``src_map`` (..., H',
    W', 2) of (x, y) coordinates, leading dims broadcast; samples outside
    the image are 0 (OpenCV's BORDER_CONSTANT), as core/camera.py's
    ``remap_bilinear`` on an (H, W) image. Float32, differentiable in the
    image and the map."""
    H, W = image.shape[-2:]
    img = image.float()
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    lead = torch.broadcast_shapes(img.shape[:-2], x.shape[:-2])
    flat = img.expand(lead + (H, W)).reshape(lead + (H * W,))

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).expand(lead + x.shape[-2:])
        vals = flat.gather(-1, idx.reshape(lead + (-1,))).reshape(idx.shape)
        return torch.where(inside, vals, torch.zeros_like(vals))

    return (gather(y0i, x0i) * (1 - fx) * (1 - fy) + gather(y0i, x0i + 1) * fx * (1 - fy)
            + gather(y0i + 1, x0i) * (1 - fx) * fy + gather(y0i + 1, x0i + 1) * fx * fy)


def undistort_map(cam: PinholeCamera) -> torch.Tensor:
    """(H, W, 2) dst -> src sampling grid of (x, y) source pixels, as
    ``cv2.initUndistortRectifyMap`` builds it: each destination pixel
    normalised with K, distorted, reprojected with K."""
    dev = cam.K.device
    grid_y, grid_x = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=dev),
                                    torch.arange(cam.width, dtype=torch.float32, device=dev), indexing="ij")
    xn = torch.stack([(grid_x - cam.cx) / cam.fx, (grid_y - cam.cy) / cam.fy], dim=-1)
    xd = distort_points(xn, cam.dist)
    return torch.stack([xd[..., 0] * cam.fx + cam.cx, xd[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_image(image: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Undistort (..., H, W) images (the map built inline; a pipeline builds
    it once per calibration with :func:`undistort_map`)."""
    return remap_bilinear(image, undistort_map(cam))


def bgr_to_gray(image: torch.Tensor) -> torch.Tensor:
    """BGR (..., H, W, 3) -> gray (..., H, W) float32 with OpenCV's luma
    weights (stereo_slam.py:186, ``cv2.COLOR_BGR2GRAY``)."""
    img = image.float()
    return img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299
