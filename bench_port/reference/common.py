"""Plain tensor helpers of the reference: rounding for the control, small
matrix products, SE(3), the pinhole camera, separable filters and a stable
top-k."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


class Precision:
    """Where the reference rounds. The sound reference (``lower=False``)
    rounds nothing beyond what the configuration states; the control
    (``lower=True``) rounds each network operand to fp8 e4m3 (scaled per
    tensor to its largest magnitude) in place of bf16, and each float32
    stage's intermediate values to bf16."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def net(self, x: torch.Tensor) -> torch.Tensor:
        """A network operand: bf16 as configured, fp8 e4m3 in the control
        (returned in bf16, which holds every e4m3 value)."""
        if not self.lower:
            return x.to(torch.bfloat16)
        xf = x.float()
        scale = torch.clamp(xf.abs().amax(), min=1e-30) / FP8_MAX
        return ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)

    def f32(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 stage's value: as is, or rounded to bf16 in the control."""
        return x.to(torch.bfloat16).float() if self.lower else x


SOUND = Precision(False)


def mm(a, b):
    """Small batched matrix product as a broadcast sum (no TF32 path)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def mv(a, v):
    return (a * v.unsqueeze(-2)).sum(-1)


def se3_matrix(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -mv(Rt, T[..., :3, 3]))


def hat(w):
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1).reshape(w.shape[:-1] + (3, 3))


def se3_exp(xi):
    """Twist (..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-12))
    small = th2 < 1e-8
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / th2)
    W = hat(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return se3_matrix(R, mv(V, v))


def so3_orthonormalize(R):
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], dim=-2)


def se3_chain(rel):
    """abs[i] = rel[0] @ ... @ rel[i]."""
    out, cur = [], None
    for i in range(rel.shape[0]):
        cur = rel[i] if cur is None else mm(cur, rel[i])
        out.append(cur)
    return torch.stack(out)


class Camera:
    """Pinhole intrinsics (fx, fy, cx, cy) and Brown-Conrady distortion
    (k1, k2, p1, p2, k3) as 0-d float32 tensors on one device."""

    def __init__(self, K, dist, device):
        K = np.asarray(K, np.float64)
        t = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
        self.fx, self.fy, self.cx, self.cy = t(K[0, 0]), t(K[1, 1]), t(K[0, 2]), t(K[1, 2])
        d = np.zeros(5) if dist is None else np.asarray(dist, np.float64)
        self.dist = torch.as_tensor(d, dtype=torch.float32, device=device)


def distort(xn, dist):
    k1, k2, p1, p2, k3 = dist.unbind(0)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    return torch.stack([x * rad + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x),
                        y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy], dim=-1)


def undistort_points(pts, cam: Camera, iters: int = 5):
    xn = (pts - torch.stack([cam.cx, cam.cy])) / torch.stack([cam.fx, cam.fy])
    x = xn
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    for _ in range(iters):
        xs, ys = x[..., 0], x[..., 1]
        r2 = xs * xs + ys * ys
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xs * ys + p2 * (r2 + 2.0 * xs * xs)
        dy = p1 * (r2 + 2.0 * ys * ys) + 2.0 * p2 * xs * ys
        x = (xn - torch.stack([dx, dy], dim=-1)) / rad[..., None]
    return x


def project(pc, cam: Camera):
    z = pc[..., 2:3]
    xn = distort(pc[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z), cam.dist)
    return xn * torch.stack([cam.fx, cam.fy]) + torch.stack([cam.cx, cam.cy])


def backproject(xy, depth, cam: Camera):
    return torch.stack([(xy[..., 0] - cam.cx) / cam.fx * depth, (xy[..., 1] - cam.cy) / cam.fy * depth, depth], -1)


def top_k(values, k: int):
    """The k largest along the last dim, equal values in index order."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _filter1d(img, k, dim):
    r = k.shape[0] // 2
    p = F.pad(img, (r, r, 0, 0) if dim == -1 else (0, 0, r, r))
    out = None
    for i in range(k.shape[0]):
        tap = p.narrow(dim, i, img.shape[dim]) * k[i]
        out = tap if out is None else out + tap
    return out


def conv2d_separable(img, kx, ky):
    """SAME separable filter, rows with ``ky`` then columns with ``kx``,
    taps summed one at a time in float32."""
    kx = torch.as_tensor(kx, dtype=torch.float32, device=img.device)
    ky = torch.as_tensor(ky, dtype=torch.float32, device=img.device)
    return _filter1d(_filter1d(img.float(), ky, -2), kx, -1)


def sobel(img):
    return conv2d_separable(img, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0]), conv2d_separable(img, [1.0, 2.0, 1.0],
                                                                                   [-1.0, 0.0, 1.0])


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    return conv2d_separable(img, k, k)


def box_sum(img, size: int):
    return conv2d_separable(img, [1.0] * size, [1.0] * size)


def maxpool_same(img, size: int):
    shape = img.shape
    return F.max_pool2d(img.reshape(-1, 1, *shape[-2:]), size, stride=1, padding=size // 2).reshape(shape)


def resize_bilinear(img, height: int, width: int):
    """Half-pixel bilinear resize, antialiased on a downsample."""
    shape = img.shape
    down = height < shape[-2] or width < shape[-1]
    out = F.interpolate(img.float().reshape(-1, 1, *shape[-2:]), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=down)
    return out.reshape(*shape[:-2], height, width)
