"""SE(3) utilities (port of core/lie.py, the parts the port uses).

Homogeneous transforms are (..., 4, 4) with points as column vectors,
composed left to right. Small matrix products are written as broadcast sums,
so they run in full float32 (or float64) on any device whatever the TF32
settings.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small matrix product (..., n, k) @ (..., k, m) as a broadcast
    sum (no TF32)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, k) @ (..., k)."""
    return (a * v.unsqueeze(-2)).sum(-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def so3_orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) by Gram-Schmidt on the rows."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms without a linear solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -mv(Rt, T[..., :3, 3]))


def se3_compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1 @ T2 for (..., 4, 4)."""
    return mm(T1, T2)


def se3_chain(relative: torch.Tensor, initial: torch.Tensor | None = None) -> torch.Tensor:
    """Cumulative products: abs[i] = initial @ rel[0] @ ... @ rel[i] for
    (N, 4, 4) relatives (a sequential prefix product)."""
    out = []
    cur = initial
    for i in range(relative.shape[0]):
        cur = relative[i] if cur is None else se3_compose(cur, relative[i])
        out.append(cur)
    return torch.stack(out)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1).reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3) by Rodrigues' formula,
    with the Taylor series near theta = 0 (safe to differentiate)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * mm(W, W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> transform (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    W = hat(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return se3_matrix(R, mv(V, v))
