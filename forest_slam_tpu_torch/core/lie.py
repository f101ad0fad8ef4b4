"""SO(3), SE(3) and quaternion utilities (port of core/lie.py).

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
    # made on the device (a tensor from a host list is a copy that waits for the stream)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:].expand(batch + (1, 4))
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


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) scaled to unit norm."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 of (..., 4) quaternions in [x, y, z, w]."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) [x, y, z, w], normalised first -> rotation (..., 3, 3)."""
    x, y, z, w = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) (or the rotation block of (..., 4, 4)) ->
    quaternion [x, y, z, w] with w >= 0: Shepperd's four candidates, the one
    of the largest pivot among (trace, R00, R11, R22) (the first on a tie)."""
    R = R[..., :3, :3]
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    s_t = safe_sqrt(tr + 1.0) * 2.0
    q_t = torch.stack([(m21 - m12) / s_t, (m02 - m20) / s_t, (m10 - m01) / s_t, 0.25 * s_t], dim=-1)
    s_x = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q_x = torch.stack([0.25 * s_x, (m01 + m10) / s_x, (m02 + m20) / s_x, (m21 - m12) / s_x], dim=-1)
    s_y = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q_y = torch.stack([(m01 + m10) / s_y, 0.25 * s_y, (m12 + m21) / s_y, (m02 - m20) / s_y], dim=-1)
    s_z = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q_z = torch.stack([(m02 + m20) / s_z, (m12 + m21) / s_z, 0.25 * s_z, (m10 - m01) / s_z], dim=-1)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([q_t, q_x, q_y, q_z], dim=-2)  # (..., 4, 4)
    q = quat_normalize(cands.gather(-2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :])
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def se3_orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-rigidify (..., 4, 4): R projected onto SO(3), t kept, row 3 clean."""
    return se3_matrix(so3_orthonormalize(T[..., :3, :3]), T[..., :3, 3])


def se3_transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) applied to points (..., N, 3) -> (..., N, 3)."""
    return mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), differentiable
    everywhere: the small-angle (cos theta > 1 - 1e-6, compared in R's
    dtype) and near-pi (theta > pi - 1e-3) branches guard the untaken
    branch's arccos and sqrt with a second ``where``, so no non-finite
    tangent leaks through. Near pi the axis comes from the symmetric part,
    its signs from the off-diagonal sums."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = cos_theta > 1.0 - 1e-6  # the threshold must exceed float32's ulp at 1
    cos_safe = torch.where(small, torch.zeros_like(cos_theta), cos_theta)
    theta_big = torch.arccos(cos_safe)
    theta_small = 0.5 * torch.sqrt((v * v).sum(-1) + _EPS)
    theta = torch.where(small, theta_small, theta_big)
    scale = torch.where(small, 0.5 + theta_small * theta_small / 12.0,
                        theta_big / torch.clamp(2.0 * torch.sin(theta_big), min=_EPS))
    w = scale[..., None] * v
    near_pi = theta > torch.pi - 1e-3
    diag = R.diagonal(dim1=-2, dim2=-1)
    c = cos_theta[..., None]
    axis = torch.sqrt(torch.clamp((diag - c) / torch.clamp(1 - c, min=_EPS), min=0.0) + _EPS)
    sign1 = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, 1.0, -1.0)
    sign2 = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, 1.0, -1.0)
    axis_signed = torch.stack([axis[..., 0], sign1 * axis[..., 1], sign2 * axis[..., 2]], dim=-1)
    return torch.where(near_pi[..., None], axis_signed * theta[..., None], w)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Transform (..., 4, 4) -> twist (..., 6) [v, w], with
    V^-1 = I - W/2 + (1 - A / 2B) / theta^2 W^2 (its series near 0)."""
    w = so3_log(T[..., :3, :3])
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=_EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + D[..., None, None] * mm(W, W)
    return torch.cat([mv(Vinv, T[..., :3, 3]), w], dim=-1)
