"""Bundle adjustment: Levenberg-Marquardt with a Schur complement (port of
backend/ba.py), batched over problems.

A problem is M poses T_cw (x_cam = T_cw @ x_world), P landmarks and a dense
(M, P) observation grid with a mask. Each observation has a 3-row residual:
the pixel error of the distorted projection, and a relative-depth row
``depth_weight * (z - z_meas) / z_meas`` where a stereo depth was measured
(it pins the metric scale that pixel-only BA leaves free). Options: a prior
pulling each pose toward its initial value, Huber IRLS weights on the pixel
norm, and 1e12 diagonal damping on pose 0 as the gauge.

The per-observation Jacobian blocks (3x6 in the pose's left twist, 3x3 in
the point) are analytic: at zero update d pc = [I, -hat(pc)] d xi and
d pc = R d X, through the distorted projection's Jacobian
(geometry/pnp.py:_projection_jacobian); tests/test_torch_ba.py holds them
to ``jax.jacfwd`` of the JAX residual. The landmark blocks are eliminated
with batched 3x3 inverses, leaving a dense 6M x 6M pose system solved by
LU; an LM step is accepted when the cost falls (lambda * 0.3) and rejected
otherwise (lambda * 4). The prior's residual is taken in float64, and only
with a prior: the JAX package's float32 ``se3_log`` returns NaN for
rotations between 1e-4 and 3.5e-4 rad, and its prior term, weighted by
zero, then rejects the step (ROADMAP Queue C). Every tensor carries a leading batch axis of
independent problems (the sliding windows of backend/window.py), each with
its own lambda and accept flags. The large contractions are float32
matmuls: they run at full precision unless the caller enables TF32
(PyTorch's default leaves it off, and chip_smoke.py pins it off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, project_points
from forest_slam_tpu_torch.core.lie import mm, se3_compose, se3_exp, se3_inverse, se3_log
from forest_slam_tpu_torch.geometry.pnp import _projection_jacobian


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (..., M, 4, 4) T_cw
    points: torch.Tensor  # (..., P, 3) world
    observations: torch.Tensor  # (..., M, P, 2) pixels
    mask: torch.Tensor  # (..., M, P) bool
    cam: PinholeCamera
    depths: torch.Tensor | None = None  # (..., M, P) measured z, or None for pixel-only BA
    depth_mask: torch.Tensor | None = None  # (..., M, P) bool
    depth_weight: float = 25.0  # relative depth -> pixel-equivalent scale
    pose_prior_weight: float = 0.0  # residual w * se3_log(T @ inv(T_init)) per pose; 0 = off
    huber_px: float = 0.0  # Huber threshold on the pixel-residual norm; 0 = squared loss


class BAResult(NamedTuple):
    poses: torch.Tensor  # (..., M, 4, 4)
    points: torch.Tensor  # (..., P, 3)
    initial_cost: torch.Tensor  # (...)
    final_cost: torch.Tensor  # (...)


def _camera_points(poses, points):
    """(B, M, P, 3) camera-frame points of (B, P, 3) under (B, M, 4, 4)."""
    R = poses[:, :, None, :3, :3]
    return (R * points[:, None, :, None, :]).sum(-1) + poses[:, :, None, :3, 3]


def residual_blocks(poses, points, obs, z, has_z, w_z: float, cam: PinholeCamera):
    """Residuals r (B, M, P, 3) and Jacobian blocks Jp (B, M, P, 3, 6),
    Jx (B, M, P, 3, 3) at zero update, of the JAX residual
    ``[project(exp(xi) T (X + dX)) - obs, w_z (z - z_meas) / z_meas * has_z]``."""
    pc = _camera_points(poses, points)
    r_px = project_points(pc, cam, with_distortion=True) - obs
    zs = torch.clamp(z, min=1e-6)
    scale = w_z / zs * has_z
    r_z = (pc[..., 2] - z) * scale
    J6 = _projection_jacobian(pc, cam)  # (B, M, P, 2, 6): d pixel / d left twist
    X, Y, Z = pc.unbind(-1)
    zero = torch.zeros_like(X)
    # d z / d xi = [0, 0, 1, -hat(pc)[2]] = [0, 0, 1, Y, -X, 0]
    jz = torch.stack([zero, zero, torch.ones_like(X), Y, -X, zero], -1) * scale[..., None]
    Jp = torch.cat([J6, jz[..., None, :]], dim=-2)
    R = poses[:, :, None, :3, :3]
    Jx = mm(Jp[..., :3], R)  # d r / d pc @ d pc / d X
    return torch.cat([r_px, r_z[..., None]], dim=-1), Jp, Jx


def huber_weight(r_norm, delta: float):
    """IRLS weight of the Huber loss: 1 inside delta, delta/||r|| outside;
    delta <= 0 is the squared loss."""
    if delta <= 0:
        return torch.ones_like(r_norm)
    return torch.clamp(delta / torch.clamp(r_norm, min=1e-9), max=1.0)


def _cost(poses, points, obs, mask, z, z_mask, w_z, cam, d_prior, w_p, delta):
    pc = _camera_points(poses, points)
    r = project_points(pc, cam, with_distortion=True) - obs
    rn2 = (r * r).sum(-1)
    rn = torch.sqrt(torch.clamp(rn2, min=1e-18))
    rho = torch.where((rn > delta) & (delta > 0), delta * (2.0 * rn - delta), rn2)
    c = torch.where(mask, rho, torch.zeros_like(rho)).sum((-2, -1))
    rz = w_z * (pc[..., 2] - z) / torch.clamp(z, min=1e-6)
    c = c + torch.where(z_mask, rz * rz, torch.zeros_like(rz)).sum((-2, -1))
    return c + w_p * w_p * (d_prior * d_prior).sum((-2, -1))


def _deviation(poses, inv_poses0, w_p: float):
    """se3_log(T @ inv(T_init)) per pose, the prior's residual, in float64:
    float32 se3_log returns NaN for rotations between 1e-4 and 3.5e-4 rad
    and translations off by tens of percent up to about 1e-3 rad (ROADMAP
    Queue C). Zero without a prior, so such a pose cannot reject a step."""
    if w_p == 0:
        return torch.zeros(poses.shape[:-2] + (6,), dtype=poses.dtype, device=poses.device)
    return se3_log(se3_compose(poses.double(), inv_poses0.double())).to(poses.dtype)


def ba_solve(problem: BAProblem, iters: int = 10, init_lambda: float = 1e-3, fix_first: bool = True) -> BAResult:
    """Run LM for ``iters`` steps: refined poses and points and the masked
    cost before and after. Takes one problem or a batch of them (a leading
    axis on every tensor)."""
    single = problem.poses.dim() == 3
    if single:
        problem = problem._replace(**{k: (None if v is None else v[None]) for k, v in problem._asdict().items()
                                      if k in ("poses", "points", "observations", "mask", "depths", "depth_mask")})
    poses0, points0, obs, mask, cam = problem.poses, problem.points, problem.observations, problem.mask, problem.cam
    B, M, P = mask.shape
    dt, dev = poses0.dtype, poses0.device
    if problem.depths is None:
        z = torch.ones((B, M, P), dtype=dt, device=dev)
        z_mask = torch.zeros((B, M, P), dtype=torch.bool, device=dev)
    else:
        z = torch.clamp(problem.depths, min=1e-6)
        z_mask = problem.depth_mask & mask
    w_z = float(problem.depth_weight)
    w_p = float(problem.pose_prior_weight)
    delta = float(problem.huber_px)
    zf = z_mask.to(dt)
    maskf = mask.to(dt)
    gauge = torch.zeros(M, dtype=dt, device=dev)
    if fix_first:
        gauge[0] = 1e12
    inv_poses0 = se3_inverse(poses0)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    cost0 = _cost(poses0, points0, obs, mask, z, z_mask, w_z, cam, torch.zeros((B, M, 6), dtype=dt, device=dev),
                  w_p, delta)
    poses, points = poses0, points0
    lam = torch.full((B,), init_lambda, dtype=dt, device=dev)
    cost = cost0
    for _ in range(iters):
        r, Jp, Jx = residual_blocks(poses, points, obs, z, zf, w_z, cam)
        # IRLS Huber weight from the pixel-residual norm, on all three rows
        # of the observation (a wrong match corrupts its depth row too)
        rn = torch.linalg.vector_norm(r[..., :2], dim=-1)
        wgt = (maskf * torch.sqrt(huber_weight(rn, delta)))[..., None]
        rw = r * wgt
        Jp = Jp * wgt[..., None]
        Jx = Jx * wgt[..., None]

        Hpp = torch.einsum("bmpki,bmpkj->bmij", Jp, Jp)
        Hll = torch.einsum("bmpki,bmpkj->bpij", Jx, Jx)
        Hpl = torch.einsum("bmpki,bmpkj->bmpij", Jp, Jx)
        bp = -torch.einsum("bmpki,bmpk->bmi", Jp, rw)
        bl = -torch.einsum("bmpki,bmpk->bpi", Jx, rw)

        # pose prior: r_m(xi) = w_p (d_m + xi) to first order
        d = _deviation(poses, inv_poses0, w_p)
        Hpp = Hpp + (w_p * w_p) * eye6
        bp = bp - (w_p * w_p) * d

        Hpp = Hpp + (lam[:, None] + gauge)[..., None, None] * eye6
        Hll = Hll + lam[:, None, None, None] * eye3
        Hll_inv = torch.linalg.inv_ex(Hll).inverse

        # Schur complement S = blockdiag(Hpp) - sum_p Hpl Hll^-1 Hpl^T
        # (poses couple only through landmarks)
        Wm = torch.einsum("bmpij,bpjk->bmpik", Hpl, Hll_inv)
        S = -torch.einsum("bmpik,bnpjk->bminj", Wm, Hpl)
        S = S + torch.diag_embed(Hpp.permute(0, 2, 3, 1)).permute(0, 3, 1, 4, 2)
        rhs = bp - torch.einsum("bmpik,bpk->bmi", Wm, bl)
        dxi = torch.linalg.solve_ex(S.reshape(B, 6 * M, 6 * M), rhs.reshape(B, 6 * M, 1)).result.reshape(B, M, 6)
        dX = torch.einsum("bpij,bpj->bpi", Hll_inv, bl - torch.einsum("bmpij,bmi->bpj", Hpl, dxi))

        poses_new = se3_compose(se3_exp(dxi), poses)
        points_new = points + dX
        cost_new = _cost(poses_new, points_new, obs, mask, z, z_mask, w_z, cam,
                         _deviation(poses_new, inv_poses0, w_p), w_p, delta)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        poses = torch.where(accept[:, None, None, None], poses_new, poses)
        points = torch.where(accept[:, None, None], points_new, points)
        lam = torch.where(accept, lam * 0.3, lam * 4.0)
        cost = torch.where(accept, cost_new, cost)
    res = BAResult(poses=poses, points=points, initial_cost=cost0, final_cost=cost)
    if single:
        res = BAResult(*(x[0] for x in res))
    return res
