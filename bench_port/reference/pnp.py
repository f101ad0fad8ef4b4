"""PnP-RANSAC with the 6-point DLT, plain: Gumbel top-k draws of six valid
points (biased by per-point weights), the DLT null vector by inverse
iteration on A^T A, preemptive scoring on a random subset of 128 points
(when there are 256 or more) keeping the best 64, the three best by
consensus made rigid by SVD (majority-positive depths) and, with the
identity pose, refined by annealed Gauss-Newton; the best candidate by
inliers plus mean-error tie break, re-orthonormalised. Poses map object
points into the camera. The draws are arguments: (P, n_hypotheses, N)
Gumbel noise and (P, N) uniforms."""

from __future__ import annotations

import torch

from bench_port.reference.common import Camera, hat, mm, project, se3_exp, se3_matrix, so3_orthonormalize
from bench_port.reference.common import undistort_points


def _transform(P, pts):
    return (P[..., None, :, :3] * pts[..., :, None, :]).sum(-1) + P[..., None, :, 3]


def _reproj(P, pts3d, pts2d, cam):
    return torch.linalg.vector_norm(project(_transform(P, pts3d), cam) - pts2d, dim=-1)


def _gather(data, idx):
    P, N, C = data.shape
    return data.gather(1, idx.reshape(P, -1)[..., None].expand(-1, -1, C)).reshape(idx.shape + (C,))


def _stable_topk(values, k):
    n = values.shape[-1]
    key = values.long() * n + (n - 1 - torch.arange(n, device=values.device))
    return torch.topk(key, k, dim=-1).indices


def _null_vector(A, dim=12, iters=8, shift=1e-6):
    AtA = (A.unsqueeze(-1) * A.unsqueeze(-2)).sum(-3)
    scale = torch.clamp(AtA.diagonal(dim1=-2, dim2=-1).sum(-1) / dim, min=1e-12)[..., None, None]
    Binv = torch.linalg.inv_ex(AtA / scale + shift * torch.eye(dim, dtype=A.dtype, device=A.device)).inverse
    v = torch.ones(A.shape[:-2] + (dim,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = (Binv * v.unsqueeze(-2)).sum(-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


def _dlt_rows(X3, xn):
    X, Y, Z = X3.unbind(-1)
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    x, y = xn[..., 0], xn[..., 1]
    rx = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x], -1)
    ry = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y], -1)
    return torch.cat([rx, ry], -2)


def _svd_pose(M, p3, sign):
    bad = ~torch.isfinite(M).all(-1).all(-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], torch.zeros_like(M), sign * M))
    U = torch.where(bad[..., None, None], float("nan"), U)
    S = torch.where(bad[..., None], float("nan"), S)
    Vh = torch.where(bad[..., None, None], float("nan"), Vh)
    R = mm(U, Vh)
    det = torch.linalg.det(R)
    R = R * det[..., None, None]
    s = S.mean(-1) * det
    return R, sign * p3 / torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)[..., None]


def _rigid(P, pts3d, valid):
    M = P[..., :3]
    R, t = _svd_pose(M, P[..., 3], 1.0)
    z = (R[..., 2, None, :] * pts3d).sum(-1) + t[..., 2:3]
    flip = ((z < 0) & valid).sum(-1) > ((z > 0) & valid).sum(-1)
    R2, t2 = _svd_pose(M, P[..., 3], -1.0)
    return torch.cat([torch.where(flip[..., None, None], R2, R), torch.where(flip[..., None], t2, t)[..., None]], -1)


def _jacobian(pc, cam: Camera):
    X, Y, Z = pc.unbind(-1)
    guard = Z.abs() < 1e-9
    Zs = torch.where(guard, torch.full_like(Z, 1e-9), Z)
    x, y = X / Zs, Y / Zs
    zero = torch.zeros_like(X)
    inv = 1.0 / Zs
    jn = torch.stack([torch.stack([inv, zero, torch.where(guard, zero, -x * inv)], -1),
                      torch.stack([zero, inv, torch.where(guard, zero, -y * inv)], -1)], -2)
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
    jd = torch.stack([
        torch.stack([rad + 2 * x * x * drad + 2 * p1 * y + 6 * p2 * x, 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y], -1),
        torch.stack([2 * x * y * drad + 2 * p1 * x + 2 * p2 * y, rad + 2 * y * y * drad + 6 * p1 * y + 2 * p2 * x], -1),
    ], -2)
    jpix = torch.stack([cam.fx, cam.fy])[:, None] * mm(jd, jn)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return mm(jpix, torch.cat([eye, -hat(pc)], -1))


def _gauss_newton(T, pts3d, pts2d, valid, cam, threshold, iters, anneal, damping=1e-6):
    half = max(iters // 2, 1)
    for i in range(iters):
        frac = min(i / half, 1.0)
        gate = threshold * (anneal * (1.0 - frac) + frac)
        pc = _transform(T[..., :3, :], pts3d)
        d = project(pc, cam) - pts2d
        w = ((torch.linalg.vector_norm(d, dim=-1) < gate[..., None]) & valid).to(T.dtype)
        r = (d * w[..., None]).flatten(-2)
        J = (_jacobian(pc, cam) * w[..., None, None]).flatten(-3, -2)
        Hm = (J.unsqueeze(-1) * J.unsqueeze(-2)).sum(-3) + damping * torch.eye(6, dtype=T.dtype, device=T.device)
        dx = -torch.linalg.solve_ex(Hm, (J * r[..., None]).sum(-2)[..., None]).result[..., 0]
        dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, torch.zeros_like(dx))
        T = mm(se3_exp(dx), T)
    return T


def solve(pts3d, pts2d, valid, cam: Camera, gumbel, uniform, weights=None, threshold=1.0, min_inliers=6,
          refine_iters=8, n_starts=3, identity_anneal=48.0, subset=128, keep=64):
    """(R (P, 3, 3), t (P, 3), n_inliers (P,), ok (P,))."""
    P, N, _ = pts3d.shape
    dev = pts3d.device
    xn = undistort_points(pts2d, cam)
    g = gumbel
    if weights is not None:
        g = g + torch.log(torch.clamp(weights, min=1e-9))[..., None, :]
    idx = torch.topk(torch.where(valid[..., None, :], g, torch.full_like(g, float("-inf"))), 6, dim=-1).indices
    Ps = _null_vector(_dlt_rows(_gather(pts3d, idx), _gather(xn, idx))).reshape(P, -1, 3, 4)
    if subset > 0 and N >= 2 * subset:
        gu = -torch.log(-torch.log(uniform))
        sub = torch.topk(torch.where(valid, gu, torch.full_like(gu, float("-inf"))), subset, dim=-1).indices
        cnt = ((_reproj(Ps, _gather(pts3d, sub)[:, None], _gather(pts2d, sub)[:, None], cam) < threshold)
               & valid.gather(1, sub)[:, None]).sum(-1)
        kk = _stable_topk(cnt, min(keep, Ps.shape[1]))
        Ps = Ps.gather(1, kk[..., None, None].expand(-1, -1, 3, 4))
    inl = (_reproj(Ps, pts3d[:, None], pts2d[:, None], cam) < threshold) & valid[:, None]
    k = min(n_starts, Ps.shape[1])
    top = _stable_topk(inl.sum(-1), k)
    P_top = _rigid(Ps.gather(1, top[..., None, None].expand(-1, -1, 3, 4)), pts3d[:, None],
                   inl.gather(1, top[..., None].expand(-1, -1, N)))
    T0 = torch.cat([se3_matrix(P_top[..., :3], P_top[..., 3]), torch.eye(4, device=dev).expand(P, 1, 4, 4)], 1)
    anneal = torch.cat([torch.full((P, k), 4.0, device=dev), torch.full((P, 1), float(identity_anneal), device=dev)], 1)
    Ts = _gauss_newton(T0, pts3d[:, None], pts2d[:, None], valid[:, None], cam, threshold, refine_iters, anneal)
    Pc = torch.cat([Ts[:, :k, :3, :], P_top[:, :1], Ts[:, k:, :3, :]], 1)
    err = _reproj(Pc, pts3d[:, None], pts2d[:, None], cam)
    inl_c = (err < threshold) & valid[:, None]
    cnt = inl_c.sum(-1)
    score = cnt.float() + torch.clamp(1.0 - (err * inl_c).sum(-1) / torch.clamp(cnt, min=1) / threshold, 0.0, 1.0)
    b = torch.argmax(score, 1)
    Pf = Pc.gather(1, b[:, None, None, None].expand(-1, 1, 3, 4))[:, 0]
    n = cnt.gather(1, b[:, None])[:, 0]
    return so3_orthonormalize(Pf[..., :3]), Pf[..., 3], n, n >= min_inliers
