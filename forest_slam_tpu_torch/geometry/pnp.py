"""PnP-RANSAC with Gauss-Newton refinement (port of geometry/pnp.py).

Batched over a leading pair dimension: points (P, N, 3) / (P, N, 2), masks
(P, N). Minimal solvers: the 6-point DLT through inverse iteration on A^T A,
or Grunert's 3-point solution (up to four rigid poses a draw, from a quartic
solved in closed form in complex arithmetic); preemptive scoring on a random
point subset; the three best hypotheses plus
the identity pose refined by annealed Gauss-Newton with an analytic
Jacobian; the best candidate by consensus, then re-orthonormalised.
Returned (R, t) map object points into the camera (x_cam = R X + t).

The random numbers (the Gumbel noise of the minimal-sample draws and the
uniforms of the preemptive subset) can be passed in, so a test can hand the
JAX reference the same numbers; otherwise they come from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, project_points, undistort_points
from forest_slam_tpu_torch.core.lie import hat, mm, se3_compose, se3_exp, se3_matrix, so3_orthonormalize
from forest_slam_tpu_torch.geometry.ransac import gumbel_noise, ransac_sample_indices, stable_topk


class PnPResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3)
    inliers: torch.Tensor  # (P, N) bool
    n_inliers: torch.Tensor  # (P,) int64
    ok: torch.Tensor  # (P,) bool


def nullspace_inverse_iteration(A: torch.Tensor, dim: int, iters: int = 8, shift: float = 1e-6) -> torch.Tensor:
    """Smallest right singular vector of batched A (..., k, dim) by inverse
    iteration on A^T A + shift I (scale-normalised)."""
    AtA = (A.unsqueeze(-1) * A.unsqueeze(-2)).sum(-3)
    scale = torch.clamp(AtA.diagonal(dim1=-2, dim2=-1).sum(-1) / dim, min=1e-12)[..., None, None]
    B = AtA / scale + shift * torch.eye(dim, dtype=A.dtype, device=A.device)
    Binv = torch.linalg.inv_ex(B).inverse
    v = torch.ones(A.shape[:-2] + (dim,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = (Binv * v.unsqueeze(-2)).sum(-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


def dlt_rows(pts3d: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """DLT system rows: (..., N, 3) + (..., N, 2) -> (..., 2N, 12)."""
    X, Y, Z = pts3d.unbind(-1)
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    x, y = xn[..., 0], xn[..., 1]
    rows_x = torch.stack([X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x], dim=-1)
    rows_y = torch.stack([zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y], dim=-1)
    return torch.cat([rows_x, rows_y], dim=-2)


def _transform(P: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) pose(s) applied to (..., N, 3) points -> (..., N, 3)."""
    return (P[..., None, :, :3] * pts3d[..., :, None, :]).sum(-1) + P[..., None, :, 3]


def reproject_error(P, pts3d, pts2d, cam: PinholeCamera) -> torch.Tensor:
    """Pixel reprojection distance of points under (..., 3, 4) poses."""
    proj = project_points(_transform(P, pts3d), cam, with_distortion=True)
    return torch.linalg.vector_norm(proj - pts2d, dim=-1)


def _svd(M):
    """torch.linalg.svd of (..., 3, 3) with non-finite matrices answered by
    NaN factors, as an SVD of NaN input returns them, without handing the
    solver a non-finite matrix."""
    bad = ~torch.isfinite(M).all(-1).all(-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], torch.zeros_like(M), M))
    nan = torch.tensor(float("nan"), dtype=M.dtype, device=M.device)
    return (torch.where(bad[..., None, None], nan, U), torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vh))


def _svd_pose(M, p3, sign):
    U, S, Vh = _svd(sign * M)
    R = mm(U, Vh)
    det = torch.linalg.det(R)
    R = R * det[..., None, None]
    s = S.mean(-1) * det
    t = sign * p3 / torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)[..., None]
    return R, t


def orthogonalize_pose(P: torch.Tensor, pts3d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Raw DLT (..., 3, 4) -> rigid [R|t] with majority-positive depths."""
    M = P[..., :3]
    R, t = _svd_pose(M, P[..., 3], 1.0)
    z = (R[..., 2, None, :] * pts3d).sum(-1) + t[..., 2:3]
    npos = ((z > 0) & valid).sum(-1)
    nneg = ((z < 0) & valid).sum(-1)
    flip = nneg > npos
    R2, t2 = _svd_pose(M, P[..., 3], -1.0)
    R = torch.where(flip[..., None, None], R2, R)
    t = torch.where(flip[..., None], t2, t)
    return torch.cat([R, t[..., None]], dim=-1)


def solve_quartic(c4, c3, c2, c1, c0) -> torch.Tensor:
    """The four complex64 roots (..., 4) of batched real quartics
    c4 x^4 + ... + c0 by Ferrari's closed form (geometry/pnp.py:_solve_quartic):
    the depressed quartic, one root of its resolvent cubic by Cardano, two
    quadratic factors; the biquadratic form where the factor's w vanishes."""
    c4 = torch.where(c4.abs() < 1e-12, torch.full_like(c4, 1e-12), c4)
    a3, a2, a1, a0 = (c.to(torch.complex64) / c4 for c in (c3, c2, c1, c0))
    a3sq = a3 * a3
    p = a2 - 3 * a3sq / 8
    q = a1 - a3 * a2 / 2 + a3sq * a3 / 8
    r = a0 - a3 * a1 / 4 + a3sq * a2 / 16 - 3 * (a3sq * a3sq) / 256
    b, c_, d = -p, -4 * r, 4 * p * r - q * q
    t_shift = b / 3
    cp = c_ - b * b / 3
    cq = d - b * c_ / 3 + 2 * (b * b * b) / 27
    h, g = cq / 2, cp / 3
    disc = torch.sqrt(h * h + g * g * g)
    u1 = -cq / 2 + disc
    u2 = -cq / 2 - disc
    ua = torch.where(u1.abs() > u2.abs(), u1, u2)
    tiny = ua.abs() < 1e-30
    cbrt = torch.where(tiny, 0.0, torch.exp(torch.log(ua) / 3))
    small = cbrt.abs() < 1e-30
    z = torch.where(small, 0.0, cbrt - cp / (3 * torch.where(small, 1.0, cbrt))) - t_shift
    w = torch.sqrt(z - p)
    w_ok = w.abs() > 1e-6
    ws = torch.where(w_ok, w, 1.0)
    root = torch.sqrt(p * p - 4 * r)
    e1 = torch.where(w_ok, z / 2 - q / (2 * ws), (-p + root) / 2)
    e2 = torch.where(w_ok, z / 2 + q / (2 * ws), (-p - root) / 2)
    wq = torch.where(w_ok, w, 0.0)
    d1 = torch.sqrt(wq * wq - 4 * e1)
    d2 = torch.sqrt(wq * wq - 4 * e2)
    y = torch.stack([(-wq + d1) / 2, (-wq - d1) / 2, (wq + d2) / 2, (wq - d2) / 2], dim=-1)
    return y - a3[..., None] / 4


def _solve3(J, g):
    """Batched 3x3 solves; entries that come out non-finite (a singular
    system) are 0."""
    ds = torch.linalg.solve_ex(J, g[..., None]).result[..., 0]
    return torch.where(torch.isfinite(ds), ds, torch.zeros_like(ds))


def _kabsch(X, Y):
    """Rigid [R|t] (..., 3, 4) with Y ~ R X + t for point triples (..., 3, 3)."""
    Xm, Ym = X.mean(-2), Y.mean(-2)
    Hm = ((X - Xm[..., None, :]).unsqueeze(-1) * (Y - Ym[..., None, :]).unsqueeze(-2)).sum(-3)
    U, _, Vh = _svd(Hm)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(mm(V, Ut))
    keep = torch.tensor([1.0, 1.0, 0.0], dtype=X.dtype, device=X.device)
    last = torch.tensor([0.0, 0.0, 1.0], dtype=X.dtype, device=X.device)
    R = mm(V * keep, Ut) + d[..., None, None] * mm(V * last, Ut)
    t = Ym - (R * Xm[..., None, :]).sum(-1)
    return torch.cat([R, t[..., None]], dim=-1)


def p3p_grunert(pts3d: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Grunert's P3P: world points (..., 3, 3) and unit bearings (..., 3, 3)
    -> four candidate rigid poses (..., 4, 3, 4) with x_cam = R X + t; a
    complex or degenerate root gives a pose of NaN, which scores no inliers.
    The quartic in v = s3 / s1 (side lengths normalised to about 1), roots
    polished by two Newton steps, u = s2 / s1 from the combination of the two
    quadrics linear in u, three Newton steps on the distance equations, then
    Kabsch (geometry/pnp.py:_p3p_grunert)."""
    P1, P2, P3 = pts3d[..., 0, :], pts3d[..., 1, :], pts3d[..., 2, :]
    aa = ((P2 - P3) ** 2).sum(-1)
    bb = ((P1 - P3) ** 2).sum(-1)
    cc = ((P1 - P2) ** 2).sum(-1)
    dscale = torch.clamp((aa + bb + cc) / 3, min=1e-12)
    aa, bb, cc = aa / dscale, bb / dscale, cc / dscale
    ca = (f[..., 1, :] * f[..., 2, :]).sum(-1)
    cb = (f[..., 0, :] * f[..., 2, :]).sum(-1)
    cg = (f[..., 0, :] * f[..., 1, :]).sum(-1)

    A4 = aa**2 - 2*aa*bb - 2*aa*cc + bb**2 - 4*bb*ca**2*cc + 2*bb*cc + cc**2
    A3 = (-4*aa**2*cb + 4*aa*bb*ca*cg + 4*aa*bb*cb + 8*aa*cb*cc
          - 4*bb**2*ca*cg + 8*bb*ca**2*cb*cc + 4*bb*ca*cc*cg - 4*bb*cb*cc
          - 4*cb*cc**2)
    A2 = (4*aa**2*cb**2 + 2*aa**2 - 8*aa*bb*ca*cb*cg - 4*aa*bb*cg**2
          - 8*aa*cb**2*cc - 4*aa*cc + 4*bb**2*ca**2 + 4*bb**2*cg**2
          - 2*bb**2 - 4*bb*ca**2*cc - 8*bb*ca*cb*cc*cg + 4*cb**2*cc**2
          + 2*cc**2)
    A1 = (-4*aa**2*cb + 4*aa*bb*ca*cg + 8*aa*bb*cb*cg**2 - 4*aa*bb*cb
          + 8*aa*cb*cc - 4*bb**2*ca*cg + 4*bb*ca*cc*cg + 4*bb*cb*cc
          - 4*cb*cc**2)
    A0 = aa**2 - 4*aa*bb*cg**2 + 2*aa*bb - 2*aa*cc + bb**2 - 2*bb*cc + cc**2

    roots = solve_quartic(A4, A3, A2, A1, A0)  # (..., 4)
    near_real = roots.imag.abs() < 1e-3 * (1.0 + roots.real.abs())
    A4, A3, A2, A1, A0, aa, bb, cc, ca, cb, cg = (x[..., None] for x in (A4, A3, A2, A1, A0, aa, bb, cc, ca, cb, cg))
    v = roots.real
    for _ in range(2):
        fv = (((A4 * v + A3) * v + A2) * v + A1) * v + A0
        dv = ((4 * A4 * v + 3 * A3) * v + 2 * A2) * v + A1
        v = v - fv / torch.where(dv.abs() < 1e-12, torch.full_like(dv, 1e-12), dv)

    lin_u = (aa - cc) * 2 * bb * ca * v + bb * (2 * cc * ca * v - 2 * aa * cg)
    lin_c = (aa - cc) * (aa * (1 + v * v - 2 * v * cb) - bb * v * v) + bb * (aa - cc * v * v)
    u = -lin_c / torch.where(lin_u.abs() < 1e-12, torch.full_like(lin_u, 1e-12), lin_u)
    den = 1 + v * v - 2 * v * cb
    s1 = torch.sqrt(bb / torch.where(den < 1e-12, torch.full_like(den, 1e-12), den))
    s = torch.stack([s1, u * s1, v * s1], dim=-1)  # (..., 4, 3)
    eye = 1e-9 * torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(3):
        x1, x2, x3 = s.unbind(-1)
        g = torch.stack([x2**2 + x3**2 - 2 * x2 * x3 * ca - aa,
                         x1**2 + x3**2 - 2 * x1 * x3 * cb - bb,
                         x1**2 + x2**2 - 2 * x1 * x2 * cg - cc], dim=-1)
        zero = torch.zeros_like(x1)
        J = torch.stack([
            torch.stack([zero, 2 * (x2 - x3 * ca), 2 * (x3 - x2 * ca)], -1),
            torch.stack([2 * (x1 - x3 * cb), zero, 2 * (x3 - x1 * cb)], -1),
            torch.stack([2 * (x1 - x2 * cg), 2 * (x2 - x1 * cg), zero], -1),
        ], dim=-2) + eye
        s = s - _solve3(J, g)
    s = s * torch.sqrt(dscale)[..., None, None]
    valid = near_real & (den > 1e-12) & (s > 0).all(-1) & torch.isfinite(s).all(-1)
    Y = s[..., None] * f[..., None, :, :]  # (..., 4, 3, 3)
    Y = torch.where(valid[..., None, None], Y, torch.zeros_like(Y))
    Ps = _kabsch(pts3d[..., None, :, :].expand_as(Y), Y)
    return torch.where(valid[..., None, None], Ps, torch.full_like(Ps, float("nan")))


def _projection_jacobian(pc: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """d pixel / d twist (..., N, 2, 6) of points pc (..., N, 3) under a left
    perturbation exp(xi) of the pose, at xi = 0."""
    X, Y, Z = pc.unbind(-1)
    guard = Z.abs() < 1e-9
    Zs = torch.where(guard, torch.full_like(Z, 1e-9), Z)
    x, y = X / Zs, Y / Zs
    zero = torch.zeros_like(X)
    inv = 1.0 / Zs
    jn = torch.stack([
        torch.stack([inv, zero, torch.where(guard, zero, -x * inv)], -1),
        torch.stack([zero, inv, torch.where(guard, zero, -y * inv)], -1),
    ], -2)  # (..., 2, 3)
    k1, k2, p1, p2, k3 = cam.dist.unbind(0)
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    drad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d rad / d r2
    jd = torch.stack([
        torch.stack([rad + 2 * x * x * drad + 2 * p1 * y + 6 * p2 * x, 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y], -1),
        torch.stack([2 * x * y * drad + 2 * p1 * x + 2 * p2 * y, rad + 2 * y * y * drad + 6 * p1 * y + 2 * p2 * x], -1),
    ], -2)  # (..., 2, 2)
    f = torch.stack([cam.fx, cam.fy])[:, None]
    jpix = f * mm(jd, jn)  # (..., 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    jpc = torch.cat([eye, -hat(pc)], dim=-1)  # (..., 3, 6)
    return mm(jpix, jpc)


def gauss_newton_refine(T0, pts3d, pts2d, valid, cam: PinholeCamera, threshold: float, iters: int = 8,
                        anneal=4.0, damping: float = 1e-6):
    """Gauss-Newton on reprojection error with an annealed inlier gate
    (``anneal * threshold`` tightening to ``threshold`` over the first half
    of the iterations). T0 (..., 4, 4); points broadcast against it;
    ``anneal`` a float or a tensor of T0's batch shape."""
    half = max(iters // 2, 1)
    anneal = torch.as_tensor(anneal, dtype=T0.dtype, device=T0.device)
    T = T0
    for i in range(iters):
        frac = min(i / half, 1.0)
        gate = threshold * (anneal * (1.0 - frac) + frac)
        pc = _transform(T[..., :3, :], pts3d)
        proj = project_points(pc, cam, with_distortion=True)
        d = proj - pts2d
        w = ((torch.linalg.vector_norm(d, dim=-1) < gate[..., None]) & valid).to(T.dtype)
        r = (d * w[..., None]).flatten(-2)  # (..., 2N)
        J = (_projection_jacobian(pc, cam) * w[..., None, None]).flatten(-3, -2)  # (..., 2N, 6)
        H = (J.unsqueeze(-1) * J.unsqueeze(-2)).sum(-3) + damping * torch.eye(6, dtype=T.dtype, device=T.device)
        g = (J * r[..., None]).sum(-2)
        dx = -torch.linalg.solve_ex(H, g[..., None]).result[..., 0]
        dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, torch.zeros_like(dx))
        T = se3_compose(se3_exp(dx), T)
    return T


def _gather(data, idx):
    """data (P, N, C) at idx (P, ...) -> (P, ..., C)."""
    P, N, C = data.shape
    flat = idx.reshape(P, -1)
    return data.gather(1, flat[..., None].expand(-1, -1, C)).reshape(idx.shape + (C,))


def solve_pnp_ransac(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    valid: torch.Tensor,
    cam: PinholeCamera,
    generator: torch.Generator | None = None,
    reproj_threshold: float = 1.0,
    n_hypotheses: int = 1024,
    min_inliers: int = 6,
    refine_iters: int = 8,
    n_starts: int = 3,
    identity_prior_anneal: float = 48.0,
    weights: torch.Tensor | None = None,
    preemptive_subset: int = 128,
    preemptive_keep: int = 64,
    gumbel: torch.Tensor | None = None,
    uniform: torch.Tensor | None = None,
    minimal: str = "dlt6",
) -> PnPResult:
    """Robust PnP for P pairs at once: pts3d (P, N, 3) object points,
    pts2d (P, N, 2) pixel observations, valid (P, N). ``gumbel``
    (P, n_hypotheses, N) and ``uniform`` (P, N) in [1e-9, 1) are drawn from
    ``generator`` when not given. ``minimal``: "dlt6" (6-point DLT, raw
    projective hypotheses) or "p3p" (3-point draws, up to four rigid poses
    each, so 4 x n_hypotheses candidates scored alike)."""
    if minimal not in ("dlt6", "p3p"):
        raise ValueError(f"unknown minimal solver {minimal!r}")
    P, N, _ = pts3d.shape
    dev = pts3d.device
    if gumbel is None:
        gumbel = gumbel_noise((P, n_hypotheses, N), generator, dev)
    if uniform is None and preemptive_subset > 0 and N >= 2 * preemptive_subset:
        uniform = 1e-9 + (1.0 - 1e-9) * torch.rand((P, N), generator=generator, device=dev)
    xn = undistort_points(pts2d, cam)
    if minimal == "p3p":
        idx = ransac_sample_indices(gumbel, valid, 3, weights)  # (P, H, 3)
        bear = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
        bear = bear / torch.linalg.vector_norm(bear, dim=-1, keepdim=True)
        Ps = p3p_grunert(_gather(pts3d, idx), _gather(bear, idx)).reshape(P, -1, 3, 4)
    else:
        idx = ransac_sample_indices(gumbel, valid, 6, weights)  # (P, H, 6)
        A = dlt_rows(_gather(pts3d, idx), _gather(xn, idx))  # (P, H, 12, 12)
        Ps = nullspace_inverse_iteration(A, 12).reshape(P, -1, 3, 4)

    n_keep = min(preemptive_keep, Ps.shape[1])
    if preemptive_subset > 0 and N >= 2 * preemptive_subset:
        g = -torch.log(-torch.log(uniform))
        g = torch.where(valid, g, torch.full_like(g, float("-inf")))
        sub = torch.topk(g, preemptive_subset, dim=-1).indices  # (P, S)
        p3s, p2s = _gather(pts3d, sub), _gather(pts2d, sub)
        vs = valid.gather(1, sub)
        errs_s = reproject_error(Ps, p3s[:, None], p2s[:, None], cam)
        counts_s = ((errs_s < reproj_threshold) & vs[:, None]).sum(-1)
        keep = stable_topk(counts_s, n_keep)
        Ps = Ps.gather(1, keep[..., None, None].expand(-1, -1, 3, 4))
    errs = reproject_error(Ps, pts3d[:, None], pts2d[:, None], cam)
    inl = (errs < reproj_threshold) & valid[:, None]
    counts = inl.sum(-1)

    k = min(max(n_starts, 1), Ps.shape[1])
    top = stable_topk(counts, k)  # (P, k)
    P_top = Ps.gather(1, top[..., None, None].expand(-1, -1, 3, 4))
    inl_top = inl.gather(1, top[..., None].expand(-1, -1, N))
    P_tops = orthogonalize_pose(P_top, pts3d[:, None], inl_top)  # (P, k, 3, 4)
    T0s = se3_matrix(P_tops[..., :3], P_tops[..., 3])
    anneal = torch.full((P, k), 4.0, device=dev)
    if identity_prior_anneal > 0:
        T0s = torch.cat([T0s, torch.eye(4, device=dev).expand(P, 1, 4, 4)], dim=1)
        anneal = torch.cat([anneal, torch.full((P, 1), float(identity_prior_anneal), device=dev)], dim=1)
    Ts = gauss_newton_refine(T0s, pts3d[:, None], pts2d[:, None], valid[:, None], cam, reproj_threshold,
                             iters=refine_iters, anneal=anneal)
    # candidates: the k refined poses, the best unrefined one, the identity start
    cands = [Ts[:, :k, :3, :], P_tops[:, :1]]
    if identity_prior_anneal > 0:
        cands.append(Ts[:, k:, :3, :])
    P_c = torch.cat(cands, dim=1)
    err_c = reproject_error(P_c, pts3d[:, None], pts2d[:, None], cam)
    inl_c = (err_c < reproj_threshold) & valid[:, None]
    cnt_c = inl_c.sum(-1)
    mean_err = (err_c * inl_c).sum(-1) / torch.clamp(cnt_c, min=1)
    score = cnt_c.float() + torch.clamp(1.0 - mean_err / reproj_threshold, 0.0, 1.0)
    b = torch.argmax(score, dim=1)  # first maximum
    P_fin = P_c.gather(1, b[:, None, None, None].expand(-1, 1, 3, 4))[:, 0]
    R = so3_orthonormalize(P_fin[..., :3])
    inl_fin = inl_c.gather(1, b[:, None, None].expand(-1, 1, N))[:, 0]
    n = cnt_c.gather(1, b[:, None])[:, 0]
    return PnPResult(R=R, t=P_fin[..., 3], inliers=inl_fin, n_inliers=n, ok=n >= min_inliers)
