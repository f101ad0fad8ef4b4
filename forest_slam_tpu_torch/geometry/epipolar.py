"""Essential-matrix RANSAC and relative pose recovery, batched over pairs
(port of geometry/epipolar.py).

The two-view estimator of the monocular path, the counterpart of the
reference's ``cv2.findEssentialMat`` + ``cv2.recoverPose``, in three fixed
stages over P pairs at once: points (P, N, 2) in normalised camera
coordinates, masks (P, N).

1. Hypotheses: a static batch of minimal samples per pair, each solved by
   the linear 8-point nullspace (inverse iteration) or Nister's 5-point
   solver (up to 10 candidates a sample, geometry/fivepoint.py), all scored
   by Sampson distance; the winner's inliers refit by one (N, 9) SVD and
   projected onto the essential manifold (with 5 points, the refit is kept
   only where it does not lose consensus).
2. Cheirality: the four (R, t) decompositions of E voted on by the signs of
   closed-form two-view depths.
3. Polish: Gauss-Newton on the signed Sampson residual over (R, unit t),
   with an inlier gate annealed from 4x the threshold, an analytic
   Jacobian, the step along t pinned (see :func:`refine_pose_sampson`) and
   ``solve_ex``; the polished pose is kept where it does not lose
   consensus.

The Gumbel noise of the minimal-sample draws (P, H, N) is an argument: the
caller draws it (pipelines/mono.py, one pair at a time from its generator),
and a test can hand the JAX reference the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forest_slam_tpu_torch.core.lie import hat, mm, so3_exp, so3_orthonormalize
from forest_slam_tpu_torch.geometry.pnp import _gather, _svd, nullspace_inverse_iteration
from forest_slam_tpu_torch.geometry.ransac import ransac_sample_indices

# elements of one slice of the (pairs, candidates, points) Sampson table
SCORE_SLICE = 1 << 24


def epipolar_rows(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Rows (..., 9) of the linear system x1^T E x0 = 0."""
    u0, v0 = x0.unbind(-1)
    u1, v1 = x1.unbind(-1)
    return torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, torch.ones_like(u0)], dim=-1)


def essential_from_nullspace(A: torch.Tensor) -> torch.Tensor:
    """Rows (..., k, 9) -> E (..., 3, 3): the smallest right singular vector,
    projected onto the essential manifold (singular values (s, s, 0))."""
    Vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9).Vh
    U, S, Vt = _svd(Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3)))
    s = (S[..., 0] + S[..., 1]) * 0.5
    return mm(U * torch.stack([s, s, torch.zeros_like(s)], dim=-1)[..., None, :], Vt)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R (x1^T E x0 = 0 for x1 = R x0 + t)."""
    return mm(hat(t), R)


def _epipolar_lines(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """(E x0h)_0..2 and (E^T x1h)_0..1, each (..., N), of E (..., 3, 3) at
    points (..., N, 2) (E's batch broadcast against the points')."""
    e = lambda i, j: E[..., i, j, None]  # noqa: E731
    u0, v0 = x0.unbind(-1)
    u1, v1 = x1.unbind(-1)
    return (e(0, 0) * u0 + e(0, 1) * v0 + e(0, 2), e(1, 0) * u0 + e(1, 1) * v0 + e(1, 2),
            e(2, 0) * u0 + e(2, 1) * v0 + e(2, 2), e(0, 0) * u1 + e(1, 0) * v1 + e(2, 0),
            e(0, 1) * u1 + e(1, 1) * v1 + e(2, 1))


def _sampson_terms(E, x0, x1):
    """(x1h^T E x0h, the Sampson denominator, the lines) of E at the points."""
    lines = _epipolar_lines(E, x0, x1)
    a0, a1, a2, b0, b1 = lines
    u1, v1 = x1.unbind(-1)
    return u1 * a0 + v1 * a1 + a2, a0 * a0 + a1 * a1 + b0 * b0 + b1 * b1, lines


def sampson_error(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance (..., N) of E (..., 3, 3) at points
    (..., N, 2), normalised coordinates: the residual the RANSAC threshold
    (squared) gates."""
    num, den, _ = _sampson_terms(E, x0, x1)
    return num * num / torch.clamp(den, min=1e-12)


def signed_sampson(R: torch.Tensor, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Signed Sampson residual (..., N) of the pose (R, t)."""
    num, den, _ = _sampson_terms(essential_from_pose(R, t), x0, x1)
    return num / torch.sqrt(torch.clamp(den, min=1e-12))


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (P, 3, 3)
    inliers: torch.Tensor  # (P, N) bool
    n_inliers: torch.Tensor  # (P,) int64


def _gather_pairs(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (P, C, ...) at idx (P,) -> (P, ...)."""
    return data.gather(1, idx.view((-1, 1) + (1,) * (data.dim() - 2)).expand((-1, 1) + data.shape[2:]))[:, 0]


def find_essential_ransac(x0: torch.Tensor, x1: torch.Tensor, valid: torch.Tensor, threshold,
                          gumbel: torch.Tensor, minimal: str = "8pt") -> EssentialResult:
    """Essential-matrix RANSAC over a fixed hypothesis batch for each pair:
    one minimal sample per row of ``gumbel`` (P, n_hypotheses, N).
    ``threshold`` gates sqrt(Sampson) in normalised units (pixels over
    focal length; a float or a 0-d tensor). ``minimal``: "8pt" (linear
    nullspace, raw hypotheses) or "5pt" (Nister, up to 10 candidates a
    sample, all scored). The Sampson table is scored in slices of
    ``SCORE_SLICE`` elements and the winner's inliers recomputed, so memory
    stays bounded at 10 x n_hypotheses candidates."""
    if minimal not in ("8pt", "5pt"):
        raise ValueError(f"unknown minimal solver {minimal!r}")
    P, N, _ = x0.shape
    thr2 = threshold * threshold
    if minimal == "5pt":
        from forest_slam_tpu_torch.geometry.fivepoint import five_point_candidates

        idx = ransac_sample_indices(gumbel, valid, 5)  # (P, H, 5)
        Es, cand_ok = five_point_candidates(_gather(x0, idx), _gather(x1, idx))
        Es, cand_ok = Es.flatten(1, 2), cand_ok.flatten(1, 2)  # (P, 10 H, 3, 3), (P, 10 H)
    else:
        idx = ransac_sample_indices(gumbel, valid, 8)  # (P, H, 8)
        Es = nullspace_inverse_iteration(epipolar_rows(_gather(x0, idx), _gather(x1, idx)), 9).reshape(P, -1, 3, 3)
        cand_ok = torch.ones(Es.shape[:2], dtype=torch.bool, device=x0.device)

    def inliers(E, ok):  # E (P, C, 3, 3), ok (P, C) -> (P, C, N)
        return (sampson_error(E, x0[:, None], x1[:, None]) < thr2) & valid[:, None] & ok[..., None]

    step = max(1, SCORE_SLICE // max(P * N, 1))
    counts = torch.cat([inliers(Es[:, s:s + step], cand_ok[:, s:s + step]).sum(-1)
                        for s in range(0, Es.shape[1], step)], dim=1)
    best = torch.argmax(counts, dim=1)  # the first maximum
    E_best = _gather_pairs(Es, best)
    inl_best = inliers(E_best[:, None], _gather_pairs(cand_ok, best)[:, None])[:, 0]

    # refit on the winner's inliers by one accurate SVD, then project
    E_fit = essential_from_nullspace(epipolar_rows(x0, x1) * inl_best[..., None].to(x0.dtype))
    inl = (sampson_error(E_fit, x0, x1) < thr2) & valid
    if minimal == "5pt":
        # on planar scenes the linear refit is itself rank-deficient: keep the
        # winning candidate wherever the refit loses consensus
        keep = inl.sum(-1) >= counts.gather(1, best[:, None])[:, 0]
        E_fit = torch.where(keep[:, None, None], E_fit, E_best)
        inl = torch.where(keep[:, None], inl, inl_best)
    return EssentialResult(E=E_fit, inliers=inl, n_inliers=inl.sum(-1))


class PoseResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3) unit norm
    n_cheirality: torch.Tensor  # (P,) points passing the depth test


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def recover_pose(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, mask: torch.Tensor) -> PoseResult:
    """The decomposition of E (P, 3, 3) that puts the most masked points in
    front of both cameras (``cv2.recoverPose``): x1 = R x0 + t, |t| = 1.
    Candidates (Ra, t), (Ra, -t), (Rb, t), (Rb, -t), the first on a tie;
    depths from cross(x1h, R x0h) z0 = -cross(x1h, t) in least squares."""
    U, _, Vt = _svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    u0, u1, u2 = U.unbind(-1)
    Ra = so3_orthonormalize(mm(torch.stack([u1, -u0, u2], dim=-1), Vt))  # U W Vt
    Rb = so3_orthonormalize(mm(torch.stack([-u1, u0, u2], dim=-1), Vt))  # U W^T Vt
    Rs = torch.stack([Ra, Ra, Rb, Rb], dim=1)  # (P, 4, 3, 3)
    ts = torch.stack([u2, -u2, u2, -u2], dim=1)  # (P, 4, 3)
    x0h, x1h = _homog(x0)[:, None], _homog(x1)[:, None]  # (P, 1, N, 3)
    Rx0 = mm(x0h, Rs.transpose(-1, -2))  # (P, 4, N, 3)
    c1 = torch.linalg.cross(x1h.expand_as(Rx0), Rx0, dim=-1)
    c2 = torch.linalg.cross(x1h.expand_as(Rx0), ts[:, :, None, :].expand_as(Rx0), dim=-1)
    z0 = -(c1 * c2).sum(-1) / torch.clamp((c1 * c1).sum(-1), min=1e-12)
    z1 = Rx0[..., 2] * z0 + ts[..., 2:3]
    scores = ((z0 > 0) & (z1 > 0) & mask[:, None]).sum(-1)  # (P, 4)
    b = torch.argmax(scores, dim=1)
    return PoseResult(R=_gather_pairs(Rs, b), t=_gather_pairs(ts, b), n_cheirality=scores.gather(1, b[:, None])[:, 0])


def _sampson_jacobian(R, n, tnorm, x0, x1):
    """The signed Sampson residual of (R, n) (P, N) and its derivatives
    (P, 6, N) along a left rotation exp(w) R and a translation step d with
    n' = (t + d) / |t + d|, at w = d = 0."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    E = essential_from_pose(R, n)
    dEw = mm(mm(hat(n)[:, None], hat(eye)), R[:, None])  # [n]x hat(e_k) R, (P, 3, 3, 3)
    dn = (eye - n[:, :, None] * n[:, None, :]) / tnorm[:, None, None]  # column k: d n / d t_k
    dEt = mm(hat(dn.transpose(-1, -2)), R[:, None])
    dE = torch.cat([dEw, dEt], dim=1)  # (P, 6, 3, 3)
    num, den, (a0, a1, _, b0, b1) = _sampson_terms(E, x0, x1)
    dnum, _, (da0, da1, _, db0, db1) = _sampson_terms(dE, x0[:, None], x1[:, None])
    dens = torch.clamp(den, min=1e-12)
    sq = torch.sqrt(dens)
    dden = 2.0 * (a0[:, None] * da0 + a1[:, None] * da1 + b0[:, None] * db0 + b1[:, None] * db1)
    dden = torch.where((den > 1e-12)[:, None], dden, torch.zeros_like(dden))
    return num / sq, dnum / sq[:, None] - 0.5 * (num / (dens * sq))[:, None] * dden


def refine_pose_sampson(R: torch.Tensor, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, valid: torch.Tensor,
                        threshold, iters: int = 8, anneal: float = 4.0, damping: float = 1e-10
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton polish of (R (P, 3, 3), unit t (P, 3)) on the signed
    Sampson residual; the inlier gate anneals from ``anneal * threshold^2``
    to ``threshold^2`` over the first half of the iterations. A step that
    comes out non-finite is not taken.

    The six step parameters hold a gauge: a step along t only rescales it,
    which the residual does not see. The reference's 6x6 system is singular
    there but for its 1e-10 damping, so rounding sets that component; it
    reaches O(1) and can flip t's sign through the normalisation. Here the
    gauge direction gets the mean diagonal of J^T J, which makes the step a
    5-dof one."""
    thr2 = threshold * threshold
    half = max(iters // 2, 1)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for i in range(iters):
        frac = min(i / half, 1.0)
        gate2 = thr2 * (anneal * (1.0 - frac) + frac)
        e = signed_sampson(R, t, x0, x1)
        w = ((e * e < gate2) & valid).to(R.dtype)
        tnorm = torch.clamp(torch.linalg.vector_norm(t, dim=-1), min=1e-12)
        n = t / tnorm[:, None]
        r, J = _sampson_jacobian(R, n, tnorm, x0, x1)
        r, J = r * w, J * w[:, None]
        H = mm(J, J.transpose(-1, -2))
        # a step along t only rescales it: pin that direction (see above)
        gauge = torch.cat([torch.zeros_like(n), n], dim=-1)
        pin = H.diagonal(dim1=-2, dim2=-1).mean(-1)[:, None, None] * gauge[:, :, None] * gauge[:, None, :]
        H = H + pin + damping * eye6
        g = (J * r[:, None]).sum(-1)
        dx = -torch.linalg.solve_ex(H, g[..., None]).result[..., 0]
        dx = torch.where(torch.isfinite(dx).all(-1, keepdim=True), dx, torch.zeros_like(dx))
        R = so3_orthonormalize(mm(so3_exp(dx[:, :3]), R))
        t = t + dx[:, 3:]
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return R, t


class RelativePoseResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3) unit norm
    E: torch.Tensor  # (P, 3, 3) of the returned pose
    inliers: torch.Tensor  # (P, N) bool
    n_inliers: torch.Tensor  # (P,)
    ok: torch.Tensor  # (P,) bool


def estimate_relative_pose(x0: torch.Tensor, x1: torch.Tensor, valid: torch.Tensor, threshold,
                           gumbel: torch.Tensor, refine_iters: int = 8, min_inliers: int = 8,
                           minimal: str = "8pt") -> RelativePoseResult:
    """E-RANSAC -> recoverPose -> Sampson polish for P pairs: x0, x1
    (P, N, 2) normalised coordinates, valid (P, N), the minimal-sample
    draws' Gumbel noise ``gumbel`` (P, n_hypotheses, N). The polished pose is
    kept where it holds at least the RANSAC consensus; ``ok`` where the
    final consensus reaches ``min_inliers``. No host synchronisation."""
    res = find_essential_ransac(x0, x1, valid, threshold, gumbel, minimal)
    pose = recover_pose(res.E, x0, x1, res.inliers)
    R, t = refine_pose_sampson(pose.R, pose.t, x0, x1, valid, threshold, iters=refine_iters)
    E = essential_from_pose(R, t)
    inl = (sampson_error(E, x0, x1) < threshold * threshold) & valid
    better = inl.sum(-1) >= res.n_inliers
    R = torch.where(better[:, None, None], R, pose.R)
    t = torch.where(better[:, None], t, pose.t)
    E = torch.where(better[:, None, None], E, res.E)
    inl = torch.where(better[:, None], inl, res.inliers)
    n = inl.sum(-1)
    return RelativePoseResult(R=R, t=t, E=E, inliers=inl, n_inliers=n, ok=n >= min_inliers)
