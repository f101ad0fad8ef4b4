"""PnP-RANSAC's refine-and-select stage: the CUDA kernel and its plain version.

The stage of geometry/pnp.py:solve_pnp_ransac from the top-k start
hypotheses to the returned :class:`~forest_slam_tpu_torch.geometry.pnp.PnPResult`:
the starts made rigid (``orthogonalize_pose``), refined with the identity
start by annealed Gauss-Newton (``gauss_newton_refine``), rescored, and the
best candidate re-orthonormalised. It has no Pallas counterpart: the JAX
package runs it as XLA ops. :func:`refine_and_select_plain` is the PyTorch
code of the stage; :func:`refine_and_select` launches ``csrc/pnp_refine.cu``
(one launch a call, one CTA a pair) for CUDA tensors and takes the plain
version only for CPU tensors. The kernel reads the camera from the device and
the scalars by value, so a call makes no host read; the plain version's
``torch.linalg.svd`` synchronises a CUDA device with the host.
"""

from __future__ import annotations

import ctypes

import torch

from forest_slam_tpu_torch import _build
from forest_slam_tpu_torch.core.camera import PinholeCamera
from forest_slam_tpu_torch.core.lie import se3_matrix, so3_orthonormalize
from forest_slam_tpu_torch.geometry import pnp

MAX_STARTS = 8
# points a pair: six floats each and a mask bit a candidate in shared memory
MAX_POINTS = 8192


def candidates_plain(Ps, inl, top, pts3d, pts2d, valid, cam: PinholeCamera, reproj_threshold: float,
                     refine_iters: int, identity_prior_anneal: float, gated: list | None = None):
    """The stage's candidates in PyTorch ops, from hypotheses ``Ps`` (P, H,
    3, 4), their inlier masks ``inl`` (P, H, N), the starts' indices ``top``
    (P, k) and points (P, N, 3) / (P, N, 2) / (P, N): the k refined starts,
    the first start unrefined and the refined identity, as poses (P, C, 3,
    4), inlier masks (P, C, N), counts and scores (P, C). ``gated``, if a
    list, receives each refinement step's gated counts (P, starts)."""
    P, N = pts3d.shape[:2]
    k = top.shape[1]
    dev = pts3d.device
    P_top = Ps.gather(1, top[..., None, None].expand(-1, -1, 3, 4))
    inl_top = inl.gather(1, top[..., None].expand(-1, -1, N))
    P_tops = pnp.orthogonalize_pose(P_top, pts3d[:, None], inl_top)  # (P, k, 3, 4)
    T0s = se3_matrix(P_tops[..., :3], P_tops[..., 3])
    anneal = torch.full((P, k), 4.0, device=dev)
    if identity_prior_anneal > 0:
        T0s = torch.cat([T0s, torch.eye(4, device=dev).expand(P, 1, 4, 4)], dim=1)
        anneal = torch.cat([anneal, torch.full((P, 1), float(identity_prior_anneal), device=dev)], dim=1)
    Ts = pnp.gauss_newton_refine(T0s, pts3d[:, None], pts2d[:, None], valid[:, None], cam, reproj_threshold,
                                 iters=refine_iters, anneal=anneal, gated=gated)
    # candidates: the k refined poses, the best unrefined one, the identity start
    cands = [Ts[:, :k, :3, :], P_tops[:, :1]]
    if identity_prior_anneal > 0:
        cands.append(Ts[:, k:, :3, :])
    P_c = torch.cat(cands, dim=1)
    err_c = pnp.reproject_error(P_c, pts3d[:, None], pts2d[:, None], cam)
    inl_c = (err_c < reproj_threshold) & valid[:, None]
    cnt_c = inl_c.sum(-1)
    mean_err = (err_c * inl_c).sum(-1) / torch.clamp(cnt_c, min=1)
    score = cnt_c.float() + torch.clamp(1.0 - mean_err / reproj_threshold, 0.0, 1.0)
    return P_c, inl_c, cnt_c, score


def refine_and_select_plain(Ps, inl, top, pts3d, pts2d, valid, cam: PinholeCamera, reproj_threshold: float,
                            refine_iters: int, identity_prior_anneal: float, min_inliers: int):
    """The stage in PyTorch ops (arguments as :func:`candidates_plain`'s)
    -> PnPResult: the first candidate of the highest score."""
    N = pts3d.shape[1]
    P_c, inl_c, cnt_c, score = candidates_plain(Ps, inl, top, pts3d, pts2d, valid, cam, reproj_threshold,
                                                refine_iters, identity_prior_anneal)
    b = torch.argmax(score, dim=1)  # first maximum
    P_fin = P_c.gather(1, b[:, None, None, None].expand(-1, 1, 3, 4))[:, 0]
    R = so3_orthonormalize(P_fin[..., :3])
    inl_fin = inl_c.gather(1, b[:, None, None].expand(-1, 1, N))[:, 0]
    n = cnt_c.gather(1, b[:, None])[:, 0]
    return pnp.PnPResult(R=R, t=P_fin[..., 3], inliers=inl_fin, n_inliers=n, ok=n >= min_inliers)


def refine_and_select(Ps, inl, top, pts3d, pts2d, valid, cam: PinholeCamera, reproj_threshold: float,
                      refine_iters: int, identity_prior_anneal: float, min_inliers: int):
    """:func:`refine_and_select_plain`'s function; the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. The kernel does not read
    ``inl``: it takes one polar factor of each start, which gives the pose
    that ``orthogonalize_pose``'s depth-majority choice between two factors
    gives."""
    if pts3d.device.type == "cpu":
        return refine_and_select_plain(Ps, inl, top, pts3d, pts2d, valid, cam, reproj_threshold, refine_iters,
                                       identity_prior_anneal, min_inliers)
    P, N = pts3d.shape[:2]
    H, k = Ps.shape[1], top.shape[1]
    if Ps.shape != (P, H, 3, 4) or top.shape != (P, k) or pts2d.shape != (P, N, 2) or valid.shape != (P, N):
        raise ValueError(f"refine_and_select: shapes {tuple(Ps.shape)}, {tuple(top.shape)}, {tuple(pts3d.shape)}, "
                         f"{tuple(pts2d.shape)}, {tuple(valid.shape)} do not make P pairs of N points")
    if not 1 <= k <= min(MAX_STARTS, H):
        raise ValueError(f"refine_and_select takes 1 to {MAX_STARTS} starts of the {H} hypotheses; got {k}")
    if N > MAX_POINTS:
        raise ValueError(f"refine_and_select takes at most {MAX_POINTS} points a pair; got {N}")
    if refine_iters < 0:
        raise ValueError(f"refine_iters must be >= 0; got {refine_iters}")
    tensors = ((Ps, torch.float32), (top, torch.int64), (pts3d, torch.float32), (pts2d, torch.float32),
               (valid, torch.bool), (cam.K, torch.float32), (cam.dist, torch.float32))
    for t, dt in tensors:
        if t.device != pts3d.device or t.dtype != dt:
            raise ValueError(f"refine_and_select needs {dt} on {pts3d.device}; got {t.dtype} on {t.device}")
    Ps, top, pts3d, pts2d, valid, K, dist = (t.contiguous() for t, _ in tensors)
    dev = pts3d.device
    R = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((P, 3), dtype=torch.float32, device=dev)
    inliers = torch.empty((P, N), dtype=torch.bool, device=dev)
    n = torch.empty((P,), dtype=torch.int64, device=dev)
    ok = torch.empty((P,), dtype=torch.bool, device=dev)
    if P == 0:
        return pnp.PnPResult(R=R, t=t, inliers=inliers, n_inliers=n, ok=ok)
    F = ctypes.c_float
    fn = _build.function("fs_pnp_refine", *[_build.P] * 12, *[_build.I] * 5, F, F, F, _build.I, _build.P)
    rc = fn(Ps.data_ptr(), top.data_ptr(), pts3d.data_ptr(), pts2d.data_ptr(), valid.data_ptr(), K.data_ptr(),
            dist.data_ptr(), R.data_ptr(), t.data_ptr(), inliers.data_ptr(), n.data_ptr(), ok.data_ptr(),
            P, H, N, k, refine_iters, reproj_threshold, identity_prior_anneal, pnp.GN_DAMPING, min_inliers,
            _build.stream_ptr(dev))
    _build.check("fs_pnp_refine", rc)
    refine_and_select.launches += 1
    return pnp.PnPResult(R=R, t=t, inliers=inliers, n_inliers=n, ok=ok)


refine_and_select.launches = 0
