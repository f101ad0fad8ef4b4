"""Umeyama trajectory alignment, SE(3) or Sim(3) (port of eval/alignment.py)."""

from __future__ import annotations

import numpy as np

from forest_slam_tpu_torch.io.tum import Trajectory


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares ``dst ~ s * R @ src + t`` for (N, 3) point sets;
    returns (s, R, t)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    if n < 3:
        raise ValueError(f"need >= 3 points for alignment, got {n}")
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = dst_c.T @ src_c / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / ((src_c ** 2).sum() / n)) if with_scale else 1.0
    t = mu_dst - s * R @ mu_src
    return s, R, t


def align_trajectory(est: Trajectory, ref: Trajectory, with_scale: bool = True) -> Trajectory:
    """Align ``est`` onto ``ref`` (same length, already associated)."""
    from scipy.spatial.transform import Rotation

    s, R, t = umeyama_alignment(est.positions, ref.positions, with_scale)
    pos = (s * (R @ est.positions.T)).T + t
    rot = (Rotation.from_matrix(R) * Rotation.from_quat(est.quaternions)).as_quat()
    return Trajectory(est.timestamps.copy(), pos, rot)
