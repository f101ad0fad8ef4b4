"""Linear (DLT) two-view triangulation, batched (port of
geometry/triangulation.py).

Each correspondence gives a 4x4 homogeneous system whose smallest right
singular vector is the point; all points go through one batched SVD.
"""

from __future__ import annotations

import torch


def triangulate_linear(P0: torch.Tensor, P1: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 3) in the common frame from projections P0, P1
    (..., 3, 4) and image points pts0, pts1 (..., N, 2) in their units."""
    P0, P1 = P0[..., None, :, :], P1[..., None, :, :]
    A = torch.stack([
        pts0[..., 0, None] * P0[..., 2, :] - P0[..., 0, :],
        pts0[..., 1, None] * P0[..., 2, :] - P0[..., 1, :],
        pts1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        pts1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
    ], dim=-2)  # (..., N, 4, 4)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def depths_in_camera(P: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Depth (camera z) of points (..., N, 3) under projections [R|t] (..., 3, 4)."""
    return (P[..., None, 2, :3] * pts3d).sum(-1) + P[..., None, 2, 3]
