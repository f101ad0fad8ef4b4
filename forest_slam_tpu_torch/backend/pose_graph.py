"""SE(3) pose-graph optimisation (port of backend/pose_graph.py).

Given keyframe poses T (world <- keyframe) and relative-pose edges Z_e
(odometry from VO, loops from backend/loop_closure.py), Gauss-Newton
minimises

    sum_e w_e * || log( Z_e^-1 * T_i^-1 * T_j ) ||^2

over the poses with left-multiplied updates, node 0 eliminated from the
system (its update stays exactly zero) and a non-finite step replaced by
zero. A fixed-size edge table with weights (0 disables an edge); each
edge's 6x6 Jacobian blocks come from ``torch.func.jacfwd`` at zero, batched
over edges with ``torch.func.vmap``; the (6N, 6N) normal matrix is summed
from one-hot products (the same sum in a fixed order on every device,
where a scatter-add on the card adds in no fixed order) and solved
densely.

The whole solve runs in float64, a departure from the JAX package's
float32: there ``se3_log`` loses ``(1 - cos theta) / theta^2`` to
cancellation, so residual rotations between 1e-4 and 3.5e-4 rad give NaN
(and Gauss-Newton's step is dropped) and up to about 1e-3 rad the
translation comes out tens of percent off, which scatters Gauss-Newton
once edges disagree (ROADMAP Queue C). Graphs are hundreds of keyframes,
so float64 costs little on the card. The poses and costs come back in the
input's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from forest_slam_tpu_torch.core.lie import mm, se3_compose, se3_exp, se3_inverse, se3_log


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4) initial absolute poses
    edge_i: torch.Tensor  # (E,) source node
    edge_j: torch.Tensor  # (E,) target node
    edge_T: torch.Tensor  # (E, 4, 4) measured relative T_i^-1 @ T_j
    edge_weight: torch.Tensor  # (E,) (0 disables an edge)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def edge_error(xi_i, xi_j, Ti, Tj, Zinv):
    """(6,) residual of one edge under left-multiplied updates xi_i, xi_j."""
    Tip = se3_compose(se3_exp(xi_i), Ti)
    Tjp = se3_compose(se3_exp(xi_j), Tj)
    return se3_log(se3_compose(se3_compose(Zinv, se3_inverse(Tip)), Tjp))


def edge_jacobians(Ti, Tj, Zinv):
    """Residuals (E, 6) and Jacobian blocks (E, 6, 6) x2 of a batch of edges
    at zero update."""
    zero = torch.zeros(Ti.shape[0], 6, dtype=Ti.dtype, device=Ti.device)
    r = edge_error(zero, zero, Ti, Tj, Zinv)
    Ji, Jj = vmap(jacfwd(edge_error, argnums=(0, 1)))(zero, zero, Ti, Tj, Zinv)
    return r, Ji, Jj


def _cost(poses, ei, ej, Zinv, w):
    r = se3_log(se3_compose(se3_compose(Zinv, se3_inverse(poses[ei])), poses[ej]))
    return (w[:, None] * r * r).sum()


def _block_sum(a, b, X, N):
    """sum_e onehot(a_e)[n] onehot(b_e)[m] X_e -> (N, N, 6, 6) (float64)."""
    eye = torch.eye(N, dtype=torch.float64, device=X.device)
    A, B = eye[a], eye[b]  # (E, N)
    AX = (A[:, :, None] * X.reshape(-1, 1, 36)).reshape(X.shape[0], -1)  # (E, N * 36)
    return (B.transpose(0, 1) @ AX).reshape(N, N, 6, 6).transpose(0, 1)


def optimize_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
                        fix_first: bool = True) -> PoseGraphResult:
    """Gauss-Newton on the edge table: the refined poses and the weighted
    costs before and after."""
    dt = graph.poses.dtype
    poses0, Z, w = graph.poses.double(), graph.edge_T.double(), graph.edge_weight.double()
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    N, dev = poses0.shape[0], poses0.device
    Zinv = se3_inverse(Z)
    eye6 = torch.eye(6, dtype=torch.float64, device=dev)
    poses = poses0
    for _ in range(iters):
        r, Ji, Jj = edge_jacobians(poses[ei], poses[ej], Zinv)
        wv = w[:, None, None]
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
        Hii, Hjj, Hij = mm(JiT, Ji) * wv, mm(JjT, Jj) * wv, mm(JiT, Jj) * wv
        bi = -(JiT * r[:, None, :]).sum(-1) * w[:, None]
        bj = -(JjT * r[:, None, :]).sum(-1) * w[:, None]
        H = (_block_sum(ei, ei, Hii, N) + _block_sum(ej, ej, Hjj, N) + _block_sum(ei, ej, Hij, N)
             + _block_sum(ej, ei, Hij.transpose(-1, -2), N))
        H = H + damping * torch.eye(N, dtype=torch.float64, device=dev)[:, :, None, None] * eye6
        eyeN = torch.eye(N, dtype=torch.float64, device=dev)
        b = eyeN[ei].transpose(0, 1) @ bi + eyeN[ej].transpose(0, 1) @ bj  # (N, 6)
        Hf = H.transpose(1, 2).reshape(6 * N, 6 * N)
        bf = b.reshape(6 * N)
        if fix_first:
            # gauge: node 0 leaves the system (a huge soft prior would wreck
            # the conditioning), its update stays exactly zero
            rest = torch.linalg.solve_ex(Hf[6:, 6:], bf[6:, None]).result[:, 0]
            dx = torch.cat([torch.zeros(6, dtype=Hf.dtype, device=dev), rest])
        else:
            dx = torch.linalg.solve_ex(Hf, bf[:, None]).result[:, 0]
        dx = dx.reshape(N, 6)
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        poses = se3_compose(se3_exp(dx), poses)
    return PoseGraphResult(poses=poses.to(dt), initial_cost=_cost(poses0, ei, ej, Zinv, w).to(dt),
                           final_cost=_cost(poses, ei, ej, Zinv, w).to(dt))


def odometry_edges(poses: torch.Tensor, weight: float = 1.0):
    """Consecutive-keyframe edge table (i, j, Z, weight) of a pose chain
    (N, 4, 4)."""
    N = poses.shape[0]
    ei = torch.arange(N - 1, dtype=torch.int32, device=poses.device)
    Z = se3_compose(se3_inverse(poses[:-1]), poses[1:])
    return ei, ei + 1, Z, torch.full((N - 1,), weight, dtype=torch.float32, device=poses.device)
