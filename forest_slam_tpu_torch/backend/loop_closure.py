"""Loop closure for stereo SLAM (port of backend/loop_closure.py).

1. Retrieval: each keyframe's signature is the L2-normalised mean of its
   valid keypoints' descriptors (ORB's bits as +-1, float descriptors as
   they are); all pairs' cosine similarity is one keyframe x keyframe
   product, and the candidates are the top C entries of the similarity
   masked to pairs at least ``min_separation`` keyframes apart, equal values
   in index order (``jax.lax.top_k``'s order: on the JAX package's
   ping-pong workload frames recur exactly, so ties at 1.0 are the rule).
2. Verification: all C candidates as one batch of pairs through the front
   end's matcher and PnP-RANSAC on keyframe i's stereo depths against
   keyframe j's pixels, the VO pair estimator; survivors become SE(3)
   edges for the pose graph.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, backproject_depth
from forest_slam_tpu_torch.core.lie import se3_inverse, se3_matrix
from forest_slam_tpu_torch.frontend.fast import top_k
from forest_slam_tpu_torch.geometry.pnp import solve_pnp_ransac
from forest_slam_tpu_torch.geometry.ransac import require_draws
from forest_slam_tpu_torch.pipelines.stereo import _map


class LoopClosureConfig(NamedTuple):
    max_candidates: int = 8  # verified edges (static shape)
    min_separation: int = 20  # minimum keyframe index distance
    min_similarity: float = 0.8  # signature cosine gate
    min_inliers: int = 40  # PnP consensus required to accept a loop
    min_inlier_ratio: float = 0.3  # of the matched, depth-valid set
    reproj_px: float = 2.0
    n_hypotheses: int = 512
    min_depth: float = 0.1
    max_depth: float = 1000.0


def descriptor_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K, ...) descriptors and (B, K) validity -> (B, D) L2-normalised
    signatures. Integer descriptors are packed bits, 32 a word (the port's
    ORB words are int64 holding 32 bits each, the JAX package's uint32), and
    unpack to D = 32 x words values in {-1, +1}; float descriptors are used
    as they are."""
    if not desc.dtype.is_floating_point:
        shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
        bits = (desc.long()[..., None] >> shifts) & 1  # (B, K, words, 32)
        d = bits.reshape(desc.shape[0], desc.shape[1], -1).float() * 2.0 - 1.0
    else:
        d = desc.float().reshape(desc.shape[0], desc.shape[1], -1)
    vf = valid.float()[..., None]
    mean = (d * vf).sum(1) / torch.clamp(vf.sum(1), min=1.0)
    return mean / torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-9)


def detect_loop_candidates(signatures: torch.Tensor, cfg: LoopClosureConfig):
    """(N, D) signatures -> ((C, 2) candidate keyframe pairs i < j, (C,)
    similarities, (C,) proposal mask of the similarity and separation
    gates)."""
    N = signatures.shape[0]
    sim = (signatures[:, None, :] * signatures[None, :, :]).sum(-1)  # float32, no TF32
    ii = torch.arange(N, device=sim.device)
    ok = (ii[None, :] - ii[:, None]) >= cfg.min_separation
    sim = torch.where(ok, sim, torch.full_like(sim, float("-inf")))
    C = min(cfg.max_candidates, N * N)
    vals, flat = top_k(sim.reshape(-1), C)
    pairs = torch.stack([flat // N, flat % N], dim=1)
    return pairs, vals, torch.isfinite(vals) & (vals >= cfg.min_similarity)


def verify_pairs(fi, fj, z, z_ok, cam: PinholeCamera, frontend, image_shape, cfg,
                 generator: torch.Generator | None, gumbel=None, uniform=None):
    """PnP verification of a batch of (reference, query) feature pairs:
    the reference's stereo points against the query's matched pixels.
    Returns (T_{j<-i} (B, 4, 4), n_inliers (B,), accepted (B,)); the gates
    are ``cfg``'s ``min_inliers`` and ``min_inlier_ratio``. The draws come
    from ``generator``, or from ``gumbel`` and ``uniform`` when it is None."""
    require_draws(generator, gumbel, uniform)
    matches = frontend.match(fi, fj, image_shape)
    mask = matches >= 0
    idx = torch.where(mask, matches, torch.zeros_like(matches)).long()
    valid = mask & fi.valid & z_ok & (z > cfg.min_depth) & (z < cfg.max_depth)
    pts3d = backproject_depth(fi.xy, z, cam)
    obs = fj.xy.gather(1, idx[..., None].expand(-1, -1, 2))
    pnp = solve_pnp_ransac(pts3d, obs, valid, cam, generator=generator, reproj_threshold=cfg.reproj_px,
                           n_hypotheses=cfg.n_hypotheses, min_inliers=cfg.min_inliers, gumbel=gumbel,
                           uniform=uniform)
    n_valid = valid.sum(-1)
    accepted = (pnp.ok & (pnp.n_inliers >= cfg.min_inliers)
                & (pnp.n_inliers >= cfg.min_inlier_ratio * torch.clamp(n_valid, min=1)))
    return se3_matrix(pnp.R, pnp.t), pnp.n_inliers, accepted


def verify_loops(pairs, proposal_mask, kf_feats: Any, kf_z, kf_z_ok, cam: PinholeCamera, frontend, image_shape,
                 cfg: LoopClosureConfig, generator: torch.Generator | None, gumbel=None, uniform=None):
    """Geometric verification of the C candidate pairs as one batch: (edge_T
    (C, 4, 4) measured Z_ij = T_i^-1 @ T_j, n_inliers (C,), accepted (C,)).
    ``kf_feats`` is the keyframes' feature tuple (leading axis =
    keyframe); the draws come from ``generator`` or, when it is None,
    ``gumbel``/``uniform``
    (C, n_hypotheses, K) / (C, K)."""
    i, j = pairs[:, 0], pairs[:, 1]
    T, n_inl, acc = verify_pairs(_map(lambda a: a[i], kf_feats), _map(lambda a: a[j], kf_feats), kf_z[i], kf_z_ok[i],
                                 cam, frontend, image_shape, cfg, generator, gumbel, uniform)
    # PnP maps keyframe-i camera points into keyframe j: T_{j<-i}; the edge
    # of camera-to-world chain poses is Z_ij = T_i^-1 @ T_j = T_{i<-j}
    return se3_inverse(T), n_inl, acc & proposal_mask
