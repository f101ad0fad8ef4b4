"""Relocalization after tracking loss (port of backend/relocalize.py).

The reference holds the last pose when PnP fails, so one unmatched pair
offsets the rest of the trajectory by the lost motion. Here every frame
whose incoming pair failed is localised absolutely against the frames
before it, and the correction moves the whole suffix (VO after the loss is
right relative to itself, so one rigid delta fixes it):

1. retrieval: descriptor signatures (backend/loop_closure.py) of every
   frame, compared with the trusted earlier frames, the best
   ``retrieval_candidates`` tried in order of similarity;
2. verification: the VO pair estimator, reference against lost frame (one
   pair through the matcher and PnP-RANSAC on the card, the same function
   for every attempt);
3. correction: with camera-to-world chains (``compose_mode="odometry"``), a
   verified T_{c<-r} gives P_c' = P_r @ T^-1, and P_c' @ P_c^-1
   left-multiplies every pose from c on.

Frames after an unrepaired loss are never references (their absolute pose
is offset); a repair restores trust for the suffix. The walk over the
events stays on the host, in float64 numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.backend.loop_closure import descriptor_signature, verify_pairs
from forest_slam_tpu_torch.core.camera import PinholeCamera
from forest_slam_tpu_torch.core.lie import se3_inverse
from forest_slam_tpu_torch.geometry.ransac import require_draws
from forest_slam_tpu_torch.pipelines.stereo import _map


class RelocalizeConfig(NamedTuple):
    retrieval_candidates: int = 4  # reference frames tried per lost frame
    min_similarity: float = 0.5  # signature cosine gate on candidates
    min_inliers: int = 25  # PnP consensus to accept a relocalization
    min_inlier_ratio: float = 0.2  # of the matched, depth-valid set
    reproj_px: float = 2.0
    n_hypotheses: int = 512
    min_depth: float = 0.1
    max_depth: float = 1000.0


class RelocalizeEvents(NamedTuple):
    """What the walk did (numpy, on the host): one row per repaired frame."""

    frame: np.ndarray  # (E,) relocalized frame index
    reference: np.ndarray  # (E,) the frame it localised against
    n_inliers: np.ndarray  # (E,)
    n_lost: int  # lost pairs met
    n_repaired: int  # lost pairs repaired (== E)


def relocalize_trajectory(poses, ok, art, cam: PinholeCamera, frontend, image_shape,
                          cfg: RelocalizeConfig, generator: torch.Generator | None, gumbel=None,
                          uniform=None) -> tuple[np.ndarray, RelocalizeEvents]:
    """Repair a VO chain around its tracking losses.

    poses (N-1, 4, 4): camera-to-world poses of frames 1..N-1 (an
    ``compose_mode="odometry"`` chain); ok (N-1,) per-pair success; art:
    the runner's StereoArtifacts, with the features. Each verification
    draws from ``generator`` or, when it is None, takes ``gumbel``
    (n_hypotheses, K) and ``uniform`` (K,). Returns the corrected (N-1, 4, 4) float64 poses and
    the events."""
    require_draws(generator, gumbel, uniform)
    ok = np.asarray(ok.cpu() if isinstance(ok, torch.Tensor) else ok, bool)
    P = np.asarray(poses.double().cpu() if isinstance(poses, torch.Tensor) else poses, np.float64)
    P = np.concatenate([np.eye(4)[None], P], axis=0)  # frame 0 at the identity
    N = ok.shape[0] + 1
    if ok.all():
        empty = np.zeros((0,), np.int64)
        return P[1:], RelocalizeEvents(frame=empty, reference=empty, n_inliers=empty, n_lost=0, n_repaired=0)

    sigs = descriptor_signature(art.feats.desc, art.feats.valid).cpu().numpy()
    g = None if gumbel is None else gumbel[None]
    u = None if uniform is None else uniform[None]
    # frames touching no failed pair: reliable features, and a pose right
    # relative to their trust segment
    clean = np.ones(N, bool)
    clean[1:] &= ok
    clean[:-1] &= ok
    trusted = np.ones(N, bool)
    ev_frame, ev_ref, ev_inl = [], [], []
    lost_pairs = np.flatnonzero(~ok)
    for p in lost_pairs:
        c = int(p) + 1  # the frame whose incoming motion was lost
        trusted[c:] = False
        cand_mask = clean & trusted
        cand_mask[c:] = False
        cand = np.flatnonzero(cand_mask)
        if cand.size == 0:
            continue
        sims = sigs[cand] @ sigs[c]
        for oi in np.argsort(-sims)[: cfg.retrieval_candidates]:
            if sims[oi] < cfg.min_similarity:
                break
            r = int(cand[oi])
            sel = lambda i: _map(lambda a: a[i:i + 1], art.feats)
            T, n_inl, accepted = verify_pairs(sel(r), sel(c), art.z[r:r + 1], art.z_ok[r:r + 1], cam, frontend,
                                              image_shape, cfg, generator, g, u)
            if not bool(accepted[0]):
                continue
            P_c = P[r] @ se3_inverse(T[0]).double().cpu().numpy()
            delta = P_c @ np.linalg.inv(P[c])
            P[c:] = delta[None] @ P[c:]
            trusted[c:] = True
            ev_frame.append(c)
            ev_ref.append(r)
            ev_inl.append(int(n_inl[0]))
            break
    events = RelocalizeEvents(frame=np.asarray(ev_frame, np.int64), reference=np.asarray(ev_ref, np.int64),
                              n_inliers=np.asarray(ev_inl, np.int64), n_lost=int(lost_pairs.size),
                              n_repaired=len(ev_frame))
    return P[1:], events
