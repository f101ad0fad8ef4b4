"""Stereo visual odometry, frame-parallel (port of pipelines/stereo.py's
batched and device runners).

Three phases over a stereo sequence (N, H, W):

1. per frame, in batches: features + per-keypoint depth, from sparse
   stereo at the keypoints or, with ``dense_depth``, from a dense SGM map
   read at them (the reference's parity path);
2. per pair, in batches: temporal match, SAD refinement of the
   observations, PnP-RANSAC and the acceptance gate;
3. chaining of the gated relative poses and world-frame map points.

:func:`run_stereo_vo` is the host entry point (ORB by default);
:func:`run_stereo_vo_device` takes any front end.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import StereoRig, backproject_depth
from forest_slam_tpu_torch.core.lie import mm, se3_chain, se3_inverse, se3_matrix
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches_quality
from forest_slam_tpu_torch.geometry.pnp import solve_pnp_ransac
from forest_slam_tpu_torch.io.tum import Trajectory
from forest_slam_tpu_torch.stereo.depth import depth_at_keypoints, disparity_to_depth
from forest_slam_tpu_torch.stereo.disparity import SgmConfig, sgm_disparity
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig, sparse_depth_at_keypoints

# frames a dense-depth SGM call takes at once (the reference's
# ``lax.map(batch_size=2)``): about 1.1 GB of volumes a frame at 600x960, D=96
SGM_FRAME_BATCH = 2


class StereoConfig(NamedTuple):
    sparse: SparseStereoConfig = SparseStereoConfig()
    reproj_threshold_px: float = 1.0
    n_hypotheses: int = 1024
    min_points: int = 6
    # pose acceptance: inliers >= ratio * valid inputs (-1: 0.0 under
    # "parity", 0.15 under "odometry"), or >= min_inliers_absolute when a
    # ratio gate is in force
    min_inlier_ratio: float = -1.0
    min_inliers_absolute: int = 12
    refine_iters: int = 8
    compose_mode: str = "parity"
    min_depth: float = 0.1
    max_depth: float = 1000.0
    # SAD refinement of the observations (0 = off)
    match_refine_radius: int = 0
    match_refine_cost_path: str = "auto"
    # the default front end of run_stereo_vo: ORB and its Hamming gate
    orb: OrbConfig = OrbConfig()
    max_match_distance: int = 64
    # when refining: drop matches that fail the refinement's uniqueness gate
    # from the PnP input set (match_refine_filter), and bias the RANSAC
    # draws by the refinement's quality (pnp_quality_sampling)
    match_refine_filter: bool = True
    pnp_quality_sampling: bool = True
    # scale ratios the refinement searches (RefineConfig.scales)
    match_refine_scales: tuple = (1.0,)
    # per-frame exposure compensation at ingest (photo_normalize_stack)
    photo_norm: bool = False
    # PnP minimal solver: "dlt6" or "p3p"
    pnp_minimal: str = "dlt6"
    # dense SGM depth read at the keypoints (the reference's parity path)
    # in place of sparse stereo
    sgm: SgmConfig = SgmConfig()
    dense_depth: bool = False


class StereoStepOut(NamedTuple):
    pose: torch.Tensor  # (N-1, 4, 4) cumulative
    map_points: torch.Tensor  # (N-1, K, 3) world-frame points
    map_valid: torch.Tensor  # (N-1, K) bool
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


class PairVO(NamedTuple):
    """Frame-to-frame VO of a batch of pairs (no chaining)."""

    rel: torch.Tensor  # (P, 4, 4) gated relative transforms
    ok: torch.Tensor  # (P,)
    n_matches: torch.Tensor  # (P,)
    n_inliers: torch.Tensor  # (P,)
    pts3d: torch.Tensor  # (P, K, 3) previous-frame camera points
    valid: torch.Tensor  # (P, K) PnP input validity
    matches: torch.Tensor  # (P, K) previous -> current keypoint or -1
    obs: torch.Tensor  # (P, K, 2) current-frame observations fed to PnP


class FrameSlab(NamedTuple):
    feats: Any  # features, leading axis = frames
    z: torch.Tensor  # (N, K) per-keypoint depth
    z_ok: torch.Tensor  # (N, K) validity


def _map(fn, tup):
    return type(tup)(*(fn(a) for a in tup))


def _cat(parts):
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


def photo_normalize_stack(images: torch.Tensor) -> torch.Tensor:
    """Per-frame exposure compensation: each (H, W) frame remapped to mean
    127 and standard deviation 48, clipped to [0, 255]
    (pipelines/stereo.py:photo_normalize_stack)."""
    mean = images.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(images.std(dim=(-2, -1), correction=0, keepdim=True), min=1e-3)
    return torch.clamp((images - mean) / std * 48.0 + 127.0, 0.0, 255.0)


def dense_depth_at_keypoints(images_l, images_r, xy, rig: StereoRig, sgm: SgmConfig) -> torch.Tensor:
    """(B, K) depths of (B, K, 2) keypoints read from the SGM depth maps of
    (B, H, W) frames, ``SGM_FRAME_BATCH`` frames at a time."""
    zs = []
    for s in range(0, images_l.shape[0], SGM_FRAME_BATCH):
        part = slice(s, s + SGM_FRAME_BATCH)
        disp = sgm_disparity(images_l[part], images_r[part], sgm)
        zs.append(depth_at_keypoints(disparity_to_depth(disp, rig.left.fx, rig.baseline), xy[part]))
    return torch.cat(zs)


def frame_features(images_l, images_r, rig: StereoRig, cfg: StereoConfig, frontend: FrontendFns):
    """Features + per-keypoint depth for a batch of frames (B, H, W). Dense
    depths are all marked valid: the pair phase's depth gate drops the
    clamped ones, as the reference does."""
    feats = frontend.extract(images_l)
    if cfg.dense_depth:
        z = dense_depth_at_keypoints(images_l, images_r, feats.xy, rig, cfg.sgm)
        return feats, z, torch.ones_like(z, dtype=torch.bool)
    z, z_ok = sparse_depth_at_keypoints(images_l, images_r, feats.xy, rig.left.fx, rig.baseline, cfg.sparse)
    return feats, z, z_ok


def match_and_pnp(prev_feats, pts3d, depth_ok, cur_feats, rig: StereoRig, cfg: StereoConfig,
                  frontend: FrontendFns, image_shape, img_prev=None, img_cur=None,
                  generator: torch.Generator | None = None, gumbel=None, uniform=None) -> PairVO:
    """Temporal match -> (refinement) -> PnP-RANSAC -> gated relative pose,
    for a batch of pairs."""
    matches = frontend.match(prev_feats, cur_feats, image_shape)
    mask = matches >= 0
    idx = torch.where(mask, matches, torch.zeros_like(matches)).long()
    valid = mask & depth_ok & prev_feats.valid
    obs = cur_feats.xy.gather(1, idx[..., None].expand(-1, -1, 2))
    weights = None
    if cfg.match_refine_radius > 0 and img_prev is not None:
        obs, ok_r, quality = refine_matches_quality(
            img_prev, img_cur, prev_feats.xy, obs, valid,
            RefineConfig(radius=cfg.match_refine_radius, cost_path=cfg.match_refine_cost_path,
                         scales=tuple(cfg.match_refine_scales)),
        )
        if cfg.match_refine_filter:
            valid = valid & ok_r
        if cfg.pnp_quality_sampling:
            # floor so no valid point is unsampleable on a flat valley
            weights = torch.clamp(quality, min=0.05)
    pnp = solve_pnp_ransac(
        pts3d, obs, valid, rig.left, generator=generator,
        reproj_threshold=cfg.reproj_threshold_px, n_hypotheses=cfg.n_hypotheses,
        min_inliers=cfg.min_points, refine_iters=cfg.refine_iters, weights=weights,
        gumbel=gumbel, uniform=uniform, minimal=cfg.pnp_minimal,
    )
    n_valid = valid.sum(-1)
    ratio = cfg.min_inlier_ratio
    if ratio < 0:
        ratio = 0.0 if cfg.compose_mode == "parity" else 0.15
    ratio_ok = pnp.n_inliers >= ratio * torch.clamp(n_valid, min=1)
    if cfg.min_inliers_absolute > 0 and ratio > 0:
        ratio_ok = ratio_ok | (pnp.n_inliers >= cfg.min_inliers_absolute)
    ok = pnp.ok & (n_valid >= cfg.min_points) & ratio_ok
    rel = se3_matrix(pnp.R, pnp.t)
    if cfg.compose_mode == "odometry":
        rel = se3_inverse(rel)
    rel = torch.where(ok[:, None, None], rel, torch.eye(4, device=rel.device).expand_as(rel))
    return PairVO(rel=rel, ok=ok, n_matches=mask.sum(-1), n_inliers=pnp.n_inliers, pts3d=pts3d,
                  valid=valid, matches=matches, obs=obs)


def pair_from_slab(pf, pz, pok, cf, rig, cfg, frontend, image_shape, img_prev=None, img_cur=None,
                   generator=None, gumbel=None, uniform=None) -> PairVO:
    """VO of a batch of pairs from per-keypoint slab entries."""
    pts3d = backproject_depth(pf.xy, pz, rig.left)
    depth_ok = pok & (pz > cfg.min_depth) & (pz < cfg.max_depth)
    return match_and_pnp(pf, pts3d, depth_ok, cf, rig, cfg, frontend, image_shape, img_prev, img_cur,
                         generator, gumbel, uniform)


def chain_and_map(pairs: PairVO, initial: torch.Tensor) -> StereoStepOut:
    """Pose chaining + world-frame map points."""
    cums = se3_chain(pairs.rel, initial=initial)
    world = mm(pairs.pts3d, cums[:, :3, :3].transpose(1, 2)) + cums[:, None, :3, 3]
    return StereoStepOut(
        pose=cums,
        map_points=world,
        map_valid=pairs.valid & pairs.ok[:, None],
        n_matches=pairs.n_matches,
        n_inliers=pairs.n_inliers,
        ok=pairs.ok,
    )


@torch.no_grad()
def run_stereo_vo_device(images_l, images_r, rig: StereoRig, cfg: StereoConfig, generator: torch.Generator,
                         frontend: FrontendFns, frame_batch: int = 8, pair_batch: int = 8) -> StereoStepOut:
    """Whole-sequence VO of (N, H, W) stereo stacks in [0, 255]: frames
    1..N-1 relative to frame 0. Batch loops stand in for the JAX runner's
    ``lax.map``; the PnP draws come from ``generator``. With
    ``cfg.photo_norm`` every frame is exposure-compensated first."""
    if cfg.photo_norm:
        images_l, images_r = photo_normalize_stack(images_l), photo_normalize_stack(images_r)
    n = images_l.shape[0]
    image_shape = tuple(images_l.shape[1:])
    parts = [frame_features(images_l[s:s + frame_batch], images_r[s:s + frame_batch], rig, cfg, frontend)
             for s in range(0, n, frame_batch)]
    feats = _cat([p[0] for p in parts])
    slab = FrameSlab(feats, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))
    refine = cfg.match_refine_radius > 0
    outs = []
    for s in range(0, n - 1, pair_batch):
        e = min(s + pair_batch, n - 1)
        prev = FrameSlab(_map(lambda a: a[s:e], feats), slab.z[s:e], slab.z_ok[s:e])
        cur = _map(lambda a: a[s + 1:e + 1], feats)
        outs.append(pair_from_slab(
            prev.feats, prev.z, prev.z_ok, cur, rig, cfg, frontend, image_shape,
            images_l[s:e] if refine else None, images_l[s + 1:e + 1] if refine else None,
            generator=generator,
        ))
    return chain_and_map(_cat(outs), torch.eye(4, device=images_l.device))


def run_stereo_vo(images_l, images_r, timestamps, rig: StereoRig, cfg: StereoConfig = StereoConfig(), seed: int = 0,
                  frontend: FrontendFns | None = None, mode: str = "batched", ba=None, device=None,
                  frame_batch: int = 8, pair_batch: int = 8) -> tuple[Trajectory, StereoStepOut]:
    """Host entry point: the trajectory of frames 1..N-1 and the per-pair
    outputs of (N, H, W) stereo stacks in [0, 255] (arrays or tensors).
    The default front end is ORB (``cfg.orb``, ``cfg.max_match_distance``);
    pass ``frontend=learned_frontend(fe)`` for SuperPoint + SuperGlue. Runs
    on ``device``, else on the images' device when they are tensors, else on
    the card. The PnP draws come from a generator seeded with ``seed``."""
    if mode != "batched":
        raise NotImplementedError(f"mode={mode!r}: the port runs the batched mode only; the sequential scan "
                                  "is left for a later slice")
    if ba is not None:
        raise NotImplementedError("ba: sliding-window bundle adjustment is left for a later slice")
    if device is None:
        device = images_l.device if isinstance(images_l, torch.Tensor) else "cuda"
    images_l, images_r = (torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                                          dtype=torch.float32, device=device) for x in (images_l, images_r))
    if frontend is None:
        frontend = orb_frontend(cfg.orb, cfg.max_match_distance)
    generator = torch.Generator(device=images_l.device)
    generator.manual_seed(seed)
    outs = run_stereo_vo_device(images_l, images_r, rig, cfg, generator, frontend, frame_batch, pair_batch)
    traj = Trajectory.from_matrices(np.asarray(timestamps)[1:], outs.pose.double().cpu().numpy())
    return traj, outs
