"""Monocular visual odometry (port of pipelines/mono.py).

The reference's ``mono_slam.py`` loop: features, matching against the
previous frame, essential-matrix RANSAC with ``recoverPose``, and chaining.
Two runners compute the same thing:

- :func:`run_mono_vo_batched`: every frame's features in batches, every
  consecutive pair's relative pose in batches, then the chain;
- :func:`run_mono_vo_scan`: a loop over frames with a batch of one.

Each pair's (n_hypotheses, K) Gumbel noise for the minimal-sample draws is
drawn in pair order from one generator by both runners (or handed in), so
they draw the same samples.

Composition: ``compose_mode="parity"`` reproduces the reference,
``cumulative @= [R|t]`` with the point transform and unit-norm translation
(mono scale is unobservable, quirk B6); ``"odometry"`` composes the camera
pose, ``cumulative @= inv([R|t])``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera
from forest_slam_tpu_torch.core.lie import se3_chain, se3_inverse, se3_matrix
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.geometry.epipolar import estimate_relative_pose
from forest_slam_tpu_torch.geometry.ransac import gumbel_per_item
from forest_slam_tpu_torch.io.tum import Trajectory
from forest_slam_tpu_torch.pipelines.stereo import _cat, _map


class MonoConfig(NamedTuple):
    orb: OrbConfig = OrbConfig()
    ransac_threshold_px: float = 1.0  # mono_slam.py:111 threshold=1.0
    n_hypotheses: int = 1024
    max_match_distance: int = 64
    refine_iters: int = 8
    compose_mode: str = "parity"
    min_matches: int = 8
    # essential minimal solver: "8pt", "5pt" (Nister, the reference's
    # cv2.findEssentialMat) or "auto": 5pt under "parity", 8pt under "odometry"
    minimal: str = "auto"


def resolve_minimal(cfg: MonoConfig) -> str:
    if cfg.minimal != "auto":
        return cfg.minimal
    return "5pt" if cfg.compose_mode == "parity" else "8pt"


class MonoStepOut(NamedTuple):
    pose: torch.Tensor  # (N-1, 4, 4) cumulative
    n_matches: torch.Tensor  # (N-1,)
    n_inliers: torch.Tensor  # (N-1,)
    ok: torch.Tensor  # (N-1,) bool


class MonoPair(NamedTuple):
    rel: torch.Tensor  # (P, 4, 4) gated relative transforms
    ok: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor


def normalize(xy: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """Pixels (..., 2) -> normalised camera coordinates."""
    return (xy - torch.stack([cam.cx, cam.cy])) / torch.stack([cam.fx, cam.fy])


def matched_points(prev_feats, cur_feats, cam: PinholeCamera, frontend: FrontendFns, image_shape):
    """A batch of pairs' matches as normalised points: x0 (P, K, 2) of the
    previous frames' keypoints, x1 (P, K, 2) of their matches in the current
    frames, and the mask (P, K) of the keypoints that have one."""
    matches = frontend.match(prev_feats, cur_feats, image_shape)
    mask = matches >= 0
    idx = torch.where(mask, matches, torch.zeros_like(matches)).long()
    x0 = normalize(prev_feats.xy, cam)
    x1 = normalize(cur_feats.xy.gather(1, idx[..., None].expand(-1, -1, 2)), cam)
    return x0, x1, mask


def mono_pairs(prev_feats, cur_feats, cam: PinholeCamera, cfg: MonoConfig, frontend: FrontendFns, image_shape,
               generator: torch.Generator, gumbel: torch.Tensor | None = None) -> MonoPair:
    """Match -> relative pose -> gated relative transform for a batch of
    pairs. ``gumbel`` (P, n_hypotheses, K), else each pair's drawn in turn
    from ``generator``."""
    x0, x1, mask = matched_points(prev_feats, cur_feats, cam, frontend, image_shape)
    if gumbel is None:
        gumbel = gumbel_per_item(x0.shape[0], (cfg.n_hypotheses, x0.shape[1]), generator, x0.device)
    rel_pose = estimate_relative_pose(x0, x1, mask, cfg.ransac_threshold_px / cam.fx, gumbel,
                                      refine_iters=cfg.refine_iters, minimal=resolve_minimal(cfg))
    n_matches = mask.sum(-1)
    ok = rel_pose.ok & (n_matches >= cfg.min_matches)
    rel = se3_matrix(rel_pose.R, rel_pose.t)
    if cfg.compose_mode == "odometry":
        rel = se3_inverse(rel)
    rel = torch.where(ok[:, None, None], rel, torch.eye(4, device=rel.device).expand_as(rel))
    return MonoPair(rel=rel, ok=ok, n_matches=n_matches, n_inliers=rel_pose.n_inliers)


def _outs(pairs: MonoPair) -> MonoStepOut:
    return MonoStepOut(pose=se3_chain(pairs.rel), n_matches=pairs.n_matches, n_inliers=pairs.n_inliers, ok=pairs.ok)


@torch.no_grad()
def run_mono_vo_batched(images: torch.Tensor, cam: PinholeCamera, cfg: MonoConfig, generator: torch.Generator,
                        frontend: FrontendFns, frame_batch: int = 8, pair_batch: int = 8,
                        gumbel: torch.Tensor | None = None) -> MonoStepOut:
    """Frames (N, H, W) in [0, 255]: features ``frame_batch`` frames at a
    time, pairs ``pair_batch`` at a time, then the chain of frames 1..N-1."""
    n = images.shape[0]
    image_shape = tuple(images.shape[1:])
    feats = _cat([frontend.extract(images[s:s + frame_batch]) for s in range(0, n, frame_batch)])
    outs = []
    for s in range(0, n - 1, pair_batch):
        e = min(s + pair_batch, n - 1)
        outs.append(mono_pairs(_map(lambda a: a[s:e], feats), _map(lambda a: a[s + 1:e + 1], feats), cam, cfg,
                               frontend, image_shape, generator, None if gumbel is None else gumbel[s:e]))
    return _outs(_cat(outs))


@torch.no_grad()
def run_mono_vo_scan(images: torch.Tensor, cam: PinholeCamera, cfg: MonoConfig, generator: torch.Generator,
                     frontend: FrontendFns, gumbel: torch.Tensor | None = None) -> MonoStepOut:
    """The same as :func:`run_mono_vo_batched`, one frame and one pair at a
    time: the sequential form of the reference's loop."""
    image_shape = tuple(images.shape[1:])
    prev = frontend.extract(images[:1])
    outs = []
    for i in range(1, images.shape[0]):
        cur = frontend.extract(images[i:i + 1])
        outs.append(mono_pairs(prev, cur, cam, cfg, frontend, image_shape, generator,
                               None if gumbel is None else gumbel[i - 1:i]))
        prev = cur
    return _outs(_cat(outs))


def run_mono_vo(images, timestamps, cam: PinholeCamera, cfg: MonoConfig = MonoConfig(), seed: int = 0,
                frontend: FrontendFns | None = None, mode: str = "batched", device=None,
                gumbel: torch.Tensor | None = None) -> tuple[Trajectory, MonoStepOut]:
    """Host entry point: the trajectory of frames 1..N-1 (the reference
    appends a pose once a previous frame exists) and the per-pair outputs of
    an (N, H, W) stack in [0, 255] (an array or a tensor). The default front
    end is ORB (``cfg.orb``, ``cfg.max_match_distance``); pass
    ``frontend=learned_frontend(fe)`` for SuperPoint + SuperGlue. ``mode``:
    "batched" or "scan". Runs on ``device``, else on the images' device when
    they are a tensor, else on the card. The draws come from a generator
    seeded with ``seed``, or from ``gumbel`` (N-1, n_hypotheses, K)."""
    if mode not in ("batched", "scan"):
        raise ValueError(f"unknown mode {mode!r}")
    if device is None:
        device = images.device if isinstance(images, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_mono_vo runs on a CUDA card, and none is available; pass device='cpu' to run on "
                           "the CPU")
    images = torch.as_tensor(images if isinstance(images, torch.Tensor) else np.asarray(images), dtype=torch.float32,
                             device=device)
    cam = cam._replace(K=cam.K.to(device), dist=cam.dist.to(device))
    if frontend is None:
        frontend = orb_frontend(cfg.orb, cfg.max_match_distance)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if mode == "batched":
        outs = run_mono_vo_batched(images, cam, cfg, generator, frontend, gumbel=gumbel)
    else:
        outs = run_mono_vo_scan(images, cam, cfg, generator, frontend, gumbel)
    traj = Trajectory.from_matrices(np.asarray(timestamps)[1:], outs.pose.double().cpu().numpy())
    return traj, outs
