"""Stereo SLAM: batched VO, then the back end (port of pipelines/slam.py).

1. frame-parallel stereo VO with its artifacts (pipelines/stereo.py);
2. optionally, relocalization of the frames whose pair was lost
   (backend/relocalize.py) and sliding-window BA (backend/window.py);
3. keyframes: every ``keyframe_stride``-th frame;
4. loop closure over the keyframes: retrieval, then one batch of PnP
   verifications (backend/loop_closure.py);
5. the pose graph over the keyframes, odometry and loop edges
   (backend/pose_graph.py);
6. every frame rides rigidly with its keyframe's correction:
   T_f' = T_kf' @ T_kf^-1 @ T_f.

The PnP draws come, in that order, from one generator seeded with the
seed (VO, relocalization, loop verification), or are handed in.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.backend.loop_closure import (
    LoopClosureConfig,
    descriptor_signature,
    detect_loop_candidates,
    verify_loops,
)
from forest_slam_tpu_torch.backend.pose_graph import PoseGraph, odometry_edges, optimize_pose_graph
from forest_slam_tpu_torch.backend.relocalize import RelocalizeConfig, relocalize_trajectory
from forest_slam_tpu_torch.backend.window import WindowBAConfig, refine_trajectory_ba
from forest_slam_tpu_torch.core.camera import StereoRig
from forest_slam_tpu_torch.core.lie import mm, se3_inverse
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.io.tum import Trajectory
from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, StereoStepOut, _map, _on_device, run_stereo_vo_device


class SlamConfig(NamedTuple):
    stereo: StereoConfig = StereoConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    keyframe_stride: int = 5
    pose_graph_iters: int = 10
    loop_edge_weight: float = 3.0  # relative to odometry edges
    ba: WindowBAConfig | None = None  # optional window BA before the graph
    # repair tracking losses by absolute relocalization against earlier
    # frames; needs compose_mode="odometry"
    relocalize: RelocalizeConfig | None = None


class SlamOutputs(NamedTuple):
    vo: StereoStepOut  # the VO's outputs (poses before any correction)
    pose: torch.Tensor  # (N-1, 4, 4) corrected trajectory
    n_loops: torch.Tensor  # () accepted loop edges
    loop_pairs: torch.Tensor  # (C, 2) keyframe-index candidates
    loop_accepted: torch.Tensor  # (C,)
    n_relocalized: int = 0  # tracking losses repaired


class SlamDraws(NamedTuple):
    """PnP noise handed in for every stage (each stage's shape is that of its
    batch): VO (N-1, H, K) and (N-1, K); one relocalization attempt
    (H, K) and (K,); loop verification (C, H, K) and (C, K)."""

    vo_gumbel: torch.Tensor
    vo_uniform: torch.Tensor
    reloc_gumbel: torch.Tensor
    reloc_uniform: torch.Tensor
    loop_gumbel: torch.Tensor
    loop_uniform: torch.Tensor


@torch.no_grad()
def run_stereo_slam(images_l, images_r, rig: StereoRig, cfg: SlamConfig, generator: torch.Generator | None,
                    frontend: FrontendFns | None = None, frame_batch: int = 8, pair_batch: int = 8,
                    draws: SlamDraws | None = None, timings: dict | None = None) -> SlamOutputs:
    """Full SLAM over (N, H, W) stereo stacks on their device. ``timings``,
    when given, receives the wall seconds of each stage (the card
    synchronised around it)."""
    if frontend is None:
        frontend = orb_frontend(cfg.stereo.orb, cfg.stereo.max_match_distance)
    image_shape = tuple(images_l.shape[1:])
    dev = images_l.device
    clock = _StageClock(timings, dev)
    outs, art = run_stereo_vo_device(images_l, images_r, rig, cfg.stereo, generator, frontend, frame_batch,
                                     pair_batch, return_artifacts=True,
                                     gumbel=None if draws is None else draws.vo_gumbel,
                                     uniform=None if draws is None else draws.vo_uniform)
    clock.lap("vo")
    poses = outs.pose
    n_relocalized = 0
    if cfg.relocalize is not None:
        poses_np, ev = relocalize_trajectory(poses, outs.ok, art, rig.left, frontend, image_shape, cfg.relocalize,
                                             generator, None if draws is None else draws.reloc_gumbel,
                                             None if draws is None else draws.reloc_uniform)
        poses = torch.as_tensor(poses_np, dtype=poses.dtype, device=dev)
        n_relocalized = ev.n_repaired
        clock.lap("relocalize")
    if cfg.ba is not None:
        poses = refine_trajectory_ba(poses, art, rig.left, cfg.ba, frontend=frontend, image_shape=image_shape,
                                     pair_batch=pair_batch)
        clock.lap("ba")

    N = art.valid.shape[0]
    T_wc = torch.cat([torch.eye(4, dtype=poses.dtype, device=dev)[None], poses])
    kf = torch.arange(0, N, cfg.keyframe_stride, device=dev)
    kf_feats = _map(lambda a: a[kf], art.feats)
    kf_T = T_wc[kf]

    sigs = descriptor_signature(kf_feats.desc, kf_feats.valid)
    pairs, _, proposal = detect_loop_candidates(sigs, cfg.loop)
    Z_loop, _, accepted = verify_loops(pairs, proposal, kf_feats, art.z[kf], art.z_ok[kf], rig.left, frontend,
                                       image_shape, cfg.loop, generator,
                                       None if draws is None else draws.loop_gumbel,
                                       None if draws is None else draws.loop_uniform)
    clock.lap("loop")

    ei, ej, Z_odo, w_odo = odometry_edges(kf_T)
    w_loop = torch.where(accepted, cfg.loop_edge_weight, 0.0).to(w_odo.dtype)
    graph = PoseGraph(poses=kf_T, edge_i=torch.cat([ei.long(), pairs[:, 0]]),
                      edge_j=torch.cat([ej.long(), pairs[:, 1]]), edge_T=torch.cat([Z_odo, Z_loop]),
                      edge_weight=torch.cat([w_odo, w_loop]))
    res = optimize_pose_graph(graph, iters=cfg.pose_graph_iters)

    anchor = torch.arange(N, device=dev) // cfg.keyframe_stride  # each frame's keyframe
    delta = mm(res.poses, se3_inverse(kf_T))
    T_corr = mm(delta[anchor], T_wc)
    clock.lap("pose_graph")
    return SlamOutputs(vo=outs, pose=T_corr[1:], n_loops=accepted.sum(), loop_pairs=pairs, loop_accepted=accepted,
                       n_relocalized=n_relocalized)


class _StageClock:
    """Wall seconds per stage into ``timings`` (nothing when it is None)."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = self._now()

    def _now(self):
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name):
        if self.timings is None:
            return
        t = self._now()
        self.timings[name] = t - self.t
        self.t = t


def run_slam(images_l, images_r, timestamps, rig: StereoRig, cfg: SlamConfig = SlamConfig(), seed: int = 0,
             frontend: FrontendFns | None = None, device=None, frame_batch: int = 8,
             pair_batch: int = 8) -> tuple[Trajectory, SlamOutputs]:
    """Host entry point, as ``run_stereo_vo``: the corrected trajectory of
    frames 1..N-1 and the outputs. Runs on ``device``, else on the images'
    device when they are tensors, else on the card; the draws come from a
    generator seeded with ``seed``."""
    images_l, images_r = _on_device(images_l, images_r, device)
    generator = torch.Generator(device=images_l.device)
    generator.manual_seed(seed)
    outs = run_stereo_slam(images_l, images_r, rig, cfg, generator, frontend, frame_batch, pair_batch)
    traj = Trajectory.from_matrices(np.asarray(timestamps)[1:], outs.pose.double().cpu().numpy())
    return traj, outs
