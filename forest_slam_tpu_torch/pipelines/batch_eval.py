"""Batched multi-sequence evaluation over the mesh's 'data' axis (port of
pipelines/batch_eval.py).

Each rank moves only its own sequences to its device and runs the
frame-parallel stereo VO (pipelines/stereo.py:run_stereo_vo_device) on
each; its model-axis peers compute the same sequences, as ``shard_map``'s
``P("data")`` replicates them over 'model'. The poses and tracking flags
are all-gathered over 'data', and every rank scores every sequence's ATE
on the host. Each sequence draws its PnP noise from a generator seeded
from (seed, global sequence index), never from the rank, so a sharded run
gives a one-rank run's poses bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.eval.metrics import ape_translation
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.io.tum import Trajectory
from forest_slam_tpu_torch.parallel.mesh import mesh_device
from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device


class SequenceResult(NamedTuple):
    ate_rmse: float
    ok_fraction: float
    n_frames: int


def sequence_seed(seed: int, s: int) -> int:
    """The PnP generator's seed of global sequence ``s``."""
    return int(np.random.SeedSequence([seed, s]).generate_state(1)[0])


def _rig_on(rig: StereoRig, dev) -> StereoRig:
    cam = lambda c: PinholeCamera(c.K.to(dev), c.dist.to(dev), c.width, c.height)
    return StereoRig(cam(rig.left), cam(rig.right), rig.T_left_right.to(dev))


def run_batched_eval(images_l, images_r, gt_poses, rig: StereoRig, cfg: StereoConfig, mesh,
                     frontend: FrontendFns | None = None, seed: int = 0, frame_batch: int = 8, pair_batch: int = 8,
                     gumbel=None, uniform=None, with_ok: bool = False):
    """Evaluate S sequences (S, N, H, W) in [0, 255] over ``mesh`` (called
    on every rank with the same arguments). S must be divisible by the
    mesh's 'data' size. The default front end is ORB (``cfg.orb``); a
    learned one is passed in on this rank's device. ``gumbel``
    (S, N-1, n_hypotheses, K) and ``uniform`` (S, N-1, K), indexed by
    global sequence, replace the seeded draws. Returns
    (list[SequenceResult], poses (S, N-1, 4, 4) float64), and the (S, N-1)
    ok flags after them ``with_ok``."""
    if frontend is None:
        frontend = orb_frontend(cfg.orb, cfg.max_match_distance)
    S, N = images_l.shape[:2]
    data, d = mesh.size(0), mesh.get_local_rank("data")
    if S % data != 0:
        raise ValueError(f"{S} sequences not divisible by data axis {data}")
    dev = mesh_device(mesh)
    rig = _rig_on(rig, dev)
    per = S // data
    poses, oks = [], []
    for s in range(d * per, (d + 1) * per):
        il, ir = (torch.as_tensor(x[s], dtype=torch.float32, device=dev) for x in (images_l, images_r))
        gen = None
        if gumbel is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(sequence_seed(seed, s))
        outs = run_stereo_vo_device(il, ir, rig, cfg, gen, frontend, frame_batch=frame_batch, pair_batch=pair_batch,
                                    gumbel=None if gumbel is None else torch.as_tensor(gumbel[s]).to(dev),
                                    uniform=None if uniform is None else torch.as_tensor(uniform[s]).to(dev))
        poses.append(outs.pose)
        oks.append(outs.ok)
    local = torch.stack(poses)
    local_ok = torch.stack(oks).to(torch.uint8)
    pose_all = local.new_empty((S, *local.shape[1:]))
    ok_all = local_ok.new_empty((S, *local_ok.shape[1:]))
    group = mesh.get_group("data")
    dist.all_gather_into_tensor(pose_all, local.contiguous(), group=group)
    dist.all_gather_into_tensor(ok_all, local_ok.contiguous(), group=group)
    pose_np = pose_all.double().cpu().numpy()
    ok_np = ok_all.cpu().numpy().astype(bool)

    results = []
    ts = np.arange(N) * 0.1
    gt_np = np.asarray(gt_poses.cpu() if isinstance(gt_poses, torch.Tensor) else gt_poses, np.float64)
    for s in range(S):
        est = Trajectory.from_matrices(ts[1:], pose_np[s])
        gt = Trajectory.from_matrices(ts, gt_np[s])
        stats = ape_translation(est, gt, align=True, with_scale=False)
        results.append(SequenceResult(ate_rmse=float(stats.rmse), ok_fraction=float(ok_np[s].mean()), n_frames=int(N)))
    return (results, pose_np, ok_np) if with_ok else (results, pose_np)
