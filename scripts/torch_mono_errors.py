#!/usr/bin/env python3
"""Where the mono path's pose error comes from, on chip_smoke.py's 31-pair
clip (960x600, the left frames), for ORB and the learned flagship (K=1024),
each in odometry mode (8-point, 1024 hypotheses, generator seed 0):

- tracked pairs and the Sim(3) ATE, as chip_smoke.py reports them;
- each pair's camera-rotation error and translation-direction error
  against the truth, in degrees;
- the Sim(3) ATE of two hybrid chains, the estimated rotations with the
  true translation directions and the true rotations with the estimated
  directions, which splits the ATE between rotation and direction;
- the precision of the matches the front end hands to RANSAC: each
  match's distance to its epipolar line under the true pose, in pixels
  (sqrt(Sampson) x fx), its median and the share within the RANSAC gate
  (1 px), and the matches and inliers a pair.

    python3 scripts/torch_mono_errors.py [--out chiprun_out/mono_errors.json]

Prints one JSON object (and writes it to ``--out``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def angle(R):
    import torch

    return torch.rad2deg(torch.arccos(torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)))


def chain(R, t):
    """Cumulative camera poses of frames 1..N-1 from camera motions (R, t)."""
    from forest_slam_tpu_torch.core.lie import se3_chain, se3_matrix

    return se3_chain(se3_matrix(R, t))


def match_precision(frontend, il, cam, true_motion, batch=8):
    """Each match's distance to its epipolar line under the true pose (px)
    and the matches a pair."""
    import torch

    from forest_slam_tpu_torch.core.lie import se3_inverse
    from forest_slam_tpu_torch.geometry.epipolar import essential_from_pose, sampson_error
    from forest_slam_tpu_torch.pipelines.mono import matched_points

    dist, counts = [], []
    n_pairs = il.shape[0] - 1
    for s in range(0, n_pairs, batch):
        e = min(s + batch, n_pairs)
        feats = frontend.extract(il[s:e + 1])
        prev = type(feats)(*(a[:-1] for a in feats))
        cur = type(feats)(*(a[1:] for a in feats))
        x0, x1, mask = matched_points(prev, cur, cam, frontend, tuple(il.shape[1:]))
        point = se3_inverse(true_motion[s:e]).float()  # x1 = R x0 + t
        E = essential_from_pose(point[:, :3, :3], point[:, :3, 3])
        d = torch.sqrt(sampson_error(E, x0, x1)) * cam.fx
        dist.append(d[mask].double().cpu())
        counts.append(mask.sum(-1).cpu())
    return torch.cat(dist), torch.cat(counts)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from forest_slam_tpu_torch.core.lie import se3_inverse
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.mono import MonoConfig, run_mono_vo

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "mono_errors.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    il, _, gt, rig = chip_smoke.render_clip(dev)
    cam = rig.left
    ts = np.arange(il.shape[0]) * 0.1
    gt = gt.double()
    true = se3_inverse(gt[:-1]) @ gt[1:]
    unit = lambda v: v / v.norm(dim=-1, keepdim=True)  # noqa: E731
    fe = load_learned_frontend(FLAGSHIP_PATH, (chip_smoke.H, chip_smoke.W), chip_smoke.K, device=dev)
    cfg = MonoConfig(compose_mode="odometry", n_hypotheses=chip_smoke.MONO_HYPOTHESES)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke.nvidia_smi_line(),
              "pairs": int(true.shape[0])}
    for name, frontend in (("orb", orb_frontend(cfg.orb, cfg.max_match_distance)), ("learned", learned_frontend(fe))):
        _, out = run_mono_vo(il, ts, cam, cfg, seed=0, frontend=frontend)
        P = torch.cat([torch.eye(4, dtype=torch.float64, device=dev)[None], out.pose.double()])
        est = se3_inverse(P[:-1]) @ P[1:]
        rot = angle(true[:, :3, :3].transpose(-1, -2) @ est[:, :3, :3])
        tdir = torch.rad2deg(torch.arccos(torch.clamp((unit(est[:, :3, 3]) * unit(true[:, :3, 3])).sum(-1), -1, 1)))
        hybrid = {
            "est_rotation_true_direction": chain(est[:, :3, :3], unit(true[:, :3, 3])),
            "true_rotation_est_direction": chain(true[:, :3, :3], unit(est[:, :3, 3])),
            "true_rotation_true_direction": chain(true[:, :3, :3], unit(true[:, :3, 3])),
        }
        dist, matches = match_precision(frontend, il, cam, true)
        ok = out.ok.cpu()
        report[name] = {
            "tracked": int(ok.sum()),
            "ate_sim3_m": chip_smoke.ate(out.pose, gt, with_scale=True),
            "hybrid_ate_sim3_m": {k: chip_smoke.ate(v, gt, with_scale=True) for k, v in hybrid.items()},
            "rotation_error_deg": {"mean": float(rot.mean()), "median": float(rot.median()), "max": float(rot.max())},
            "direction_error_deg": {"mean": float(tdir.mean()), "median": float(tdir.median()),
                                    "max": float(tdir.max())},
            "matches_per_pair": float(matches.double().mean()),
            "inliers_per_pair": float(out.n_inliers.double().mean()),
            "inlier_share": float((out.n_inliers.double().cpu() / matches.double()).mean()),
            "epipolar_px": {"median": float(dist.median()), "p90": float(dist.quantile(0.9)),
                            "within_1px": float((dist < 1.0).double().mean())},
        }
    line = json.dumps(report)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
