#!/usr/bin/env python3
"""Poses of the learned path on chip_smoke.py's 31-pair clip, for one
checkout's package, to hold two checkouts to bit-identical poses.

    python3 scripts/torch_clip_poses.py [--root DIR] --out FILE.npz
    python3 scripts/torch_clip_poses.py --compare A.npz B.npz

imports ``forest_slam_tpu_torch`` from ``DIR`` (default: this repository),
renders the clip with ``chip_smoke.render_clip`` (loaded from this
repository, so both checkouts get the same frames), loads the flagship
checkpoint from this repository's ``weights/`` and runs
``run_stereo_vo_device`` as ``chip_smoke.py``'s learned path does (K=1024,
refine radius 12, 1024 DLT-6 hypotheses, odometry compose, generator seed 0,
frame and pair batches of 8), after one warm-up run; it writes the poses
(31, 4, 4) and the tracked flags. ``--compare`` prints whether two files'
poses and flags are bit-identical and the largest pose difference, and
exits 1 when they are not. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(a: str, b: str) -> int:
    import numpy as np

    za, zb = np.load(a), np.load(b)
    same = np.array_equal(za["pose"], zb["pose"]) and np.array_equal(za["ok"], zb["ok"])
    diff = float(np.abs(za["pose"].astype(np.float64) - zb["pose"]).max())
    print(json.dumps({"a": a, "b": b, "bit_identical": bool(same), "max_pose_difference": diff,
                      "tracked": [int(za["ok"].sum()), int(zb["ok"].sum())]}))
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import forest_slam_tpu_torch
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flagship = os.path.join(REPO, "weights", "learned_frontend_stem4_wb_blur2.msgpack")
    fe = load_learned_frontend(flagship, (cs.H, cs.W), cs.K, device=dev)
    il, ir, _, rig = cs.render_clip(dev)
    cfg = StereoConfig(n_hypotheses=1024, compose_mode="odometry", match_refine_radius=12)

    def run():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return run_stereo_vo_device(il, ir, rig, cfg, g, learned_frontend(fe), frame_batch=cs.FRAME_BATCH,
                                    pair_batch=cs.PAIR_BATCH)

    run()
    out = run()
    torch.cuda.synchronize()
    np.savez(args.out, pose=out.pose.cpu().numpy(), ok=out.ok.cpu().numpy())
    print(json.dumps({"root": args.root, "package": os.path.dirname(forest_slam_tpu_torch.__file__),
                      "tracked": int(out.ok.sum().item()), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
