#!/usr/bin/env python3
"""The window BA's own memory and time on bench.py's 962-pair workload.

    python3 scripts/torch_window_ba_peak.py [--batches 64,240]

Runs the learned VO (flagship, K=1024, refine radius 12, frame and pair
batches 32 and 48, generator seed 0) over the 963 frames with artifacts,
builds the window tables once (``WindowBAConfig()``: 240 windows of 5
frames, the anchors re-matched), then solves the windows ``B`` at a time
for each ``B`` of ``--batches``. For each it prints one JSON line: the
peak memory the solves allocate above what was held before them, their
time (the card synchronised), and the largest difference of the refined
poses from the first batch size's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="64,240", help="windows solved at once, comma-separated")
    args = ap.parse_args()

    import torch

    from forest_slam_tpu_torch import _build, bench
    from forest_slam_tpu_torch.backend.window import Tracks, WindowBAConfig, solve_windows, window_tables
    from forest_slam_tpu_torch.core.lie import se3_orthonormalize
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_device

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    fe = load_learned_frontend(FLAGSHIP_PATH, (bench.H, bench.W), bench.N_KPTS, device=dev)
    wl = bench.prepare_workload("sp", dev, fe=fe)
    ul, ur, _, rig = wl.images
    idx = torch.as_tensor(bench.frame_index(bench.N_FRAMES, bench.N_UNIQUE), device=dev, dtype=torch.long)
    front, cfg, ba = learned_frontend(fe), bench.main_config("sp"), WindowBAConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    with torch.no_grad():
        outs, art = run_stereo_vo_device(ul[idx], ur[idx], rig, cfg, g, front, bench.FRAME_CHUNK, bench.PAIR_CHUNK,
                                         return_artifacts=True)
        N = art.valid.shape[0]
        widx, tracks, start, anchor_xy, anchor_z = window_tables(art, N, ba, front, (bench.H, bench.W),
                                                                 bench.PAIR_CHUNK)
        poses = se3_orthonormalize(outs.pose)
        T_w = torch.cat([torch.eye(4, device=dev)[None], poses])[widx]
    n_win = widx.shape[0]
    first = None
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    for B in (int(b) for b in args.batches.split(",")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with torch.no_grad():
            T_ref = torch.cat([solve_windows(T_w[s:s + B], start[s:s + B], anchor_xy[s:s + B], anchor_z[s:s + B],
                                             Tracks(*(x[s:s + B] for x in tracks)), rig.left, ba)
                               for s in range(0, n_win, B)])
        torch.cuda.synchronize()
        ms = 1e3 * (time.time() - t0)
        first = T_ref if first is None else first
        print(json.dumps({"windows_at_once": B, "windows": n_win, "landmarks_per_window": int(tracks.mask.shape[-1]),
                          "frames_per_window": int(tracks.mask.shape[1]),
                          "peak_above_held_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
                          "held_gib": held / 2**30, "ms": ms,
                          "max_pose_diff": (T_ref - first).abs().max().item(), "card": smi}), flush=True)


if __name__ == "__main__":
    main()
