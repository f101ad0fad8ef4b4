#!/usr/bin/env python3
"""What the JAX package's own SLAM does on tests/test_slam.py's loop.

    JAX_PLATFORMS=cpu python3 scripts/jax_loop_reference.py [--sizes 160x224,300x480]
        [--orb 512,8] [--minimal dlt6,p3p]

The out-and-back corridor of tests/test_slam.py (n_forward=12, n_turn=18,
speed 0.25, n_rejoin=6: 72 frames, the world of PRNGKey(3)) goes through
``forest_slam_tpu.pipelines.slam.run_stereo_slam`` with the package's own
ORB, signatures and verification: odometry compose, keyframe stride 4, 16
candidates at least 6 keyframes apart, similarity 0.5, 25 inliers, 512
hypotheses. For each size and minimal solver it prints one JSON line: pairs
tracked (in all and through the in-place turn), the 16 candidates with their
similarities, the true revisits (keyframes at least 6 apart within 1.25 m
and 20 degrees of each other) with their similarity and rank among all
separated pairs, the accepted loops, and the endpoint error of VO and SLAM.
It runs on the CPU only; sizes above a few hundred pixels take minutes.
"""

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import forest_slam_tpu.pipelines.slam as slam  # noqa: E402
from forest_slam_tpu.backend.loop_closure import LoopClosureConfig  # noqa: E402
from forest_slam_tpu.frontend import OrbConfig  # noqa: E402
from forest_slam_tpu.io.synthetic import (default_rig, make_corridor_world, out_and_back_trajectory,  # noqa: E402
                                          render_view)
from forest_slam_tpu.pipelines.stereo import StereoConfig  # noqa: E402

N_FORWARD, N_TURN, SPEED, N_REJOIN = 12, 18, 0.25, 6
KF_STRIDE = 4
LOOP = dict(max_candidates=16, min_separation=6, min_similarity=0.5, min_inliers=25)
REVISIT_M, REVISIT_DEG = 1.25, 20.0  # of this trajectory's keyframes, only (0, 17): 1 m apart, one heading


def revisits(Ts: np.ndarray, min_sep: int) -> list[tuple[int, int]]:
    """Keyframe pairs at least ``min_sep`` apart whose true poses lie within
    REVISIT_M and REVISIT_DEG of each other."""
    kf = Ts[::KF_STRIDE]
    out = []
    for i in range(len(kf)):
        for j in range(i + min_sep, len(kf)):
            d = np.linalg.norm(kf[i, :3, 3] - kf[j, :3, 3])
            c = (np.trace(kf[i, :3, :3].T @ kf[j, :3, :3]) - 1.0) / 2.0
            if d < REVISIT_M and np.degrees(np.arccos(np.clip(c, -1.0, 1.0))) < REVISIT_DEG:
                out.append((i, j))
    return out


def run(H: int, W: int, n_features: int, n_levels: int, minimal: str) -> dict:
    world = make_corridor_world(jax.random.PRNGKey(3))
    rig = default_rig(H, W)
    Ts = out_and_back_trajectory(n_forward=N_FORWARD, n_turn=N_TURN, speed=SPEED, n_rejoin=N_REJOIN)

    def rf(T):
        left, _ = render_view(world, T, rig.left.K, H, W)
        right, _ = render_view(world, T @ rig.T_left_right, rig.left.K, H, W)
        return left, right

    il, ir = jax.lax.map(rf, Ts)
    stereo = StereoConfig(orb=OrbConfig(n_features=n_features, n_levels=n_levels), n_hypotheses=512,
                          compose_mode="odometry", pnp_minimal=minimal)
    cfg = slam.SlamConfig(stereo=stereo, loop=LoopClosureConfig(**LOOP), keyframe_stride=KF_STRIDE)
    seen = {}
    detect = slam.detect_loop_candidates

    def capture(sigs, loop_cfg):
        seen["sigs"] = np.asarray(sigs)
        return detect(sigs, loop_cfg)

    slam.detect_loop_candidates = capture
    t0 = time.time()
    try:
        outs = slam.run_stereo_slam(il, ir, rig, cfg, jax.random.PRNGKey(0))
        ok = np.asarray(outs.vo.ok)
    finally:
        slam.detect_loop_candidates = detect
    seconds = time.time() - t0

    Ts = np.asarray(Ts)
    sigs = seen["sigs"]
    sim = sigs @ sigs.T
    n_kf = sim.shape[0]
    sep = [(i, j) for i in range(n_kf) for j in range(i + LOOP["min_separation"], n_kf)]
    order = sorted(sep, key=lambda p: -sim[p])
    pairs = np.asarray(outs.loop_pairs)
    acc = np.asarray(outs.loop_accepted)
    gt_end = Ts[-1, :3, 3]
    turn = slice(N_FORWARD - 1, N_FORWARD + N_TURN - 1)  # the pairs that end inside the turn
    return dict(
        size=f"{W}x{H}", orb=[n_features, n_levels], minimal=minimal, tracked=int(ok.sum()), pairs=int(ok.size),
        turn_tracked=f"{int(ok[turn].sum())}/{ok[turn].size}",
        candidates=[[int(i), int(j), round(float(sim[i, j]), 4)] for i, j in pairs],
        separated_similarity=[round(float(sim[order[-1]]), 4), round(float(sim[order[0]]), 4)],
        revisits=[[i, j, round(float(sim[i, j]), 4), order.index((i, j)) + 1]
                  for i, j in revisits(Ts, LOOP["min_separation"])],
        accepted=pairs[acc].tolist(),
        vo_end_m=round(float(np.linalg.norm(np.asarray(outs.vo.pose)[-1, :3, 3] - gt_end)), 4),
        slam_end_m=round(float(np.linalg.norm(np.asarray(outs.pose)[-1, :3, 3] - gt_end)), 4),
        seconds=round(seconds, 1), jax=jax.__version__)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="160x224,300x480", help="HxW, comma-separated")
    ap.add_argument("--orb", default="512,8", help="n_features,n_levels")
    ap.add_argument("--minimal", default="dlt6,p3p", help="comma-separated PnP minimal solvers")
    args = ap.parse_args()
    n_features, n_levels = (int(x) for x in args.orb.split(","))
    for size in args.sizes.split(","):
        H, W = (int(x) for x in size.split("x"))
        for minimal in args.minimal.split(","):
            print(json.dumps(run(H, W, n_features, n_levels, minimal)), flush=True)


if __name__ == "__main__":
    main()
