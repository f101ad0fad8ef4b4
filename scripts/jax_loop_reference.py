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

    JAX_PLATFORMS=cpu python3 scripts/jax_loop_reference.py --ba-compare [--sizes 160x224] [--orb 384,4]

runs the same loop through the JAX package's ``run_stereo_slam`` and the
port's (``device=cpu``), each without and with window BA
(``WindowBAConfig()``), on the same frames (the port's render of the JAX
package's world, PRNGKey(3)) with the same draws: the port's ORB features
handed to the JAX runner through a look-up front end that reads the frame
index from pixel (0, 0) of each left frame, and one fixed set of Gumbel and
preemptive draws for every PnP on both sides. For each size, minimal solver
and BA setting it prints one JSON line per package: pairs tracked, accepted
loops, the SE(3)-aligned ATE and the endpoint error of VO and of SLAM, and
the largest pose difference between the packages.
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


def _errors(poses: np.ndarray, Ts: np.ndarray) -> dict:
    """SE(3)-aligned ATE of frames 1..N-1 against the truth relative to
    frame 0, and the endpoint error."""
    from forest_slam_tpu_torch.eval.metrics import ape_translation
    from forest_slam_tpu_torch.io.tum import Trajectory

    truth = np.linalg.inv(Ts[0]) @ Ts
    ts = np.arange(truth.shape[0]) * 0.1
    ate = ape_translation(Trajectory.from_matrices(ts[1:], poses), Trajectory.from_matrices(ts, truth),
                          with_scale=False).rmse
    return dict(ate_m=round(float(ate), 5), end_m=round(float(np.linalg.norm(poses[-1, :3, 3] - truth[-1, :3, 3])), 5))


def _pairs_differing(a: np.ndarray, b: np.ndarray, tol: float = 1e-3) -> list[list]:
    """The pairs whose relative motions (from the previous pose, the first
    from the identity) differ by more than ``tol`` in a matrix entry, with
    that difference."""
    def rel(P):
        prev = np.concatenate([np.eye(4)[None], P[:-1]])
        return np.linalg.inv(prev) @ P

    d = np.abs(rel(a) - rel(b)).max(axis=(1, 2))
    return [[int(i), round(float(d[i]), 5)] for i in np.nonzero(d > tol)[0]]


def ba_compare(H: int, W: int, n_features: int, n_levels: int, minimal: str) -> list[dict]:
    """The loop through both packages' run_stereo_slam, without and with
    window BA, on the same frames with the same features and draws."""
    import jax.numpy as jnp
    import torch

    from forest_slam_tpu.backend.window import WindowBAConfig as JWindow
    from forest_slam_tpu.core.camera import PinholeCamera as JCam
    from forest_slam_tpu.core.camera import StereoRig as JRig
    from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
    from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
    from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
    from forest_slam_tpu_torch.backend.loop_closure import LoopClosureConfig as TLoop
    from forest_slam_tpu_torch.backend.window import WindowBAConfig
    from forest_slam_tpu_torch.frontend.base import orb_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig as TOrb
    from forest_slam_tpu_torch.io import synthetic as tsyn
    from forest_slam_tpu_torch.pipelines import slam as tslam
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig as TStereo

    hyp = 512
    world = tsyn.make_corridor_world(textures=tsyn.corridor_textures(3, draws="jax"), device="cpu")
    rig = tsyn.default_rig(H, W, device="cpu")
    Ts = tsyn.out_and_back_trajectory(n_forward=N_FORWARD, n_turn=N_TURN, speed=SPEED, n_rejoin=N_REJOIN,
                                      device="cpu")
    il, ir, _ = tsyn.render_stereo(world, Ts, rig, H, W)
    n = il.shape[0]
    il[:, 0, 0] = torch.arange(n, dtype=torch.float32)  # the frame index, for the JAX look-up
    orb = dict(n_features=n_features, n_levels=n_levels)
    front = orb_frontend(TOrb(**orb))
    feats = front.extract(il)
    K = feats.xy.shape[1]
    table = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                           for k, x in zip(feats._fields, feats)))
    jfront = JFrontendFns(extract=lambda fp, img: jax.tree.map(lambda a: a[img[0, 0].astype(jnp.int32)], table),
                          match=jorb_frontend(OrbConfig(**orb), 64).match, name="given")
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (hyp, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)
    jcam = JCam(K=jnp.asarray(rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    jrig = JRig(jcam, jcam, jnp.asarray(rig.T_left_right.numpy()))
    Tn = Ts.double().numpy()
    C = LOOP["max_candidates"]
    Gt, Ut = torch.as_tensor(G), torch.as_tensor(U)
    draws = tslam.SlamDraws(Gt.expand(n - 1, -1, -1), Ut.expand(n - 1, -1), Gt, Ut, Gt.expand(C, -1, -1),
                            Ut.expand(C, -1))
    out, port_poses = [], {}
    for ba_on in (False, True):
        jcfg = slam.SlamConfig(
            stereo=StereoConfig(orb=OrbConfig(**orb), n_hypotheses=hyp, compose_mode="odometry", pnp_minimal=minimal),
            loop=LoopClosureConfig(**LOOP), keyframe_stride=KF_STRIDE, ba=JWindow() if ba_on else None)
        patch = (jax.random.gumbel, jax.random.uniform)
        jax.random.gumbel = lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape) + 0.0 * key[0].astype(jnp.float32)
        jax.random.uniform = lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape) + 0.0 * key[0].astype(
            jnp.float32)
        t0 = time.time()
        try:
            jo = slam.run_stereo_slam(jnp.asarray(il.numpy()), jnp.asarray(ir.numpy()), jrig, jcfg,
                                      jax.random.PRNGKey(0), jfront, None)
            jvo, jpose = np.asarray(jo.vo.pose, np.float64), np.asarray(jo.pose, np.float64)
        finally:
            jax.random.gumbel, jax.random.uniform = patch
        t_jax = time.time() - t0
        tcfg = tslam.SlamConfig(
            stereo=TStereo(orb=TOrb(**orb), n_hypotheses=hyp, compose_mode="odometry", pnp_minimal=minimal),
            loop=TLoop(**LOOP), keyframe_stride=KF_STRIDE, ba=WindowBAConfig() if ba_on else None)
        t0 = time.time()
        to = tslam.run_stereo_slam(il, ir, rig, tcfg, None, front, draws=draws)
        t_port = time.time() - t0
        tvo, tpose = to.vo.pose.double().numpy(), to.pose.double().numpy()
        for side, vo, pose, ok, loops, acc, secs in (
                ("jax", jvo, jpose, np.asarray(jo.vo.ok), np.asarray(jo.loop_pairs), np.asarray(jo.loop_accepted),
                 t_jax),
                ("port", tvo, tpose, to.vo.ok.numpy(), to.loop_pairs.numpy(), to.loop_accepted.numpy(), t_port)):
            out.append(dict(side=side, size=f"{W}x{H}", orb=[n_features, n_levels], minimal=minimal, ba=ba_on,
                            tracked=int(ok.sum()), pairs=int(ok.size), accepted=loops[acc].tolist(),
                            vo=_errors(vo, Tn), slam=_errors(pose, Tn), seconds=round(secs, 1),
                            jax_vs_port_max_pose_diff=float(np.abs(jpose - tpose).max()),
                            jax_vs_port_vo_max_pose_diff=float(np.abs(jvo - tvo).max()),
                            jax_vs_port_vo_pairs_over_1e3=_pairs_differing(jvo, tvo)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="160x224,300x480", help="HxW, comma-separated")
    ap.add_argument("--orb", default="512,8", help="n_features,n_levels")
    ap.add_argument("--minimal", default="dlt6,p3p", help="comma-separated PnP minimal solvers")
    ap.add_argument("--ba-compare", action="store_true",
                    help="both packages' SLAM without and with window BA on the same frames and draws")
    args = ap.parse_args()
    n_features, n_levels = (int(x) for x in args.orb.split(","))
    for size in args.sizes.split(","):
        H, W = (int(x) for x in size.split("x"))
        for minimal in args.minimal.split(","):
            if args.ba_compare:
                for line in ba_compare(H, W, n_features, n_levels, minimal):
                    print(json.dumps(line), flush=True)
            else:
                print(json.dumps(run(H, W, n_features, n_levels, minimal)), flush=True)


if __name__ == "__main__":
    main()
