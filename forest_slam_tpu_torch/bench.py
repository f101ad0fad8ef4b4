"""The port's counterpart of the repository's ``bench.py``: its serving
workload and its thesis gates, on one CUDA card.

    python -m forest_slam_tpu_torch.bench                  # learned front end, then the gates
    python -m forest_slam_tpu_torch.bench --frontend orb   # ORB, no gates
    python -m forest_slam_tpu_torch.bench --no-gates

Workload (``bench.py:217-221, 305-361``): 64 unique 960x600 corridor frames
(baseline 0.25 m, 0.15 m a frame) rendered on the card and ping-ponged to
963 frames, so 962 pairs, through ``run_stereo_vo_device`` in odometry
compose mode with 1024 DLT-6 hypotheses, frame and pair batches of 32 and
48, K=1024 with refine radius 12 for the learned front end, 512 ORB
features with no refinement for ORB. A learned front end that finds fewer
than 50 matches on two adjacent frames falls back to ORB, and says so. One
warm-up run, then the median of three timed runs, three more when their
spread exceeds 10% (``bench.py:420-454``).

Gates (``bench.py:626-909``), learned front end only: the lowres gate, and
each vo gate on its own clip rendered on the card (corridor or forest, K=10
or K=20 frame gaps), worst of seeds 0 and 1 held to ``bench.py``'s bounds;
the wide-baseline configuration is octaves (1.0, 0.707, 0.5), refine radius
24 at scales (1.0, 1.2, 1.44, 1.7) and P3P; the plain gates load
``weights/learned_frontend_stem2_subpix_wide.msgpack`` and are skipped, with
a line that says so, where that file is absent.

Every clip is rendered in ``bench.py``'s own worlds: the corridor and forest
of ``jax.random.PRNGKey(0)``, whose textures and trunks the port draws with
``utils/threefry.py`` (bit for bit the JAX package's draws). The gates'
bounds were set in those worlds; in other draws of the forest the two
forest gates pass or fail with the draw (``scripts/torch_gate_worlds.py``).

The last line of standard output is one JSON object with ``bench.py``'s
field names (``metric``, ``value``, ``unit``, ``n_frames`` (pairs),
``ok_frames``, ``ate_rmse``, ``runs_s``, ``run_spread``, ``jitter_suspect``,
``frontend``), ``rpe``, and with the gates ``{tag}_ok/_n/_ate/_seeds``,
``lowres_*`` and ``gate_failures``; progress goes to standard error.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

H, W = 600, 960
N_FRAMES, N_UNIQUE = 963, 64
BASELINE, SPEED = 0.25, 0.15
N_KPTS = 1024
ORB_FEATURES, ORB_LEVELS = 512, 8
FRAME_CHUNK, PAIR_CHUNK = 32, 48
N_HYPOTHESES = 1024
SANITY_MIN_MATCHES = 50
MAX_SPREAD = 0.10
RPE_DELTA_M = 1.0  # path length between RPE pairs: a leg of the ping-pong is 9.45 m
GATE_SEEDS = (0, 1)
WB_SCALES = (1.0, 0.707, 0.5)
WB_REFINE_SCALES = (1.0, 1.2, 1.44, 1.7)
# the lowres gate (bench.py:626-682)
LOWRES_H, LOWRES_W, LOWRES_FRAMES = 160, 224, 24
LOWRES_K = 512


class Gate(NamedTuple):
    """One vo gate of bench.py:694-909: its clip (scene, frames, metres a
    frame), the corruption of its frames (with the seeds of the left and
    right draws), its configuration, and its bounds on the worst seed."""

    tag: str
    scene: str
    n_frames: int
    speed: float
    config: str  # "wb" (wide-baseline stack), "plain" (plain checkpoint) or "main"
    min_ok: int
    max_ate: float
    corrupt: str | None = None  # "blur" or "sensor"
    corrupt_seeds: tuple = ()
    photo_norm: bool = False
    held: bool = True  # False: fails in the JAX package's record too (BENCH_r05.json)


GATES = (
    Gate("wb_k10", "corridor", 16, 1.5, "wb", 14, 0.06),
    Gate("wb_k20", "corridor", 8, 3.0, "wb", 6, 0.10),
    Gate("fwb_k20", "forest", 8, 3.0, "wb", 6, 0.06),
    Gate("blur_wb_k10", "corridor", 16, 1.5, "wb", 13, 0.10, corrupt="blur", corrupt_seeds=(17, 18), held=False),
    Gate("domain_shift", "corridor", 16, 1.5, "wb", 14, 0.10, corrupt="sensor", corrupt_seeds=(27, 28),
         photo_norm=True),
    Gate("plain_k10", "corridor", 16, 1.5, "plain", 14, 0.15),
    Gate("plain_k20", "corridor", 8, 3.0, "plain", 5, 0.15, held=False),
    Gate("fplain_k10", "forest", 16, 1.5, "plain", 10, 1.0),
    # 50% random motion blur on the first 24 frames of the workload's clip,
    # the main configuration
    Gate("blur50", "corridor", 24, SPEED, "main", 21, 0.08, corrupt="blur", corrupt_seeds=(7, 8)),
)
BLUR = dict(blur_percentage=50.0, kernel_size=15, angle_deg=45.0)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def frame_index(n_frames: int, n_unique: int) -> np.ndarray:
    """Ping-pong order 0..U-1, U-2..1, 0..: consecutive frames stay adjacent
    on the rendered trajectory (bench.py:305-311)."""
    if n_unique > 1:
        period = np.concatenate([np.arange(n_unique), np.arange(n_unique - 2, 0, -1)])
    else:
        period = np.zeros(1, np.int64)
    return np.tile(period, int(np.ceil(n_frames / len(period))))[:n_frames].astype(np.int32)


def spread(times) -> float:
    return (max(times) - min(times)) / float(np.median(times))


@functools.lru_cache(maxsize=4)
def _world_arrays(scene: str, z_far: float):
    """bench.py's PRNGKey(0) world's textures (and trunks, to ``z_far``)."""
    from forest_slam_tpu_torch.io.synthetic import corridor_textures, forest_arrays

    if scene == "forest":
        return forest_arrays(0, z_range=(-5.0, z_far), draws="jax")
    return corridor_textures(0, draws="jax")


def render_clip(scene: str, n_frames: int, speed: float, device, height: int = H, width: int = W, world=None):
    """Stereo frames of ``n_frames`` poses along the corridor trajectory,
    rendered on ``device``: (left, right, poses, rig). The world is
    bench.py's: the corridor or the forest of PRNGKey(0), its trunks to
    n_frames * speed + 20 m (unless ``world`` is given)."""
    from forest_slam_tpu_torch.io.synthetic import (
        corridor_trajectory, default_rig, make_corridor_world, make_forest_world, render_stereo)

    if world is None:
        if scene == "forest":
            world = make_forest_world(arrays=_world_arrays("forest", n_frames * speed + 20.0), device=device)
        else:
            world = make_corridor_world(textures=_world_arrays("corridor", 0.0), device=device)
    rig = default_rig(height, width, baseline=BASELINE, device=device)
    Ts = corridor_trajectory(n_frames, speed=speed, device=device)
    il, ir, _ = render_stereo(world, Ts, rig, height, width)
    return il.contiguous(), ir.contiguous(), Ts, rig


def main_config(frontend: str):
    """bench.py:334-361: odometry compose, 1024 hypotheses, refine radius 12
    for the learned front end and 0 for ORB."""
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig

    return StereoConfig(orb=OrbConfig(n_features=ORB_FEATURES, n_levels=ORB_LEVELS), max_match_distance=64,
                        n_hypotheses=N_HYPOTHESES, compose_mode="odometry",
                        match_refine_radius=12 if frontend == "sp" else 0)


def trajectory_errors(poses: torch.Tensor, truth: torch.Tensor):
    """(ATE, RPE) of estimated poses of frames 1..N-1 against ground truth of
    frames 0..N-1 at 10 Hz: ATE after SE(3) alignment, RPE as evo's point
    distance ratio over ``RPE_DELTA_M`` of path."""
    from forest_slam_tpu_torch.eval.metrics import ape_translation, rpe_distance_ratio
    from forest_slam_tpu_torch.io.tum import Trajectory

    ts = np.arange(truth.shape[0]) * 0.1
    est = Trajectory.from_matrices(ts[1:], poses.double().cpu().numpy())
    ref = Trajectory.from_matrices(ts, truth.double().cpu().numpy())
    return (ape_translation(est, ref, align=True, with_scale=False),
            rpe_distance_ratio(est, ref, delta_m=RPE_DELTA_M))


def sync_outputs(outs):
    """Wait for every output branch, as bench.py's host fetches do."""
    outs.pose.cpu()
    outs.ok.cpu()
    float(outs.map_points.sum().item())
    return outs


def timed_runs(run: Callable, n: int = 3, clock=time.perf_counter):
    """``n`` timed calls of ``run`` (after the caller's warm-up), ``n`` more
    when their spread exceeds 10% of the median: (seconds of each, the last
    output)."""
    times, out = [], None
    for rep in range(2 * n):
        if rep == n and spread(times) <= MAX_SPREAD:
            break
        if rep == n:
            log(f"# run spread {spread(times):.1%} > {MAX_SPREAD:.0%}; rerunning {n} more")
        t0 = clock()
        out = run()
        times.append(clock() - t0)
        log(f"# timed run {rep}: {times[-1]:.3f} s")
    return times, out


class Workload(NamedTuple):
    run: Callable  # one whole run, outputs synchronised
    truth: torch.Tensor  # (N, 4, 4) ground truth of the virtual frames
    frontend: str  # the front end that runs: "superpoint_superglue" or "orb"
    sanity_matches: int | None  # the learned front end's matches on two adjacent frames
    images: tuple  # (left, right, poses, rig) of the unique frames


def prepare_workload(frontend: str = "sp", device="cuda", weights: str | None = None, n_frames: int = N_FRAMES,
                     n_unique: int = N_UNIQUE, height: int = H, width: int = W, fe=None,
                     frame_chunk: int = FRAME_CHUNK, pair_chunk: int = PAIR_CHUNK) -> Workload:
    """Render the unique frames, load the front end (``fe``, a loaded
    LearnedFrontend, is used as it is), run the learned path's sanity check,
    and return the run."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_device

    t0 = time.time()
    il, ir, Ts, rig = render_clip("corridor", n_unique, SPEED, device, height, width)
    log(f"# rendered {n_unique} unique frames at {width}x{height} in {time.time() - t0:.1f} s")
    idx = torch.as_tensor(frame_index(n_frames, n_unique), device=il.device, dtype=torch.long)
    sanity = None
    if frontend == "sp":
        if fe is None:
            fe = load_learned_frontend(weights or FLAGSHIP_PATH, (height, width), N_KPTS, device=device)
        with torch.no_grad():
            f = fe.extract(il[:2])
            f0, f1 = (type(f)(*(a[i:i + 1] for a in f)) for i in (0, 1))
            sanity = int((fe.match_features(f0, f1, (height, width)).matches0 >= 0).sum().item())
        log(f"# sp sanity: {sanity} matches on adjacent frames")
        if sanity < SANITY_MIN_MATCHES:
            log("# SP FRONT END NOT TRACKING: FALLING BACK TO ORB")
            frontend = "orb"
    cfg = main_config(frontend)
    fns = learned_frontend(fe) if frontend == "sp" else orb_frontend(cfg.orb, cfg.max_match_distance)

    def run():
        g = torch.Generator(device=il.device)
        g.manual_seed(0)
        outs = run_stereo_vo_device(il[idx], ir[idx], rig, cfg, g, fns, frame_batch=frame_chunk,
                                    pair_batch=pair_chunk)
        return sync_outputs(outs)

    return Workload(run=run, truth=Ts[idx], frontend=fns.name, sanity_matches=sanity, images=(il, ir, Ts, rig))


def workload_record(outs, truth, times, frontend: str) -> dict:
    """bench.py's JSON fields for a timed workload."""
    pairs = truth.shape[0] - 1
    elapsed = float(np.median(times))
    ate, rpe = trajectory_errors(outs.pose, truth)
    run_spread = round(spread(times), 4)
    return {
        "metric": "stereo_pairs_per_sec",
        "value": round(pairs / elapsed, 2),
        "unit": "pairs/s",
        "vs_baseline": round(pairs / elapsed / 10.0, 2),
        "n_frames": pairs,
        "ok_frames": int(outs.ok.sum().item()),
        "ate_rmse": round(float(ate.rmse), 4),
        "rpe": {"delta_m": RPE_DELTA_M, "rmse_pct": round(float(rpe.rmse), 4),
                "mean_pct": round(float(rpe.mean), 4), "n": rpe.n},
        "runs_s": [round(t, 3) for t in times],
        "run_spread": run_spread,
        "jitter_suspect": run_spread > MAX_SPREAD,
        "frontend": frontend,
    }


def run_vo_gate_seed(il, ir, rig, cfg, fe, seed: int):
    """One gate run at one seed: the whole clip as one frame and one pair
    batch (bench.py's frame_chunk = pair_chunk = nF)."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_device

    g = torch.Generator(device=il.device)
    g.manual_seed(seed)
    n = il.shape[0]
    return run_stereo_vo_device(il, ir, rig, cfg, g, learned_frontend(fe), frame_batch=n, pair_batch=n)


def vo_gate(tag: str, il, ir, Ts, rig, cfg, fe, min_ok: int, max_ate: float, gates: dict, failures: list,
            seeds=GATE_SEEDS, run=run_vo_gate_seed):
    """bench.py:760's vo_gate: the clip at every seed, held on the worst
    (fewest tracked pairs, largest ATE); fills ``gates`` with
    ``{tag}_ok/_n/_ate/_seeds`` and appends to ``failures`` when out of
    bounds."""
    n = int(il.shape[0])
    per_seed = []
    for seed in seeds:
        outs = run(il, ir, rig, cfg, fe, seed)
        ate, _ = trajectory_errors(outs.pose, Ts)
        per_seed.append([int(outs.ok.sum().item()), round(float(ate.rmse), 4)])
    worst_ok = min(s[0] for s in per_seed)
    worst_ate = max(s[1] for s in per_seed)
    gates.update({f"{tag}_ok": worst_ok, f"{tag}_n": n - 1, f"{tag}_ate": worst_ate, f"{tag}_seeds": per_seed})
    log(f"# gate {tag}: worst-of-{len(seeds)} seeds {worst_ok}/{n - 1} tracked, ATE {worst_ate} m "
        f"(per-seed {per_seed})")
    if worst_ok < min_ok or not worst_ate <= max_ate:
        failures.append(f"{tag}: {worst_ok}/{n - 1} ok (need >={min_ok}), ATE {worst_ate} (need <={max_ate})")


def lowres_setup(device="cuda", weights: str | None = None):
    """The lowres gate (bench.py:626-682): 24 corridor frames at 224x160,
    octaves 1.0, 1.7, 2.89 (1.7x steps until H * s reaches 420), K=512, 512
    hypotheses, refine radius 12, one frame and pair batch: (run, ground
    truth, octaves)."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_device

    gl, gr, Ts, rig = render_clip("corridor", LOWRES_FRAMES, SPEED, device, LOWRES_H, LOWRES_W)
    scales, sc = [1.0], 1.0
    while LOWRES_H * sc < 420:
        sc *= 1.7
        scales.append(round(min(sc, 600.0 / LOWRES_H), 3))
    fe = load_learned_frontend(weights or FLAGSHIP_PATH, (LOWRES_H, LOWRES_W), LOWRES_K, device=device,
                               scales=tuple(scales))
    cfg = main_config("sp")._replace(n_hypotheses=LOWRES_K, match_refine_radius=12)

    def run():
        g = torch.Generator(device=gl.device)
        g.manual_seed(0)
        return run_stereo_vo_device(gl, gr, rig, cfg, g, learned_frontend(fe), frame_batch=LOWRES_FRAMES,
                                    pair_batch=LOWRES_FRAMES)

    return run, Ts, tuple(scales)


def lowres_gate(gates: dict, device="cuda", weights: str | None = None):
    """Run the lowres gate and fill ``gates`` with bench.py's lowres keys."""
    run, Ts, scales = lowres_setup(device, weights)
    outs = run()
    ate, _ = trajectory_errors(outs.pose, Ts)
    gates.update({"lowres_ok_frames": int(outs.ok.sum().item()), "lowres_n_frames": LOWRES_FRAMES - 1,
                  "lowres_ate_rmse": round(float(ate.rmse), 4)})
    log(f"# lowres gate {LOWRES_W}x{LOWRES_H}: {gates['lowres_ok_frames']}/{LOWRES_FRAMES - 1} tracked, "
        f"ATE {gates['lowres_ate_rmse']} m, octaves {list(scales)}")
    return outs


def gate_clip(gate: Gate, device, clip_cache: dict, unique=None, worlds=None):
    """A gate's frames (corruption applied) and ground truth. Clips shared
    by several gates are rendered once; blur50 takes the first 24 of the
    workload's unique frames (``unique``: (left, right, poses)) where given,
    the same frames rendered anew otherwise. ``worlds`` maps a scene to the
    world to render in place of bench.py's."""
    from forest_slam_tpu_torch.utils.corrupt import BlurConfig, corrupt_stack, sensor_shift_stack

    if gate.tag == "blur50" and unique is not None:
        il, ir, Ts = (a[:gate.n_frames] for a in unique[:3])
    else:
        key = (gate.scene, gate.n_frames, gate.speed)
        if key not in clip_cache:
            clip_cache[key] = render_clip(gate.scene, gate.n_frames, gate.speed, device,
                                          world=(worlds or {}).get(gate.scene))[:3]
        il, ir, Ts = clip_cache[key]
    if gate.corrupt:
        gens = []
        for s in gate.corrupt_seeds:
            g = torch.Generator(device=il.device)
            g.manual_seed(s)
            gens.append(g)
        if gate.corrupt == "blur":
            il, ir = (corrupt_stack(x, g, BlurConfig(**BLUR)) for x, g in zip((il, ir), gens))
        else:
            il, ir = (sensor_shift_stack(x, g) for x, g in zip((il, ir), gens))
    return il.contiguous(), ir.contiguous(), Ts


def run_gates(device="cuda", fe=None, unique=None, seeds=GATE_SEEDS, weights: str | None = None,
              plain_weights: str | None = None, gates_to_run=None, lowres: bool = True,
              worlds=None) -> tuple[dict, list, list]:
    """The lowres gate (unless ``lowres`` is False), then the vo gates of
    bench.py in its order, at full width: (gates, failures, the tags not
    run). ``fe``: the flagship loaded at K=1024, 960x600 (loaded here when
    None); ``unique``: the workload's unique frames, for blur50; ``worlds``:
    scene -> world to render in place of bench.py's (gate_clip)."""
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, PLAIN_WB_PATH, load_learned_frontend
    from forest_slam_tpu_torch.io.synthetic import default_rig

    weights = weights or FLAGSHIP_PATH
    plain_weights = plain_weights or PLAIN_WB_PATH
    gates, failures, not_run = {}, [], []
    if lowres:
        lowres_gate(gates, device, weights)
    if fe is None:
        fe = load_learned_frontend(weights, (H, W), N_KPTS, device=device)
    cfg = main_config("sp")
    configs = {"main": (cfg, fe),
               "wb": (cfg._replace(match_refine_radius=24, match_refine_scales=WB_REFINE_SCALES, pnp_minimal="p3p"),
                      load_learned_frontend(weights, (H, W), N_KPTS, device=device, scales=WB_SCALES))}
    if os.path.exists(plain_weights):
        configs["plain"] = (cfg._replace(match_refine_radius=0, pnp_minimal="p3p"),
                            load_learned_frontend(plain_weights, (H, W), N_KPTS, device=device))
    rig = default_rig(H, W, baseline=BASELINE, device=device)
    clips = {}
    for gate in GATES:
        if gates_to_run is not None and gate.tag not in gates_to_run:
            continue
        if gate.config not in configs:
            log(f"# gate {gate.tag}: not run: checkpoint not on the card ({os.path.basename(plain_weights)})")
            not_run.append(gate.tag)
            continue
        g_cfg, g_fe = configs[gate.config]
        il, ir, Ts = gate_clip(gate, device, clips, unique, worlds)
        vo_gate(gate.tag, il, ir, Ts, rig, g_cfg._replace(photo_norm=gate.photo_norm), g_fe, gate.min_ok,
                gate.max_ate, gates, failures, seeds)
    if failures:
        log("# GATE FAILURES: " + "; ".join(failures))
    return gates, failures, not_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frontend", choices=["sp", "orb"], default="sp")
    ap.add_argument("--weights", default=None, help="learned checkpoint (default: the flagship)")
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--no-gates", action="store_true", help="skip the lowres and vo gates")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log("# no CUDA card: pass --device cpu to run on the CPU")
        return 1
    wl = prepare_workload(args.frontend, args.device, args.weights, n_frames=args.frames,
                          n_unique=min(N_UNIQUE, args.frames))
    log(f"# workload: {args.frames - 1} pairs at {W}x{H}, frontend={wl.frontend}")
    t0 = time.time()
    wl.run()
    log(f"# first run (warm-up): {time.time() - t0:.1f} s")
    times, outs = timed_runs(wl.run)
    rec = workload_record(outs, wl.truth, times, wl.frontend)
    log(f"# median {np.median(times):.3f} s -> {rec['value']} pairs/s ({rec['ok_frames']}/{rec['n_frames']} tracked, "
        f"ATE {rec['ate_rmse']} m)")
    if wl.frontend == "superpoint_superglue" and not args.no_gates:
        gates, failures, _ = run_gates(args.device, unique=wl.images, weights=args.weights)
        rec.update(gates)
        rec["gate_failures"] = failures or None
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
