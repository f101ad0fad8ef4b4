"""The port's counterpart of the repository's ``bench.py``: its serving
workload, its roofline, its device-time cross-check and its thesis gates, on
one CUDA card.

    python -m forest_slam_tpu_torch.bench                  # learned front end, then the gates
    python -m forest_slam_tpu_torch.bench --frontend orb   # ORB, no gates
    python -m forest_slam_tpu_torch.bench --no-gates --runner chunked --profile DIR
    python -m forest_slam_tpu_torch.bench --quick --device cpu

It takes every flag of ``bench.py`` with its defaults (``--device`` in place
of ``--platform``; ``--no-gates`` skips the gates alone).

Workload (``bench.py:217-221, 305-361``): 64 unique 960x600 corridor frames
(baseline 0.25 m, 0.15 m a frame) rendered on the card and ping-ponged to
963 frames, so 962 pairs, in odometry compose mode with 1024 DLT-6
hypotheses, frame and pair chunks of 32 and 48, K=1024 with refine radius 12
for the learned front end, 512 ORB features with no refinement for ORB
(``--quick``: 224x160, 24 frames, K=256, ORB at 4 levels, 512 hypotheses, no
gates). ``--runner device`` runs ``run_stereo_vo_device`` on the virtual
stack gathered whole; ``--runner chunked`` runs ``run_stereo_vo_batched``,
which gathers each chunk's frames as it goes (equal poses, bit for bit). A
learned front end that finds fewer than 50 matches on two adjacent frames
falls back to ORB, and says so. One warm-up run, then the median of three
timed runs, three more when their spread exceeds 10% (``bench.py:420-454``).

After the timed runs (``bench.py:461-599``): the roofline
(``utils/roofline.py``: FLOPs and bytes counted by formula, both floors, over
the card's peaks: ``mfu``, ``hbm_frac``, ``roofline_frac``; null where the
card is not in its table or on the CPU), and the device time of one frame
chunk and one pair chunk at the run's shapes, the sum of the device activity
``torch.profiler`` records (``device_pairs_per_sec``; on the CPU the host
clock of the same calls is printed and the field is null). A failure in
either, or in the gates, raises: nothing is caught and turned into exit 0.

Gates (``bench.py:626-909``), learned front end only: the lowres gate, and
each vo gate on its own clip rendered on the card (corridor or forest, K=10
or K=20 frame gaps), worst of seeds 0 and 1 held to ``bench.py``'s bounds;
the wide-baseline configuration is octaves (1.0, 0.707, 0.5), refine radius
24 at scales (1.0, 1.2, 1.44, 1.7) and P3P; the plain gates load
``weights/learned_frontend_stem2_subpix_wide.msgpack`` and are skipped, with
a line that says so, where that file is absent. Every learned front end the
bench and its gates load takes ``--sg-softmax``, ``--sg-attention`` and
``--sg-gnn``.

Every clip is rendered in ``bench.py``'s own worlds: the corridor and forest
of ``jax.random.PRNGKey(0)``, whose textures and trunks the port draws with
``utils/threefry.py`` (bit for bit the JAX package's draws). The gates'
bounds were set in those worlds; in other draws of the forest the two
forest gates pass or fail with the draw (``scripts/torch_gate_worlds.py``).

The last line of standard output is one JSON object with every field of
``bench.py``'s final ``emit`` (:data:`EMIT_KEYS`, and with the gates
``{tag}_ok/_n/_ate/_seeds``), ``rpe`` and ``device``; ``--drift-from FILE``
fills ``drift`` from an earlier run's line. Progress goes to standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

H, W = 600, 960
N_FRAMES, N_UNIQUE = 963, 64
BASELINE, SPEED = 0.25, 0.15
N_KPTS = 1024
N_DISP = 96
ORB_FEATURES, ORB_LEVELS = 512, 8
FRAME_CHUNK, PAIR_CHUNK = 32, 48
N_HYPOTHESES = 1024
# --quick (bench.py:253-254): 224x160, 24 frames all unique, D=48, K=256,
# ORB at 4 levels, 512 hypotheses
QUICK = dict(height=160, width=224, n_frames=24, n_unique=24, n_disp=48, n_kpts=256, orb_levels=4, n_hypotheses=512)
SANITY_MIN_MATCHES = 50
MAX_SPREAD = 0.10
RPE_DELTA_M = 1.0  # path length between RPE pairs: a leg of the ping-pong is 9.45 m
GATE_SEEDS = (0, 1)
WB_SCALES = (1.0, 0.707, 0.5)
WB_REFINE_SCALES = (1.0, 1.2, 1.44, 1.7)
# the lowres gate (bench.py:626-682)
LOWRES_H, LOWRES_W, LOWRES_FRAMES = 160, 224, 24
LOWRES_K = 512
# the accuracy tier's checkpoint and refine radius (bench.py:181-189)
ACCURACY_CHECKPOINT = "learned_frontend.msgpack"
ACCURACY_REFINE_RADIUS = 24
RUNNERS = ("device", "chunked")
# the fields of bench.py's final emit, in its order (the gates' own keys go
# between bytes_accounting and gate_failures)
EMIT_KEYS = ("metric", "value", "unit", "vs_baseline", "tier", "mfu", "hbm_frac", "roofline_frac", "bytes_accounting",
             "gate_failures", "frontend", "ok_frames", "n_frames", "ate_rmse", "lowres_ok_frames", "lowres_n_frames",
             "lowres_ate_rmse", "runs_s", "run_spread", "jitter_suspect", "device_pairs_per_sec", "drift")
# the device-time cross-check: calls of each chunk a profiled window, and
# windows (the median is taken); the profiler's own cost grows with the
# events a window holds, thousands for a pair chunk
CROSS_CHECK_CALLS, CROSS_CHECK_REPS = 1, 3


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


def main_config(frontend: str, n_kpts: int = N_KPTS, orb_levels: int = ORB_LEVELS, n_hypotheses: int = N_HYPOTHESES,
                n_disp: int = N_DISP, refine_radius: int = -1, refine_cost_path: str = "auto"):
    """bench.py:334-361: odometry compose, 1024 hypotheses, min(512, K) ORB
    features, SGM's D; refine radius ``refine_radius``, or where it is -1,
    12 for the learned front end and 0 for ORB."""
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig

    if refine_radius < 0:
        refine_radius = 12 if frontend == "sp" else 0
    return StereoConfig(orb=OrbConfig(n_features=min(ORB_FEATURES, n_kpts), n_levels=orb_levels),
                        max_match_distance=64, sgm=SgmConfig(num_disparities=n_disp), n_hypotheses=n_hypotheses,
                        compose_mode="odometry", match_refine_radius=refine_radius,
                        match_refine_cost_path=refine_cost_path)


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
    run: Callable  # one whole run by the chosen runner, outputs synchronised
    truth: torch.Tensor  # (N, 4, 4) ground truth of the virtual frames
    frontend: str  # the front end that runs: "superpoint_superglue" or "orb"
    sanity_matches: int | None  # the learned front end's matches on two adjacent frames
    images: tuple  # (left, right, poses, rig) of the unique frames
    runs: dict  # runner name ("device", "chunked") -> one whole run, the same draws
    cfg: Any  # the StereoConfig
    fns: Any  # the FrontendFns
    fe_cfg: Any  # the LearnedFrontendConfig, None for ORB
    index: torch.Tensor  # (N,) virtual frame -> unique frame
    chunks: tuple  # (frame chunk, pair chunk)


def prepare_workload(frontend: str = "sp", device="cuda", weights: str | None = None, n_frames: int = N_FRAMES,
                     n_unique: int = N_UNIQUE, height: int = H, width: int = W, fe=None,
                     frame_chunk: int = FRAME_CHUNK, pair_chunk: int = PAIR_CHUNK, runner: str = "device",
                     sg: dict | None = None, config: dict | None = None) -> Workload:
    """Render the unique frames, load the front end (``fe``, a loaded
    LearnedFrontend, is used as it is; else ``weights`` with the SuperGlue
    overrides ``sg``), run the learned path's sanity check, and return the
    runs. ``config``: keyword arguments of :func:`main_config` (K among
    them, ``n_kpts``)."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_batched, run_stereo_vo_device

    if runner not in RUNNERS:
        raise ValueError(f"unknown runner {runner!r}")
    config = dict(config or {})
    t0 = time.time()
    il, ir, Ts, rig = render_clip("corridor", n_unique, SPEED, device, height, width)
    log(f"# rendered {n_unique} unique frames at {width}x{height} in {time.time() - t0:.1f} s")
    idx = torch.as_tensor(frame_index(n_frames, n_unique), device=il.device, dtype=torch.long)
    sanity = None
    if frontend == "sp":
        if fe is None:
            fe = load_learned_frontend(weights or FLAGSHIP_PATH, (height, width), config.get("n_kpts", N_KPTS),
                                       device=device, superglue_overrides=sg)
        with torch.no_grad():
            f = fe.extract(il[:2])
            f0, f1 = (type(f)(*(a[i:i + 1] for a in f)) for i in (0, 1))
            sanity = int((fe.match_features(f0, f1, (height, width)).matches0 >= 0).sum().item())
        log(f"# sp sanity: {sanity} matches on adjacent frames")
        if sanity < SANITY_MIN_MATCHES:
            log("# SP FRONT END NOT TRACKING: FALLING BACK TO ORB")
            frontend = "orb"
    cfg = main_config(frontend, **config)
    fns = learned_frontend(fe) if frontend == "sp" else orb_frontend(cfg.orb, cfg.max_match_distance)

    def run_with(name):
        def run():
            g = torch.Generator(device=il.device)
            g.manual_seed(0)
            if name == "device":
                outs = run_stereo_vo_device(il[idx], ir[idx], rig, cfg, g, fns, frame_batch=frame_chunk,
                                            pair_batch=pair_chunk)
            else:
                outs = run_stereo_vo_batched(il, ir, rig, cfg, g, fns, frame_chunk=frame_chunk,
                                             pair_chunk=pair_chunk, frame_indices=idx)
            return sync_outputs(outs)
        return run

    runs = {name: run_with(name) for name in RUNNERS}
    return Workload(run=runs[runner], truth=Ts[idx], frontend=fns.name, sanity_matches=sanity,
                    images=(il, ir, Ts, rig), runs=runs, cfg=cfg, fns=fns,
                    fe_cfg=fe.cfg if frontend == "sp" else None, index=idx, chunks=(frame_chunk, pair_chunk))


def workload_record(outs, truth, times, frontend: str, accuracy: bool = True) -> dict:
    """bench.py's JSON fields for a timed workload (no ATE or RPE without
    ``accuracy``)."""
    pairs = truth.shape[0] - 1
    elapsed = float(np.median(times))
    run_spread = round(spread(times), 4)
    rec = {
        "metric": "stereo_pairs_per_sec",
        "value": round(pairs / elapsed, 2),
        "unit": "pairs/s",
        "vs_baseline": round(pairs / elapsed / 10.0, 2),
        "n_frames": pairs,
        "ok_frames": int(outs.ok.sum().item()),
        "ate_rmse": None,
        "rpe": None,
        "runs_s": [round(t, 3) for t in times],
        "run_spread": run_spread,
        "jitter_suspect": run_spread > MAX_SPREAD,
        "frontend": frontend,
    }
    if accuracy:
        ate, rpe = trajectory_errors(outs.pose, truth)
        rec["ate_rmse"] = round(float(ate.rmse), 4)
        rec["rpe"] = {"delta_m": RPE_DELTA_M, "rmse_pct": round(float(rpe.rmse), 4),
                      "mean_pct": round(float(rpe.mean), 4), "n": rpe.n}
    return rec


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def roofline_record(wl: Workload, elapsed: float, device) -> dict:
    """bench.py:461-498 for the port: the FLOPs and bytes of a frame chunk
    and a pair chunk (utils/roofline.py, both floors) over the run's median
    time and the card's peaks: ``mfu``, ``hbm_frac``, ``roofline_frac`` (null
    where there is no peak) and ``bytes_accounting``, with the summary's
    totals under ``summary``. The port does not pad its last chunks, so each
    chunk is counted at the run's mean chunk size: with the ceil chunk
    counts the totals are the run's own."""
    from forest_slam_tpu_torch.utils.roofline import device_peaks, roofline_summary, stereo_pipeline_costs

    n = int(wl.index.shape[0])
    fc, pc = wl.chunks
    n_fc, n_pc = -(-n // fc), -(-(n - 1) // pc)
    image_shape = tuple(wl.images[0].shape[1:])
    costs = stereo_pipeline_costs(image_shape, wl.cfg, wl.fe_cfg, n / n_fc, (n - 1) / n_pc)
    for name, c in costs.items():
        log(f"# cost[{name}]: {c.flops / 1e9:.2f} GFLOP, {c.bytes / 1e9:.3f} GB per invocation")
    peaks = device_peaks(device)
    if peaks is None:
        log(f"# roofline: no peak rates for {device_name(device)}: mfu, hbm_frac and roofline_frac are null")
    s = roofline_summary(costs, n, fc, pc, elapsed, peaks)
    if peaks is not None:
        log(f"# roofline: {s['total_flops'] / 1e12:.2f} TFLOP, {s['total_bytes'] / 1e9:.1f} GB over {elapsed:.2f}s "
            f"-> MFU {s['mfu']:.2%} (peak {s['peak_flops'] / 1e12:.0f} TF/s), HBM {s['hbm_frac']:.2%} (peak "
            f"{s['peak_bw'] / 1e9:.0f} GB/s), binding {s['roofline_frac']:.2%} on {device_name(device)}")
    return {"mfu": s["mfu"], "hbm_frac": s["hbm_frac"], "roofline_frac": s["roofline_frac"],
            "bytes_accounting": "formula", "summary": s}


def device_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one fn() call: the sum of the device activity
    torch.profiler records over `calls` calls, divided by `calls` (host
    enqueue and the gaps between kernels left out); the median over `reps`
    profiled windows after one warm-up call, since a window now and then
    records only part of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_window = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        per_window.append(us / 1e3 / calls)
    return sorted(per_window)[len(per_window) // 2]


def host_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Host-clock time of one fn() call, the median over `reps` windows of
    `calls` calls after one warm-up call (the CPU's stand-in for
    :func:`device_ms`)."""
    fn()
    per_window = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_window.append((time.perf_counter() - t0) * 1e3 / calls)
    return sorted(per_window)[len(per_window) // 2]


@torch.no_grad()
def chunk_times(wl: Workload, calls: int = CROSS_CHECK_CALLS, reps: int = CROSS_CHECK_REPS) -> tuple:
    """Seconds of one frame chunk (features and depths of the run's first
    chunk of frames) and one pair chunk (matching, refinement and PnP of its
    first chunk of pairs) at the run's shapes: device time under
    torch.profiler on the card, host time on the CPU. Frames are gathered and
    the pair chunk's features extracted before the clock runs."""
    from forest_slam_tpu_torch.pipelines.stereo import _cat, _map, frame_features, pair_from_slab

    il, ir, _, rig = wl.images
    idx, cfg, fns = wl.index, wl.cfg, wl.fns
    n = int(idx.shape[0])
    fc, pc = min(wl.chunks[0], n), min(wl.chunks[1], n - 1)
    sl, sr = il[idx[:fc]], ir[idx[:fc]]
    parts = [frame_features(il[idx[s:min(s + fc, pc + 1)]], ir[idx[s:min(s + fc, pc + 1)]], rig, cfg, fns)
             for s in range(0, pc + 1, fc)]
    feats = _cat([p[0] for p in parts])
    z, z_ok = torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts])
    prev, cur = _map(lambda a: a[:pc], feats), _map(lambda a: a[1:pc + 1], feats)
    refine = cfg.match_refine_radius > 0
    img_prev, img_cur = (il[idx[:pc]], il[idx[1:pc + 1]]) if refine else (None, None)
    g = torch.Generator(device=il.device)
    g.manual_seed(1)
    timer = device_ms if il.device.type == "cuda" else host_ms
    t_ex = timer(lambda: frame_features(sl, sr, rig, cfg, fns), calls, reps) / 1e3
    t_pr = timer(lambda: pair_from_slab(prev, z[:pc], z_ok[:pc], cur, rig, cfg, fns, tuple(il.shape[1:]), img_prev,
                                        img_cur, generator=g), calls, reps) / 1e3
    return t_ex, t_pr


def cross_check(wl: Workload, wall_pairs_per_sec: float) -> float | None:
    """bench.py:500-599 for the port: pairs / (n_fc t_ex + n_pc t_pr) from
    :func:`chunk_times`, the device's pairs a second free of host jitter;
    None on the CPU, where the host-clock figure is printed only."""
    t_ex, t_pr = chunk_times(wl)
    n = int(wl.index.shape[0])
    fc, pc = wl.chunks
    n_fc, n_pc = -(-n // fc), -(-(n - 1) // pc)
    total = n_fc * t_ex + n_pc * t_pr
    pps = round((n - 1) / total, 2)
    clock = "device time" if wl.images[0].device.type == "cuda" else "host clock, CPU (not a device time)"
    log(f"# device-time cross-check ({clock}): extract {t_ex * 1e3:.1f} ms/chunk, pair {t_pr * 1e3:.1f} ms/chunk -> "
        f"{total:.2f}s/run, {pps:.1f} pairs/s (wall: {wall_pairs_per_sec:.1f})")
    return pps if wl.images[0].device.type == "cuda" else None


def profile_report(prof, out_dir: str, cuda: bool) -> None:
    """Write the timed runs' trace to ``out_dir``/trace.json and print the
    ten device operations (kernels, copies) that took the most time (the ten
    operators with the most CPU time on the CPU)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"# profiler trace written to {path}")

    def self_time(e):
        if not cuda:
            return e.self_cpu_time_total
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = prof.key_averages()
    if cuda:
        events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(events, key=self_time, reverse=True)[:10]
    log(f"# the ten operations with the most {'device' if cuda else 'CPU'} time in the timed runs:")
    for e in top:
        log(f"#   {self_time(e) / 1e3:10.3f} ms  {e.count:7d} calls  {e.key}")


def read_record(path: str) -> dict:
    """The last line of ``path`` that is a JSON object: an earlier run's
    record of this bench."""
    with open(path) as f:
        lines = f.read().splitlines()
    for line in reversed(lines):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            return rec
    raise ValueError(f"{path}: no JSON object line")


def drift_record(path: str, current: dict) -> dict:
    """bench.py:911-940 against an earlier run of this bench: [before, now]
    for ``value``, ``ate_rmse`` and each gate's ``_ate`` and ``_ok`` in
    ``current``, with a warning on a gate ATE that has doubled or more."""
    prev = read_record(path)
    keys = ["value", "ate_rmse"] + [k for k in current if k.endswith("_ate") or k.endswith("_ok")]
    drift = {"vs": os.path.basename(path)}
    for k in keys:
        p, c = prev.get(k), current.get(k)
        if p is None or c is None:
            continue
        drift[k] = [p, c]
        if k.endswith("_ate") and p > 0 and c > 2.0 * p:
            log(f"# DRIFT WARNING: {k} {p} -> {c} (>=2x)")
    log(f"# drift against {path}: {drift}")
    return drift


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


def lowres_setup(device="cuda", weights: str | None = None, cfg=None, sg: dict | None = None):
    """The lowres gate (bench.py:626-682): 24 corridor frames at 224x160,
    octaves 1.0, 1.7, 2.89 (1.7x steps until H * s reaches 420), K=512, 512
    hypotheses, refine radius 12, one frame and pair batch, the main
    configuration ``cfg`` otherwise: (run, ground truth, octaves)."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_device

    gl, gr, Ts, rig = render_clip("corridor", LOWRES_FRAMES, SPEED, device, LOWRES_H, LOWRES_W)
    scales, sc = [1.0], 1.0
    while LOWRES_H * sc < 420:
        sc *= 1.7
        scales.append(round(min(sc, 600.0 / LOWRES_H), 3))
    fe = load_learned_frontend(weights or FLAGSHIP_PATH, (LOWRES_H, LOWRES_W), LOWRES_K, device=device,
                               scales=tuple(scales), superglue_overrides=sg)
    cfg = (cfg or main_config("sp"))._replace(n_hypotheses=LOWRES_K, match_refine_radius=12)

    def run():
        g = torch.Generator(device=gl.device)
        g.manual_seed(0)
        return run_stereo_vo_device(gl, gr, rig, cfg, g, learned_frontend(fe), frame_batch=LOWRES_FRAMES,
                                    pair_batch=LOWRES_FRAMES)

    return run, Ts, tuple(scales)


def lowres_gate(gates: dict, device="cuda", weights: str | None = None, cfg=None, sg: dict | None = None):
    """Run the lowres gate and fill ``gates`` with bench.py's lowres keys."""
    run, Ts, scales = lowres_setup(device, weights, cfg, sg)
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
              worlds=None, cfg=None, sg: dict | None = None) -> tuple[dict, list, list]:
    """The lowres gate (unless ``lowres`` is False), then the vo gates of
    bench.py in its order, at full width: (gates, failures, the tags not
    run). ``fe``: the flagship loaded at K=1024, 960x600 (loaded here when
    None); ``unique``: the workload's unique frames, for blur50; ``worlds``:
    scene -> world to render in place of bench.py's (gate_clip); ``cfg``:
    the main configuration (default :func:`main_config` of the learned
    front end); ``sg``: SuperGlue overrides of every front end loaded here."""
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, PLAIN_WB_PATH, load_learned_frontend
    from forest_slam_tpu_torch.io.synthetic import default_rig

    weights = weights or FLAGSHIP_PATH
    plain_weights = plain_weights or PLAIN_WB_PATH
    cfg = cfg or main_config("sp")
    gates, failures, not_run = {}, [], []
    if lowres:
        lowres_gate(gates, device, weights, cfg, sg)
    if fe is None:
        fe = load_learned_frontend(weights, (H, W), N_KPTS, device=device, superglue_overrides=sg)
    configs = {"main": (cfg, fe),
               "wb": (cfg._replace(match_refine_radius=24, match_refine_scales=WB_REFINE_SCALES, pnp_minimal="p3p"),
                      load_learned_frontend(weights, (H, W), N_KPTS, device=device, scales=WB_SCALES,
                                            superglue_overrides=sg))}
    if os.path.exists(plain_weights):
        configs["plain"] = (cfg._replace(match_refine_radius=0, pnp_minimal="p3p"),
                            load_learned_frontend(plain_weights, (H, W), N_KPTS, device=device,
                                                  superglue_overrides=sg))
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


def build_parser() -> argparse.ArgumentParser:
    """bench.py's flags with its defaults (bench.py:110-180), ``--device``
    in place of ``--platform``, and ``--no-gates``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="224x160, 24 frames, K=256, ORB at 4 levels, no gates")
    ap.add_argument("--frames", type=int, default=None, help="virtual frames (default 963, 24 under --quick)")
    ap.add_argument("--frontend", choices=["sp", "orb", "auto"], default="auto",
                    help="auto: the learned front end when its checkpoint exists, else ORB")
    ap.add_argument("--weights", type=str, default=None,
                    help="learned front-end checkpoint (.msgpack); overrides the --tier preset's weights")
    ap.add_argument("--tier", choices=["speed", "accuracy"], default="speed",
                    help="speed: the flagship at refine radius 12; accuracy: weights/learned_frontend.msgpack at "
                         "radius 24 (the flagship where that file is absent)")
    ap.add_argument("--no-accuracy", action="store_true", help="skip the synthetic-GT ATE pass and the gates")
    ap.add_argument("--profile", type=str, default=None,
                    help="torch.profiler trace of the timed runs, written to this directory")
    ap.add_argument("--frame-chunk", type=int, default=FRAME_CHUNK, help="frames a feature chunk")
    ap.add_argument("--pair-chunk", type=int, default=PAIR_CHUNK, help="pairs a matching and PnP chunk")
    ap.add_argument("--sg-softmax", choices=["float32", "bfloat16"], default="bfloat16",
                    help="softmax dtype of the dense (xla) attention")
    ap.add_argument("--sg-attention", choices=["auto", "xla", "fused", "flash"], default="auto",
                    help="attention of the unfused layer: the attention kernel (auto, fused), dense einsum + "
                         "softmax (xla), or scaled_dot_product_attention (flash)")
    ap.add_argument("--sg-gnn", choices=["auto", "xla", "fused"], default="auto",
                    help="GNN layers: the fused layer kernel (auto, fused) or op by op (xla)")
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="PnP-RANSAC hypothesis batch (default 1024, 512 under --quick)")
    ap.add_argument("--refine-cost-path", choices=["auto", "xla", "pallas"], default="auto",
                    help="refinement SAD: the kernel on the card (auto), the plain version (xla), the kernel or "
                         "an error (pallas)")
    ap.add_argument("--refine-radius", type=int, default=-1,
                    help="post-match SAD refinement radius px; -1 = auto (12 learned, 0 ORB, 24 at the "
                         "accuracy tier)")
    ap.add_argument("--no-device-time", action="store_true", help="skip the device-time cross-check")
    ap.add_argument("--runner", choices=list(RUNNERS), default="device",
                    help="device: the virtual stack gathered whole; chunked: each chunk gathers its frames")
    ap.add_argument("--drift-from", type=str, default=None,
                    help="an earlier run's output of this bench: print [before, now] of the headline and gates")
    ap.add_argument("--no-gates", action="store_true", help="skip the lowres and vo gates")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return ap


class Settings(NamedTuple):
    """The run the flags ask for, resolved as bench.py resolves them."""

    frontend: str  # "sp" or "orb", before the learned front end's sanity check
    weights: str
    tier: str  # as the record states it: the tier, and the checkpoint where the preset's is absent
    height: int
    width: int
    n_frames: int
    n_unique: int
    config: dict  # keyword arguments of main_config
    sg: dict  # SuperGlue overrides of every learned front end loaded


def resolve(args) -> Settings:
    """bench.py:181-361's resolution: the tier's weights and refine radius
    (explicit flags win), the front end (auto: sp when the weights exist),
    --quick's sizes, --frames, the hypotheses."""
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, WEIGHTS_DIR

    tier, weights, radius = args.tier, args.weights, args.refine_radius
    if weights is None:
        weights = FLAGSHIP_PATH
        if args.tier == "accuracy":
            stem1 = os.path.join(WEIGHTS_DIR, ACCURACY_CHECKPOINT)
            if os.path.exists(stem1):
                weights = stem1
            else:
                tier = f"accuracy ({ACCURACY_CHECKPOINT} absent: {os.path.basename(FLAGSHIP_PATH)} ran)"
                log(f"# tier accuracy: {stem1} is absent; running {FLAGSHIP_PATH} at the accuracy tier's radius")
    if radius < 0 and args.tier == "accuracy":
        radius = ACCURACY_REFINE_RADIUS
    frontend = args.frontend if args.frontend != "auto" else ("sp" if os.path.exists(weights) else "orb")
    sizes = dict(QUICK) if args.quick else dict(height=H, width=W, n_frames=N_FRAMES, n_unique=N_UNIQUE, n_disp=N_DISP,
                                                n_kpts=N_KPTS, orb_levels=ORB_LEVELS, n_hypotheses=N_HYPOTHESES)
    if args.frames:
        sizes["n_frames"] = args.frames
        sizes["n_unique"] = min(sizes["n_unique"], args.frames)
    config = dict(n_kpts=sizes["n_kpts"], orb_levels=sizes["orb_levels"], n_disp=sizes["n_disp"],
                  n_hypotheses=args.hypotheses or sizes["n_hypotheses"], refine_radius=radius,
                  refine_cost_path=args.refine_cost_path)
    sg = {"softmax_dtype": args.sg_softmax, "attention_impl": args.sg_attention, "gnn_impl": args.sg_gnn}
    return Settings(frontend, weights, tier, sizes["height"], sizes["width"], sizes["n_frames"], sizes["n_unique"],
                    config, sg)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log("# no CUDA card: pass --device cpu to run on the CPU")
        return 1
    st = resolve(args)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    log(f"# device: {device_name(device)}; tier {st.tier}, weights {st.weights}")
    wl = prepare_workload(st.frontend, device, st.weights, n_frames=st.n_frames, n_unique=st.n_unique,
                          height=st.height, width=st.width, frame_chunk=args.frame_chunk, pair_chunk=args.pair_chunk,
                          runner=args.runner, sg=st.sg, config=st.config)
    log(f"# workload: {st.n_frames - 1} pairs at {st.width}x{st.height}, frontend={wl.frontend}, "
        f"runner={args.runner}")
    t0 = time.time()
    wl.run()
    log(f"# first run (warm-up): {time.time() - t0:.1f} s")
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    with prof if prof is not None else contextlib.nullcontext():
        times, outs = timed_runs(wl.run)
    if prof is not None:
        profile_report(prof, args.profile, cuda)
    elapsed = float(np.median(times))
    rec = workload_record(outs, wl.truth, times, wl.frontend, accuracy=not args.no_accuracy)
    log(f"# median {elapsed:.3f} s -> {rec['value']} pairs/s ({rec['ok_frames']}/{rec['n_frames']} tracked, "
        f"ATE {rec['ate_rmse']} m)")
    roof = roofline_record(wl, elapsed, device)
    device_pps = None if args.no_device_time else cross_check(wl, rec["value"])
    gates, failures = {}, []
    if wl.frontend == "superpoint_superglue" and not (args.no_gates or args.quick or args.no_accuracy):
        gate_cfg = main_config("sp", **st.config)
        gates, failures, _ = run_gates(device, unique=wl.images, weights=st.weights, cfg=gate_cfg, sg=st.sg)
    drift = drift_record(args.drift_from, {**rec, **gates}) if args.drift_from else None
    lowres = {k: gates.pop(k, None) for k in ("lowres_ok_frames", "lowres_n_frames", "lowres_ate_rmse")}
    fields = {**rec, **roof, **lowres, "tier": st.tier, "gate_failures": failures or None,
              "device_pairs_per_sec": device_pps, "drift": drift}
    record = {}
    for k in EMIT_KEYS:  # bench.py's order, the gates' own keys before gate_failures
        if k == "gate_failures":
            record.update(gates)
        record[k] = fields[k]
    record.update(rpe=rec["rpe"], device=device_name(device))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
