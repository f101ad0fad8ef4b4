#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's paths on one GPU.

Run from the repository root with no arguments:

    python3 scripts/torch_profile_paths.py

It drives the four paths of chip_smoke.py with their configurations: ORB,
learned and learned with the unfused GNN on the 960x600 corridor clip, and
the lowres gate on 24 corridor frames at 224x160; then the 962-pair workload
of ``forest_slam_tpu_torch.bench`` (learned and ORB) and one seed of its
wb_k10 gate (octaves 1.0, 0.707, 0.5, refine radius 24 at four scales,
P3P, 15 pairs in one batch), three times each after a
warm-up run: once plain for the wall time, once with every phase
synchronised and timed on the host clock (per-frame features and depth,
per-pair matching and PnP, chaining), and, after both paths have run so,
once under ``torch.profiler`` (device time by kernel name: the top 15 and
the Sinkhorn, detection, refine, select and sparse-cost kernels wherever
they rank; and the device's busy and idle share of the run's wall time).
It prints a line per finding and, as its last line, one JSON object with
the numbers; it fails without a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the clip and the configurations)
from forest_slam_tpu_torch.pipelines import stereo  # noqa: E402


def timed_phases(run):
    """Run with frame_features, pair_from_slab and chain_and_map synchronised
    and timed: (seconds per phase, wall seconds)."""
    spent = defaultdict(float)
    originals = {n: getattr(stereo, n) for n in ("frame_features", "pair_from_slab", "chain_and_map")}

    def wrap(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.time() - t
            return out
        return inner

    for n, fn in originals.items():
        setattr(stereo, n, wrap(n, fn))
    try:
        torch.cuda.synchronize()
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        for n, fn in originals.items():
            setattr(stereo, n, fn)
    return dict(spent), wall


# kernels whose device time each path reports whatever their rank
WATCHED = ("sinkhorn", "detect", "refine", "select_kernel", "sparse_cost")


def profiled(run, top: int = 15):
    """Device kernels of one run under torch.profiler: (busy seconds as the
    union of kernel intervals, wall seconds, [(name, seconds, count)] of the
    top kernels and of those whose name holds a WATCHED word)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t
    spans, by_name, counts = [], defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
            counts[e.name] += 1
    busy, end = 0.0, None
    for s, f in sorted(spans):
        if end is None or s > end:
            busy += f - s
            end = f
        elif f > end:
            busy += f - end
            end = f
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    ranked = ranked[:top] + [kv for kv in ranked[top:] if any(w in kv[0] for w in WATCHED)]
    return busy / 1e6, wall, [(n, t, counts[n]) for n, t in ranked]


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: this profile needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(f"device: {smi}", flush=True)

    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend

    il, ir, _, rig = cs.render_clip(dev)
    ts = torch.arange(cs.N_FRAMES).double().numpy() * 0.1
    orb_cfg = stereo.StereoConfig(orb=OrbConfig(n_features=cs.ORB_FEATURES, n_levels=cs.ORB_LEVELS),
                                  max_match_distance=64, n_hypotheses=1024, compose_mode="odometry",
                                  match_refine_radius=0)
    sp_cfg = stereo.StereoConfig(n_hypotheses=1024, compose_mode="odometry", match_refine_radius=12)
    gl, gr, _, rig_g = cs.render_frames(dev, cs.LOWRES_H, cs.LOWRES_W, cs.LOWRES_FRAMES)
    low_cfg = stereo.StereoConfig(n_hypotheses=cs.LOWRES_K, compose_mode="odometry", match_refine_radius=12)

    def learned(images, stereo_rig, cfg, batch, shape, k, **load):
        front = learned_frontend(load_learned_frontend(FLAGSHIP_PATH, shape, k, device=dev, **load))

        def run():
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            return stereo.run_stereo_vo_device(*images, stereo_rig, cfg, g, front, batch, batch)
        return run

    paths = {
        "orb": lambda: stereo.run_stereo_vo(il, ir, ts, rig, orb_cfg, seed=0, frame_batch=cs.FRAME_BATCH,
                                            pair_batch=cs.PAIR_BATCH),
        "learned": learned((il, ir), rig, sp_cfg, cs.FRAME_BATCH, (cs.H, cs.W), cs.K),
        "unfused": learned((il, ir), rig, sp_cfg, cs.FRAME_BATCH, (cs.H, cs.W), cs.K,
                           superglue_overrides={"gnn_impl": "xla"}),
        "lowres": learned((gl, gr), rig_g, low_cfg, cs.LOWRES_FRAMES, (cs.LOWRES_H, cs.LOWRES_W), cs.LOWRES_K,
                          scales=cs.LOWRES_SCALES),
    }
    pairs = {"orb": cs.N_FRAMES - 1, "learned": cs.N_FRAMES - 1, "unfused": cs.N_FRAMES - 1,
             "lowres": cs.LOWRES_FRAMES - 1}

    from forest_slam_tpu_torch import bench
    from forest_slam_tpu_torch.io.synthetic import default_rig

    for kind in ("sp", "orb"):
        wl = bench.prepare_workload(kind, dev)
        name = "bench_learned" if kind == "sp" else "bench_orb"
        paths[name], pairs[name] = wl.run, wl.truth.shape[0] - 1
    gate = next(g for g in bench.GATES if g.tag == "wb_k10")
    wl_, wr_, _ = bench.gate_clip(gate, dev, {})
    wb_cfg = bench.main_config("sp")._replace(match_refine_radius=24, match_refine_scales=bench.WB_REFINE_SCALES,
                                              pnp_minimal="p3p")
    wb_fe = load_learned_frontend(FLAGSHIP_PATH, (cs.H, cs.W), cs.K, device=dev, scales=bench.WB_SCALES)
    wb_rig = default_rig(cs.H, cs.W, baseline=bench.BASELINE, device=dev)
    paths["gate_wb_k10"] = lambda: bench.run_vo_gate_seed(wl_, wr_, wb_rig, wb_cfg, wb_fe, 0)
    pairs["gate_wb_k10"] = gate.n_frames - 1
    result = {"device": smi, "pairs": pairs, "paths": {}}
    for name, run in paths.items():
        run()  # warm-up
        torch.cuda.synchronize()
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t
        phases, wall_phased = timed_phases(run)
        print(f"{name}: {wall:.4f} s for {pairs[name]} pairs; synchronised phases "
              + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items()) + f" (of {wall_phased:.4f} s)", flush=True)
        result["paths"][name] = dict(wall_s=wall, phases_s=phases, phased_wall_s=wall_phased)
    # profiles last: launches stay slower once the profiler has run
    for name, run in paths.items():
        busy, wall_prof, top = profiled(run)
        print(f"{name}: under the profiler {wall_prof:.4f} s, device busy {busy:.4f} s "
              f"({100 * busy / wall_prof:.1f}%), idle {100 * (1 - busy / wall_prof):.1f}%", flush=True)
        for k, secs, n in top:
            print(f"  {secs * 1e3:9.3f} ms  {n:5d}x  {k[:110]}", flush=True)
        result["paths"][name].update(profiled_wall_s=wall_prof, device_busy_s=busy,
                                     top_kernels=[dict(name=k, seconds=s, count=n) for k, s, n in top])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
