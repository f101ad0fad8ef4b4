#!/usr/bin/env python3
"""Where a training or distillation step's time goes on the card.

    python3 scripts/torch_profile_train.py [--steps 20] [--pool 64] [--distill]

runs ``chip_smoke.py``'s training recipe (``chip_smoke.train_config()``:
stem 2, 9 layer pairs, 16 pairs of 120x160, 48 corners, texture 0.4,
corridor 0.3) from ``create_train_state`` on a corridor pool of ``--pool``
pairs rendered on the card, or with ``--distill`` its distillation recipe
(``chip_smoke.distill_config()``: the stem-2 teacher into a stem-4 student,
batch 8 of 240x320, every term on) on a pool of ``--pool`` 600x960 frames,
after 5 warm-up steps:

1. phases, each ended by ``torch.cuda.synchronize()``, over ``--steps``
   steps: batch drawing (``make_training_batch``; the crops, zoom and blur of
   ``train.distill.step_inputs``), the forward (``loss_fn``; the teacher's
   forward and ``distill_loss``), the backward, the AdamW step;
2. the same steps back to back (``train_step``, ``distill_step``; one
   synchronise at the end): steps/s;
3. ``--steps`` steps under ``torch.profiler``: the device's busy time (the
   union of kernel intervals) and its share of the profiled window and of
   the unprofiled steps of 2 (the profiler slows the host, not the card),
   the kernels by device time and the operators by host time.

The last line of its output is one JSON object with these numbers, the
card's name and its power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--distill", action="store_true", help="the distillation recipe in place of training")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from forest_slam_tpu_torch import _build
    from forest_slam_tpu_torch.train import distill as D
    from forest_slam_tpu_torch.train.data import make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state, loss_fn, train_step

    dev = torch.device("cuda", 0)
    _build.build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if args.distill:
        cfg = cs.distill_config()._replace(pool_frames=args.pool)
        teacher, _, _ = D.load_teacher(cfg, dev)
        state = D.create_student_state(cfg, seed=0, device=dev)
        host = torch.Generator()
        host.manual_seed(0)
        pool = D.make_scene_pool(gen, cfg, dev)
        draw = lambda: D.step_inputs(gen, host, cfg, pool)
        step = lambda st, inp: D.distill_step(st, teacher, inp[0], cfg, inp[1], inp[2])
        forward = lambda st, inp: D.distill_loss(st.student, D.teacher_outputs(teacher, inp[0]), inp[0], cfg, inp[1],
                                                 inp[2])
    else:
        cfg = cs.train_config()
        state = create_train_state(cfg, seed=0, device=dev)
        pool = make_corridor_pool(gen, args.pool, cfg.height, cfg.width, cfg.max_corners, device=dev)
        draw = lambda: make_training_batch(gen, cfg.batch_size, cfg.height, cfg.width, cfg.max_corners,
                                           cfg.texture_fraction, cfg.corridor_fraction, pool, dev)
        step = lambda st, batch: train_step(st, batch, cfg)
        forward = lambda st, batch: loss_fn(st.frontend, batch, cfg)
    for _ in range(5):
        state, _ = step(state, draw())
    torch.cuda.synchronize()

    phases = {"batch": 0.0, "forward": 0.0, "backward": 0.0, "adamw": 0.0}
    opt = state.optimizer

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] += time.perf_counter() - t
        return out

    for _ in range(args.steps):
        batch = timed("batch", draw)
        opt.zero_grad(set_to_none=True)
        total, _ = timed("forward", lambda: forward(state, batch))
        timed("backward", total.backward)
        timed("adamw", opt.step)
    per_step_phases = {k: v / args.steps * 1e3 for k, v in phases.items()}

    t = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, draw())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, draw())
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    # device events, less the profiler's own ranges on the device timeline
    # (the optimizer's step shows there as one annotation spanning its kernels)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer.")]
    busy = busy_seconds([(e.time_range.start, e.time_range.end) for e in events]) / 1e6
    by_kernel = {}
    for e in events:
        n, s = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, s + (e.time_range.end - e.time_range.start) / 1e3)
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    ops = [a for a in prof.key_averages() if a.key.startswith("aten::")]
    top_ops = sorted(ops, key=lambda a: -a.self_cpu_time_total)[:12]
    smi = cs.nvidia_smi_line()
    result = {
        "recipe": "distill" if args.distill else "train", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "steps": args.steps,
        "steps_per_s": args.steps / wall, "ms_per_step": wall / args.steps * 1e3,
        "phases_ms_per_step": per_step_phases,
        "profiled_ms_per_step": prof_wall / args.steps * 1e3,
        "device_busy_ms_per_step": busy / args.steps * 1e3, "device_busy_share": busy / prof_wall,
        # the profiler slows the host: the same device time over an unprofiled step
        "device_busy_share_of_unprofiled_step": busy / wall,
        "kernel_launches_per_step": len(events) / args.steps,
        "top_kernels_ms_per_step": [[k[:90], n / args.steps, s / args.steps] for k, (n, s) in top_kernels],
        "top_host_ops_ms_per_step": [[a.key, a.count / args.steps, a.self_cpu_time_total / 1e3 / args.steps]
                                     for a in top_ops],
    }
    print(f"{args.steps} steps: {result['steps_per_s']:.3f} steps/s ({result['ms_per_step']:.2f} ms a step) on "
          f"{result['device']} ({smi}); phases ms/step {per_step_phases}; device busy "
          f"{result['device_busy_ms_per_step']:.2f} ms/step ({100 * result['device_busy_share']:.1f}% of the profiled "
          f"window), {result['kernel_launches_per_step']:.0f} kernels a step", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
