"""Command line of the PyTorch/CUDA port (port of cli.py).

    python -m forest_slam_tpu_torch.cli mono --synthetic 48 --out est.txt

``mono`` runs monocular VO (the reference's ``mono_slam.py``) over a
synthetic sequence rendered on the device and writes the TUM trajectory of
frames 1..N-1. It runs on the card; ``--device cpu`` runs it on the CPU.
Inputs from a bag and the other commands come with later parts of the port.
"""

from __future__ import annotations

import argparse
import sys

# flags of the JAX package's common set that this port does not take yet,
# with the roadmap item that brings them
NOT_YET = {
    "bag": "Queue A item 9 (bag and dataset input)",
    "max_frames": "Queue A item 9 (bag and dataset input)",
    "frame_stride": "Queue A item 9 (bag and dataset input)",
    "viewer_out": "Queue A item 9 (the viewer)",
    "debug_matches": "Queue A item 9 (the match plots)",
}


def _add_common(p: argparse.ArgumentParser) -> None:
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bag", help="rosbag path (not in the port yet)")
    src.add_argument("--synthetic", type=int, metavar="N", help="render N synthetic frames at 224x160")
    p.add_argument("--scene", choices=["corridor", "forest"], default="corridor")
    p.add_argument("--out", required=True, help="output TUM trajectory path")
    p.add_argument("--frontend", choices=["orb", "sp"], default="orb")
    p.add_argument("--weights", default=None, help="learned-frontend checkpoint")
    p.add_argument("--tier", choices=["speed", "accuracy"], default="speed",
                   help="learned checkpoint when --weights is not given: the flagship (speed) or the stride-1 "
                        "training checkpoint (accuracy)")
    p.add_argument("--max-frames", type=int, default=None, help="(not in the port yet)")
    p.add_argument("--frame-stride", type=int, default=None, help="(not in the port yet)")
    p.add_argument("--compose-mode", choices=["parity", "odometry"], default="parity")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--blur-percentage", type=float, default=0.0)
    p.add_argument("--blur-kernel", type=int, default=15)
    p.add_argument("--blur-angle", type=float, default=0.0)
    p.add_argument("--metrics-out", default=None, help="write per-frame metrics as JSON lines")
    p.add_argument("--debug-matches", default=None, metavar="DIR", help="(not in the port yet)")
    p.add_argument("--viewer-out", default=None, metavar="HTML", help="(not in the port yet)")
    p.add_argument("--essential-minimal", choices=["auto", "8pt", "5pt"], default="auto",
                   help="essential minimal solver; auto = 5pt under --compose-mode parity, 8pt under odometry")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs on the CPU)")


def _refuse_unported(args) -> str | None:
    for name, item in NOT_YET.items():
        if getattr(args, name) is not None:
            return f"--{name.replace('_', '-')} is not in the PyTorch port yet: it comes with {item}"
    return None


def _device(args):
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available; pass --device cpu to run on the CPU")
    return device


def _apply_blur(args, images):
    """Random motion blur of the stack when asked (the reference's corruption
    knobs; off by default)."""
    if args.blur_percentage <= 0:
        return images
    import torch

    from forest_slam_tpu_torch.utils.corrupt import BlurConfig, corrupt_stack

    g = torch.Generator(device=images.device)
    g.manual_seed(args.seed + 777)
    cfg = BlurConfig(blur_percentage=args.blur_percentage, kernel_size=args.blur_kernel, angle_deg=args.blur_angle)
    return corrupt_stack(images, g, cfg)


def _build_frontend(args, cfg, image_shape, device):
    import os

    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, WEIGHTS_DIR, load_learned_frontend

    if args.frontend == "orb":
        return orb_frontend(cfg.orb, cfg.max_match_distance)
    accuracy = os.path.join(WEIGHTS_DIR, "learned_frontend.msgpack")
    path = args.weights or (accuracy if args.tier == "accuracy" and os.path.exists(accuracy) else FLAGSHIP_PATH)
    return learned_frontend(load_learned_frontend(path, tuple(image_shape), device=device))


def cmd_mono(args) -> int:
    import numpy as np

    from forest_slam_tpu_torch.io.synthetic import render_sequence
    from forest_slam_tpu_torch.io.tum import write_tum
    from forest_slam_tpu_torch.pipelines.mono import MonoConfig, run_mono_vo

    refused = _refuse_unported(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    device = _device(args)
    seq = render_sequence(args.synthetic, height=160, width=224, seed=args.seed, scene=args.scene, device=device)
    images = _apply_blur(args, seq.images_left)
    cfg = MonoConfig(compose_mode=args.compose_mode, minimal=args.essential_minimal)
    frontend = _build_frontend(args, cfg, images.shape[1:], device)
    traj, outs = run_mono_vo(images, seq.timestamps, seq.rig.left, cfg, seed=args.seed, frontend=frontend,
                             device=device)
    write_tum(args.out, traj)
    if args.metrics_out:
        from forest_slam_tpu_torch.utils.metrics import write_metrics_jsonl

        write_metrics_jsonl(args.metrics_out, np.asarray(seq.timestamps)[1:], outs)
    ok = outs.ok.cpu().numpy()
    print(f"mono: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="forest_slam_tpu_torch.cli", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("mono", help="monocular VO -> TUM trajectory")
    _add_common(p)
    p.set_defaults(fn=cmd_mono)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
