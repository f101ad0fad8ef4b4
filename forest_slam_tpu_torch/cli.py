"""Command line of the PyTorch/CUDA port (port of cli.py).

    python -m forest_slam_tpu_torch.cli mono --synthetic 48 --out est.txt
    python -m forest_slam_tpu_torch.cli stereo --synthetic 48 --out est.txt --map-out map.ply --ba
    python -m forest_slam_tpu_torch.cli slam --synthetic 48 --out est.txt --compose-mode odometry --relocalize

``mono`` runs monocular VO (the reference's ``mono_slam.py``), ``stereo``
stereo VO and mapping (``stereo_slam.py``, optionally refined by
sliding-window BA) and ``slam`` stereo VO with loop closure, a pose graph,
optional BA and relocalization, over a synthetic sequence rendered on the
device at 224x160; each writes the TUM trajectory of frames 1..N-1. They
run on the card; ``--device cpu`` runs them on the CPU. Inputs from a bag
come with a later part of the port.
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
    "viewer_follow": "Queue A item 9 (the viewer)",
    "rectify": "Queue A item 9 (bag and dataset input: rectification acts on bag frames)",
}


def _add_common(p: argparse.ArgumentParser, stereo: bool = False) -> None:
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
    p.add_argument("--viewer-follow", action="store_true", help="(not in the port yet)")
    if stereo:
        p.add_argument("--map-out", default=None, help="PLY map output path")
        p.add_argument("--voxel", type=float, default=None, help="map voxel downsample size (m)")
        p.add_argument("--ba", action="store_true", help="refine with sliding-window bundle adjustment")
        p.add_argument("--ba-window", type=int, default=5)
        p.add_argument("--ba-iters", type=int, default=8)
        p.add_argument("--match-refine-radius", type=int, default=-1,
                       help="SAD refinement radius px after matching; -1 = 12 for the learned front end (24 at "
                            "--tier accuracy), 0 for ORB")
        p.add_argument("--wide-baseline", action="store_true",
                       help="large keyframe-interval preset: refine radius 24 at scales 1.0-1.7, P3P, learned "
                            "extraction at octaves 1.0, 0.707, 0.5")
        p.add_argument("--rectify", action="store_true", help="(not in the port yet)")


def _refuse_unported(args) -> str | None:
    for name, item in NOT_YET.items():
        if getattr(args, name, None) not in (None, False):
            return f"--{name.replace('_', '-')} is not in the PyTorch port yet: it comes with {item}"
    return None


def _device(args):
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available; pass --device cpu to run on the CPU")
    return device


def _apply_blur(args, images, stream: int = 0):
    """Random motion blur of the stack when asked (the reference's corruption
    knobs; off by default); ``stream`` 0 is the left camera, 1 the right,
    each with draws of its own."""
    if args.blur_percentage <= 0:
        return images
    import torch

    from forest_slam_tpu_torch.utils.corrupt import BlurConfig, corrupt_stack

    g = torch.Generator(device=images.device)
    g.manual_seed(args.seed + 777 + 1000 * stream)
    cfg = BlurConfig(blur_percentage=args.blur_percentage, kernel_size=args.blur_kernel, angle_deg=args.blur_angle)
    return corrupt_stack(images, g, cfg)


def _build_frontend(args, cfg, image_shape, device):
    import os

    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, WEIGHTS_DIR, load_learned_frontend

    if args.frontend == "orb":
        return orb_frontend(cfg.orb, cfg.max_match_distance)
    wide = getattr(args, "wide_baseline", False)
    accuracy = os.path.join(WEIGHTS_DIR, "learned_frontend.msgpack")
    path = args.weights or (accuracy if args.tier == "accuracy" and not wide and os.path.exists(accuracy)
                            else FLAGSHIP_PATH)
    return learned_frontend(load_learned_frontend(path, tuple(image_shape), device=device,
                                                  scales=(1.0, 0.707, 0.5) if wide else (1.0,)))


def _stereo_config(args):
    """The stereo configuration of ``stereo`` and ``slam`` on synthetic input
    (cli.py's: SGM over 48 disparities for the dense route), with the
    refine radius resolved (-1: 12 for the learned front end, 24 at the
    accuracy tier, 0 for ORB) and the wide-baseline preset."""
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig

    radius = args.match_refine_radius
    if radius < 0:
        radius = (24 if args.tier == "accuracy" else 12) if args.frontend == "sp" else 0
    cfg = StereoConfig(sgm=SgmConfig(num_disparities=48), compose_mode=args.compose_mode, match_refine_radius=radius)
    if args.wide_baseline:
        cfg = cfg._replace(match_refine_radius=max(radius, 24), match_refine_scales=(1.0, 1.2, 1.44, 1.7),
                           pnp_minimal="p3p")
    return cfg


def _stereo_inputs(args):
    """(device, sequence, left, right) of ``stereo`` and ``slam``, or an exit
    code when a flag is refused."""
    from forest_slam_tpu_torch.io.synthetic import render_sequence

    refused = _refuse_unported(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    device = _device(args)
    seq = render_sequence(args.synthetic, height=160, width=224, seed=args.seed, scene=args.scene, device=device)
    return device, seq, _apply_blur(args, seq.images_left, 0), _apply_blur(args, seq.images_right, 1)


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


def cmd_stereo(args) -> int:
    import numpy as np

    from forest_slam_tpu_torch.backend.mapping import accumulate_map
    from forest_slam_tpu_torch.backend.window import WindowBAConfig
    from forest_slam_tpu_torch.io.ply import write_ply
    from forest_slam_tpu_torch.io.tum import write_tum
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo

    inputs = _stereo_inputs(args)
    if isinstance(inputs, int):
        return inputs
    device, seq, il, ir = inputs
    cfg = _stereo_config(args)
    frontend = _build_frontend(args, cfg, il.shape[1:], device)
    ba = WindowBAConfig(window=args.ba_window, iters=args.ba_iters) if args.ba else None
    traj, outs = run_stereo_vo(il, ir, seq.timestamps, seq.rig, cfg, seed=args.seed, frontend=frontend, ba=ba,
                               device=device)
    write_tum(args.out, traj)
    if args.metrics_out:
        from forest_slam_tpu_torch.utils.metrics import write_metrics_jsonl

        write_metrics_jsonl(args.metrics_out, np.asarray(seq.timestamps)[1:], outs)
    ok = outs.ok.cpu().numpy()
    print(f"stereo: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size})")
    if args.map_out:
        cloud = accumulate_map(outs.map_points.cpu().numpy(), outs.map_valid.cpu().numpy(), args.voxel)
        write_ply(args.map_out, cloud)
        print(f"map: {cloud.shape[0]} points -> {args.map_out}")
    return 0


def cmd_slam(args) -> int:
    """Stereo VO, loop closure and the pose graph (optional BA and
    relocalization)."""
    from forest_slam_tpu_torch.backend.loop_closure import LoopClosureConfig
    from forest_slam_tpu_torch.backend.relocalize import RelocalizeConfig
    from forest_slam_tpu_torch.backend.window import WindowBAConfig
    from forest_slam_tpu_torch.io.tum import write_tum
    from forest_slam_tpu_torch.pipelines.slam import SlamConfig, run_slam

    if args.relocalize and args.compose_mode != "odometry":
        print("--relocalize needs --compose-mode odometry", file=sys.stderr)
        return 2
    inputs = _stereo_inputs(args)
    if isinstance(inputs, int):
        return inputs
    device, seq, il, ir = inputs
    cfg = SlamConfig(
        stereo=_stereo_config(args),
        loop=LoopClosureConfig(max_candidates=args.loop_candidates, min_separation=args.loop_separation),
        keyframe_stride=args.keyframe_stride,
        ba=WindowBAConfig(window=args.ba_window, iters=args.ba_iters) if args.ba else None,
        relocalize=RelocalizeConfig() if args.relocalize else None,
    )
    frontend = _build_frontend(args, cfg.stereo, il.shape[1:], device)
    traj, outs = run_slam(il, ir, seq.timestamps, seq.rig, cfg, seed=args.seed, frontend=frontend, device=device)
    write_tum(args.out, traj)
    ok = outs.vo.ok.cpu().numpy()
    reloc = f", relocalized {int(outs.n_relocalized)}" if args.relocalize else ""
    print(f"slam: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size}, loops {int(outs.n_loops)}"
          f"{reloc})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="forest_slam_tpu_torch.cli", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("mono", help="monocular VO -> TUM trajectory")
    _add_common(p)
    p.set_defaults(fn=cmd_mono)
    p = sub.add_parser("stereo", help="stereo VO + mapping")
    _add_common(p, stereo=True)
    p.set_defaults(fn=cmd_stereo)
    p = sub.add_parser("slam", help="full SLAM: VO + loop closure + pose graph")
    _add_common(p, stereo=True)
    p.add_argument("--keyframe-stride", type=int, default=5)
    p.add_argument("--loop-candidates", type=int, default=8)
    p.add_argument("--loop-separation", type=int, default=20)
    p.add_argument("--relocalize", action="store_true",
                   help="repair tracking losses by absolute relocalization against earlier frames (needs "
                        "--compose-mode odometry)")
    p.set_defaults(fn=cmd_slam)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
