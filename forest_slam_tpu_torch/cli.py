"""Command line of the PyTorch/CUDA port (port of cli.py).

    python -m forest_slam_tpu_torch.cli stereo --bag seq.bag --out est.txt --map-out map.ply --viewer-out v.html
    python -m forest_slam_tpu_torch.cli gt-traj --bag seq.bag --out gt.txt
    python -m forest_slam_tpu_torch.cli eval --est est.txt --gt gt.txt

The reference's entry points as subcommands:

  mono             mono_slam.py        (VO -> TUM trajectory)
  stereo           stereo_slam.py      (VO + map -> TUM + PLY)
  slam             stereo VO + loop closure + pose graph
  gt-traj          gt_localisation.py  (ground-truth trajectory from a bag)
  gt-map           gt_mapping.py       (ground-truth lidar map from a bag)
  eval             evo's APE/RPE between TUM files
  plot             evo's plots (trajectory, APE, xyz, speed PNGs)
  view             the RViz surface    (interactive 3D viewer HTML)
  train-frontend   train SuperPoint + SuperGlue weights
  distill-frontend distil a trained SuperPoint into a faster stem

``mono``, ``stereo`` and ``slam`` read a ROS1 bag with the BotanicGarden
calibration (``--bag``; frames undistorted and turned gray on the device) or
render a synthetic sequence at 224x160 (``--synthetic N``); each writes the
TUM trajectory of frames 1..N-1. They, and the training commands, run on the
card; ``--device cpu`` runs them on the CPU. ``plot`` and ``--debug-matches``
need matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p: argparse.ArgumentParser, stereo: bool = False) -> None:
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bag", help="rosbag path (BotanicGarden calibration)")
    src.add_argument("--synthetic", type=int, metavar="N", help="render N synthetic frames at 224x160")
    p.add_argument("--scene", choices=["corridor", "forest"], default="corridor")
    p.add_argument("--out", required=True, help="output TUM trajectory path")
    p.add_argument("--frontend", choices=["orb", "sp"], default="orb")
    p.add_argument("--weights", default=None, help="learned-frontend checkpoint")
    p.add_argument("--tier", choices=["speed", "accuracy"], default="speed",
                   help="learned checkpoint when --weights is not given: the flagship (speed) or the stride-1 "
                        "training checkpoint (accuracy)")
    p.add_argument("--max-frames", type=int, default=None, help="read at most N frames of the bag")
    p.add_argument("--frame-stride", type=int, default=1, help="keep every K-th frame of the bag (keyframe interval)")
    p.add_argument("--compose-mode", choices=["parity", "odometry"], default="parity")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--blur-percentage", type=float, default=0.0)
    p.add_argument("--blur-kernel", type=int, default=15)
    p.add_argument("--blur-angle", type=float, default=0.0)
    p.add_argument("--metrics-out", default=None, help="write per-frame metrics as JSON lines")
    p.add_argument("--debug-matches", default=None, metavar="DIR",
                   help="write side-by-side keypoint/match PNGs of a sample of frame pairs (needs matplotlib)")
    p.add_argument("--viewer-out", default=None, metavar="HTML",
                   help="write an interactive 3D viewer of the trajectory (and the map, for stereo)")
    p.add_argument("--essential-minimal", choices=["auto", "8pt", "5pt"], default="auto",
                   help="essential minimal solver; auto = 5pt under --compose-mode parity, 8pt under odometry")
    p.add_argument("--viewer-follow", action="store_true",
                   help="stereo: run the streaming runner and rewrite --viewer-out after every chunk, with a "
                        "refresh header, so an open browser follows the run")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs on the CPU)")
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
        p.add_argument("--rectify", action="store_true",
                       help="bag input: stereo-rectify instead of the reference's unrectified behaviour")
        p.add_argument("--trace-out", default=None, metavar="JSON",
                       help="run under a device recording and write its spans (the port's layers, set-up and "
                            "SLAM stages) and the card's kernels as one Chrome trace, which Perfetto opens")


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


def _dump_match_debug(out_dir, images, frontend, refine_radius=0, max_pairs=8):
    """Match-debug PNGs of an even sample of consecutive pairs: the front end
    run as the pipeline runs it (extraction and matching, then the SAD
    refinement when the pipeline has it), drawn as keypoints in both frames,
    match lines and refinement arrows."""
    import numpy as np
    import torch

    from forest_slam_tpu_torch.eval.plots import plot_matches
    from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches

    os.makedirs(out_dir, exist_ok=True)
    n = images.shape[0] - 1
    shape = tuple(images.shape[1:])
    with torch.no_grad():
        for i in np.unique(np.linspace(0, n - 1, min(max_pairs, n)).astype(int)):
            pair = images[i:i + 2]
            f = frontend.extract(pair)
            f0, f1 = (type(f)(*(a[j:j + 1] for a in f)) for j in (0, 1))
            m = frontend.match(f0, f1, shape)
            refined = None
            if refine_radius > 0:
                xy1 = f1.xy.gather(1, m.clamp(min=0).long()[..., None].expand(-1, -1, 2))
                refined, _ = refine_matches(pair[:1], pair[1:], f0.xy, xy1, m >= 0, RefineConfig(radius=refine_radius))
                refined = refined[0].cpu()
            stats = plot_matches(os.path.join(out_dir, f"matches_{i:05d}.png"), pair[0].cpu().numpy(),
                                 pair[1].cpu().numpy(), f0.xy[0].cpu(), f1.xy[0].cpu(), matches0=m[0].cpu(),
                                 valid0=f0.valid[0].cpu(), valid1=f1.valid[0].cpu(), xy1_refined=refined,
                                 title=f"{frontend.name} pair {i}->{i + 1}")
            print(f"debug-matches: pair {i}: {stats['n_matches']} matches")


def _stereo_config(args):
    """The stereo configuration of ``stereo`` and ``slam``: SGM over 48
    disparities for synthetic input, the default SGM for a bag (cli.py's
    two), the refine radius resolved (-1: 12 for the learned front end, 24
    at the accuracy tier, 0 for ORB), and the wide-baseline preset."""
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig

    radius = args.match_refine_radius
    if radius < 0:
        radius = (24 if args.tier == "accuracy" else 12) if args.frontend == "sp" else 0
    cfg = StereoConfig(compose_mode=args.compose_mode, match_refine_radius=radius)
    if args.synthetic:
        cfg = cfg._replace(sgm=SgmConfig(num_disparities=48))
    if args.wide_baseline:
        cfg = cfg._replace(match_refine_radius=max(radius, 24), match_refine_scales=(1.0, 1.2, 1.44, 1.7),
                           pnp_minimal="p3p")
    return cfg


def _stereo_inputs(args, device):
    """(left, right, timestamps, rig) of ``stereo`` and ``slam``: a synthetic
    sequence, or a bag with the BotanicGarden rig (rectified on
    ``--rectify``), blurred when asked."""
    if args.synthetic:
        from forest_slam_tpu_torch.io.synthetic import render_sequence

        seq = render_sequence(args.synthetic, height=160, width=224, seed=args.seed, scene=args.scene, device=device)
        il, ir, ts, rig = seq.images_left, seq.images_right, seq.timestamps, seq.rig
    else:
        from forest_slam_tpu_torch.io import calib
        from forest_slam_tpu_torch.io.dataset import load_stereo_from_bag

        rig = calib.botanic_garden_rig(device)
        seq = load_stereo_from_bag(args.bag, rig, max_frames=args.max_frames, frame_stride=args.frame_stride,
                                   device=device)
        il, ir, ts = seq.images_left, seq.images_right, seq.timestamps
        print(f"bag: {il.shape[0]} stereo pairs at {il.shape[2]}x{il.shape[1]} ({seq.reader} reader)")
        if args.rectify:
            from forest_slam_tpu_torch.stereo.rectify import rectify_images, stereo_rectify

            rect = stereo_rectify(rig)
            il, ir = rectify_images(rect, il, ir)
            rig = rect.rig
    return _apply_blur(args, il, 0), _apply_blur(args, ir, 1), ts, rig


def cmd_mono(args) -> int:
    import numpy as np

    from forest_slam_tpu_torch.io.tum import write_tum
    from forest_slam_tpu_torch.pipelines.mono import MonoConfig, run_mono_vo

    device = _device(args)
    if args.synthetic:
        from forest_slam_tpu_torch.io.synthetic import render_sequence

        seq = render_sequence(args.synthetic, height=160, width=224, seed=args.seed, scene=args.scene, device=device)
        images, timestamps, cam = seq.images_left, seq.timestamps, seq.rig.left
    else:
        from forest_slam_tpu_torch.io import calib
        from forest_slam_tpu_torch.io.dataset import load_mono_from_bag

        cam = calib.botanic_garden_left(device)
        seq = load_mono_from_bag(args.bag, cam, max_frames=args.max_frames, frame_stride=args.frame_stride,
                                 device=device)
        images, timestamps = seq.images, seq.timestamps
        print(f"bag: {images.shape[0]} frames at {images.shape[2]}x{images.shape[1]} ({seq.reader} reader)")
    images = _apply_blur(args, images)
    cfg = MonoConfig(compose_mode=args.compose_mode, minimal=args.essential_minimal)
    frontend = _build_frontend(args, cfg, images.shape[1:], device)
    traj, outs = run_mono_vo(images, timestamps, cam, cfg, seed=args.seed, frontend=frontend, device=device)
    write_tum(args.out, traj)
    if args.metrics_out:
        from forest_slam_tpu_torch.utils.metrics import write_metrics_jsonl

        write_metrics_jsonl(args.metrics_out, np.asarray(timestamps)[1:], outs)
    ok = outs.ok.cpu().numpy()
    print(f"mono: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size})")
    if args.viewer_out:
        from forest_slam_tpu_torch.eval.viewer import write_viewer_html

        write_viewer_html(args.viewer_out, {"estimate": traj})
        print(f"viewer -> {args.viewer_out}")
    if args.debug_matches:
        _dump_match_debug(args.debug_matches, images, frontend)
    return 0


def cmd_stereo(args) -> int:
    import numpy as np

    from forest_slam_tpu_torch.backend.mapping import accumulate_map
    from forest_slam_tpu_torch.backend.window import WindowBAConfig
    from forest_slam_tpu_torch.io.ply import write_ply
    from forest_slam_tpu_torch.io.tum import write_tum
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo, run_stereo_vo_streaming

    device = _device(args)
    il, ir, ts, rig = _stereo_inputs(args, device)
    cfg = _stereo_config(args)
    frontend = _build_frontend(args, cfg, il.shape[1:], device)
    ba = WindowBAConfig(window=args.ba_window, iters=args.ba_iters) if args.ba else None
    if args.viewer_follow and args.viewer_out and ba is None:
        from forest_slam_tpu_torch.eval.viewer import write_viewer_html

        def on_chunk(ts_part, poses_part):
            write_viewer_html(args.viewer_out, {"estimate": poses_part}, title="forest-slam (live)",
                              refresh_seconds=2.0)

        traj, outs = run_stereo_vo_streaming(il, ir, ts, rig, cfg, args.out, seed=args.seed, frontend=frontend,
                                             on_chunk=on_chunk, device=device)
    else:
        traj, outs = run_stereo_vo(il, ir, ts, rig, cfg, seed=args.seed, frontend=frontend, ba=ba, device=device)
    write_tum(args.out, traj)
    if args.metrics_out:
        from forest_slam_tpu_torch.utils.metrics import write_metrics_jsonl

        write_metrics_jsonl(args.metrics_out, np.asarray(ts)[1:], outs)
    ok = outs.ok.cpu().numpy()
    print(f"stereo: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size})")
    cloud = None
    if args.map_out or args.viewer_out:
        cloud = accumulate_map(outs.map_points.cpu().numpy(), outs.map_valid.cpu().numpy(), args.voxel)
    if args.map_out:
        write_ply(args.map_out, cloud)
        print(f"map: {cloud.shape[0]} points -> {args.map_out}")
    if args.viewer_out:
        from forest_slam_tpu_torch.eval.viewer import write_viewer_html

        write_viewer_html(args.viewer_out, {"estimate": traj}, points=cloud)
        print(f"viewer -> {args.viewer_out}")
    if args.debug_matches:
        _dump_match_debug(args.debug_matches, il, frontend, refine_radius=cfg.match_refine_radius)
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
    device = _device(args)
    il, ir, ts, rig = _stereo_inputs(args, device)
    cfg = SlamConfig(
        stereo=_stereo_config(args),
        loop=LoopClosureConfig(max_candidates=args.loop_candidates, min_separation=args.loop_separation),
        keyframe_stride=args.keyframe_stride,
        ba=WindowBAConfig(window=args.ba_window, iters=args.ba_iters) if args.ba else None,
        relocalize=RelocalizeConfig() if args.relocalize else None,
    )
    frontend = _build_frontend(args, cfg.stereo, il.shape[1:], device)
    traj, outs = run_slam(il, ir, ts, rig, cfg, seed=args.seed, frontend=frontend, device=device)
    write_tum(args.out, traj)
    ok = outs.vo.ok.cpu().numpy()
    reloc = f", relocalized {int(outs.n_relocalized)}" if args.relocalize else ""
    print(f"slam: {len(traj)} poses -> {args.out} (tracked {int(ok.sum())}/{ok.size}, loops {int(outs.n_loops)}"
          f"{reloc})")
    if args.viewer_out:
        from forest_slam_tpu_torch.eval.viewer import write_viewer_html

        write_viewer_html(args.viewer_out, {"estimate": traj})
        print(f"viewer -> {args.viewer_out}")
    if args.debug_matches:
        _dump_match_debug(args.debug_matches, il, frontend, refine_radius=cfg.stereo.match_refine_radius)
    return 0


def cmd_gt_traj(args) -> int:
    from forest_slam_tpu_torch.eval.groundtruth import extract_gt_trajectory
    from forest_slam_tpu_torch.io.tum import write_tum

    traj = extract_gt_trajectory(args.bag)
    write_tum(args.out, traj)
    print(f"gt-traj: {len(traj)} poses -> {args.out}")
    return 0


def cmd_gt_map(args) -> int:
    from forest_slam_tpu_torch.eval.groundtruth import extract_gt_map
    from forest_slam_tpu_torch.io.ply import write_ply

    cloud = extract_gt_map(args.bag, scan_stride=args.scan_stride, voxel_size=args.voxel)
    write_ply(args.out, cloud)
    print(f"gt-map: {cloud.shape[0]} points -> {args.out}")
    return 0


def cmd_eval(args) -> int:
    from forest_slam_tpu_torch.eval.metrics import ape_translation, rpe_distance_ratio
    from forest_slam_tpu_torch.io.tum import read_tum

    est, gt = read_tum(args.est), read_tum(args.gt)
    out = {"ape": ape_translation(est, gt, with_scale=not args.no_scale)._asdict()}
    if args.rpe:
        out["rpe"] = rpe_distance_ratio(est, gt, delta_m=args.rpe_delta)._asdict()
    print(json.dumps(out, indent=2))
    return 0


def cmd_plot(args) -> int:
    from forest_slam_tpu_torch.eval.plots import plot_ape_colormap, plot_speeds, plot_trajectory_overlay, plot_xyz
    from forest_slam_tpu_torch.io.tum import read_tum

    est, gt = read_tum(args.est), read_tum(args.gt)
    os.makedirs(args.out_dir, exist_ok=True)
    ws = not args.no_scale
    pre = os.path.join(args.out_dir, args.prefix)
    plot_trajectory_overlay(pre + "traj.png", est, gt, with_scale=ws)
    stats = plot_ape_colormap(pre + "ape.png", est, gt, with_scale=ws)
    plot_xyz(pre + "xyz.png", est, gt, with_scale=ws)
    plot_speeds(pre + "speeds.png", {"estimate": est}, gt=gt)
    print(json.dumps(stats, indent=2))
    print(f"plots -> {pre}{{traj,ape,xyz,speeds}}.png")
    return 0


def cmd_view(args) -> int:
    """Interactive 3D viewer HTML of TUM trajectories and a PLY map (the
    offline counterpart of the reference's RViz surface)."""
    import numpy as np

    from forest_slam_tpu_torch.eval.viewer import write_viewer_html
    from forest_slam_tpu_torch.io.tum import read_tum

    trajs = {}
    for i, spec in enumerate(args.traj):
        name, _, path = spec.rpartition("=")
        if not name:
            name, path = f"estimate {i}" if i else "estimate", spec
        trajs[name] = read_tum(path)
    if args.gt:
        trajs["ground truth"] = read_tum(args.gt)
    points = colors = None
    if args.map:
        from forest_slam_tpu_torch.io.ply import read_ply

        points, colors = read_ply(args.map, with_colors=True)
        points = np.asarray(points, np.float32)
    write_viewer_html(args.out, trajs, points=points, point_colors=colors, max_points=args.max_points)
    print(f"viewer -> {args.out}")
    return 0


def cmd_train_frontend(args) -> int:
    from forest_slam_tpu_torch.train.__main__ import run

    return run(args)


def cmd_distill_frontend(args) -> int:
    from forest_slam_tpu_torch.train.distill import run

    return run(args)


def build_parser() -> argparse.ArgumentParser:
    from forest_slam_tpu_torch.train import __main__ as train_main
    from forest_slam_tpu_torch.train import distill

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

    p = sub.add_parser("gt-traj", help="ground-truth trajectory from a bag")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_gt_traj)
    p = sub.add_parser("gt-map", help="ground-truth lidar map from a bag")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--scan-stride", type=int, default=10)
    p.add_argument("--voxel", type=float, default=0.5)
    p.set_defaults(fn=cmd_gt_map)
    p = sub.add_parser("eval", help="APE/RPE between TUM files")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--no-scale", action="store_true", help="SE(3) alignment")
    p.add_argument("--rpe", action="store_true")
    p.add_argument("--rpe-delta", type=float, default=20.0)
    p.set_defaults(fn=cmd_eval)
    p = sub.add_parser("plot", help="trajectory/APE PNGs from TUM files (needs matplotlib)")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--prefix", default="")
    p.add_argument("--no-scale", action="store_true", help="SE(3) alignment")
    p.set_defaults(fn=cmd_plot)
    p = sub.add_parser("view", help="interactive 3D viewer HTML (the RViz surface)")
    p.add_argument("--traj", action="append", default=[], metavar="[NAME=]TUM",
                   help="TUM trajectory, repeatable; optional NAME= label")
    p.add_argument("--gt", help="ground-truth TUM trajectory")
    p.add_argument("--map", help="PLY map cloud")
    p.add_argument("--out", required=True, help="output .html")
    p.add_argument("--max-points", type=int, default=400_000)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("train-frontend", help="train SuperPoint+SuperGlue")
    train_main.add_arguments(p)
    p.set_defaults(fn=cmd_train_frontend)
    p = sub.add_parser("distill-frontend",
                       help="distil the trained stride-1 SuperPoint into a faster stem (keeps the teacher's SuperGlue)")
    distill.add_arguments(p)
    p.set_defaults(fn=cmd_distill_frontend)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "trace_out", None) is None:
        return args.fn(args)
    from forest_slam_tpu_torch.utils import trace

    with trace.recording(device=True) as tr:
        rc = args.fn(args)
    tr.write_chrome_trace(args.trace_out)
    print(f"trace: {len(tr.spans)} spans, {len(tr.device_events)} device events -> {args.trace_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
