#!/usr/bin/env python3
"""The CLI's stereo on a distorted BotanicGarden-shaped bag, the port's and
(with --jax) the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_bag_reference.py --unique 8 --jax
    python3 scripts/jax_bag_reference.py --unique 64 --frames 129

Renders ``chip_smoke.bag_scene`` (bench.py's corridor world at the
BotanicGarden rig, each view distorted by its camera's k1, k2; ``--unique``
poses ping-ponged to ``--frames``, default 2 x unique - 1) on the CPU,
writes it as a bag with ground truth, and runs ``stereo --bag --frontend
orb --compose-mode odometry`` without and with ``--rectify`` through the
port's CLI (``--device cpu``) and, with ``--jax``, the JAX package's. Then
the port's ``run_stereo_vo`` on the loaded frames with the rig's distortion
zeroed. Each run prints one JSON line: tracked pairs and the Sim(3) and
SE(3) ATE of ``eval`` against the bag's gt-traj. 960x600 on the CPU takes
a few seconds a pair; the JAX runs compile their graphs first.
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from forest_slam_tpu_torch.cli import main as port_cli  # noqa: E402
from forest_slam_tpu_torch.io import calib  # noqa: E402
from forest_slam_tpu_torch.io.dataset import load_stereo_from_bag  # noqa: E402
from forest_slam_tpu_torch.io.synthetic import write_stereo_bag  # noqa: E402
from forest_slam_tpu_torch.io.tum import write_tum  # noqa: E402
from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo  # noqa: E402


def quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def ate(est, gt):
    return {("sim3" if scale else "se3"): json.loads(quiet(port_cli, ["eval", "--est", est, "--gt", gt]
                                                           + ([] if scale else ["--no-scale"])))["ape"]["rmse"]
            for scale in (True, False)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unique", type=int, default=8)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--jax", action="store_true", help="also the JAX package's CLI")
    args = ap.parse_args()
    n = args.frames or 2 * args.unique - 1
    clis = [("port", port_cli, ["--device", "cpu"])]
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from forest_slam_tpu.cli import main as jax_cli

        clis.append(("jax", jax_cli, []))
    dev = torch.device("cpu")
    dl, dr, _, Ts, rig = chip_smoke.bag_scene(dev, args.unique, n)
    with tempfile.TemporaryDirectory() as tmp:
        bag, gt, est = (os.path.join(tmp, f) for f in ("b.bag", "gt.txt", "est.txt"))
        write_stereo_bag(bag, dl, dr, 1.6e9 + 0.1 * np.arange(n), Ts, calib.BOTANIC_T_RGB0_VLP16)
        quiet(port_cli, ["gt-traj", "--bag", bag, "--out", gt])
        for rectify in ([], ["--rectify"]):
            for side, cli, extra in clis:
                said = quiet(cli, ["stereo", "--bag", bag, "--frontend", "orb", "--compose-mode", "odometry", "--out",
                                   est] + rectify + extra)
                tracked = re.search(r"tracked (\d+/\d+)", said).group(1)
                print(json.dumps(dict(side=side, frames=n, unique=args.unique, rectify=bool(rectify),
                                      tracked=tracked, ate_m=ate(est, gt))), flush=True)
        seq = load_stereo_from_bag(bag, rig, device=dev)
        zero = torch.zeros(5)
        plain = rig._replace(left=rig.left._replace(dist=zero), right=rig.right._replace(dist=zero))
        traj, outs = run_stereo_vo(seq.images_left, seq.images_right, seq.timestamps, plain,
                                   StereoConfig(compose_mode="odometry"))
        write_tum(est, traj)
        print(json.dumps(dict(side="port", frames=n, unique=args.unique, rig="distortion zeroed",
                              tracked=f"{int(outs.ok.sum())}/{outs.ok.numel()}", ate_m=ate(est, gt))), flush=True)


if __name__ == "__main__":
    main()
