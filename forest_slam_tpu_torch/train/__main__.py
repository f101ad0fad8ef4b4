"""Train SuperPoint and SuperGlue jointly and write a checkpoint: the
``forest-slam train-frontend`` command of the JAX package (cli.py:574-627,
723-772), its flags and defaults, on a CUDA card (``--device cpu`` for the
CPU).

    python -m forest_slam_tpu_torch.train --steps 2000 --out weights/mine.msgpack
"""

from __future__ import annotations

import argparse
import os
import sys

from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
from forest_slam_tpu_torch.frontend.weights import WEIGHTS_DIR, params_to_jax, save_params
from forest_slam_tpu_torch.train.trainer import TrainConfig, checkpoint_meta, load_train_state, train

DEFAULT_OUT = os.path.join(WEIGHTS_DIR, "learned_frontend.msgpack")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m forest_slam_tpu_torch.train", description=__doc__.split("\n\n")[0])
    add_arguments(p)
    return p


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The flags of ``train-frontend`` (here and in cli.py)."""
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--out", default=None, help=f"output .msgpack (default {os.path.relpath(DEFAULT_OUT)})")
    p.add_argument("--texture-fraction", type=float, default=0.4)
    p.add_argument("--corridor-fraction", type=float, default=0.3,
                   help="share of 3D-supervised corridor pairs")
    p.add_argument("--stem-stride", type=int, default=2, choices=(1, 2, 4, 8), help="SuperPoint space-to-depth stem")
    p.add_argument("--corridor-pool", type=int, default=4096, help="pre-rendered corridor-pair pool size")
    p.add_argument("--corridor-scene", default="corridor", choices=["corridor", "forest", "mix"],
                   help="world(s) of the 3D-supervised pool")
    p.add_argument("--forest-share", type=float, default=0.5, help="forest fraction of a 'mix' pool")
    p.add_argument("--corridor-min-forward", type=float, default=0.15, help="min forward gap (m) of the 3D pairs")
    p.add_argument("--corridor-max-forward", type=float, default=3.0, help="max forward gap (m)")
    p.add_argument("--init-from", default=None,
                   help="warm-start from a checkpoint (optimizer reset; the architecture must match)")
    p.add_argument("--detector-soft", action="store_true",
                   help="bilinear sub-pixel detector targets; the checkpoint's meta then enables com3")
    p.add_argument("--w-zoom", type=float, default=0.0, help="zoomed-view descriptor loss weight")
    p.add_argument("--zoom-max", type=float, default=2.0, help="upper zoom ratio of the w-zoom term")
    p.add_argument("--blur-fraction", type=float, default=0.0,
                   help="share of training images blurred in random regions; 0 disables")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def config(args) -> TrainConfig:
    return TrainConfig(
        superpoint=SuperPointConfig(stem_stride=args.stem_stride), height=args.height, width=args.width,
        batch_size=args.batch, learning_rate=args.lr, texture_fraction=args.texture_fraction,
        corridor_fraction=args.corridor_fraction, corridor_pool_size=args.corridor_pool,
        corridor_scene=args.corridor_scene, forest_share=args.forest_share,
        corridor_min_forward=args.corridor_min_forward, corridor_max_forward=args.corridor_max_forward,
        detector_soft=args.detector_soft, w_zoom=args.w_zoom, zoom_max=args.zoom_max,
        blur_fraction=args.blur_fraction,
    )


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


def run(args) -> int:
    """Train by the parsed flags and write the checkpoint."""
    cfg = config(args)
    state = None
    if args.init_from:
        state = load_train_state(args.init_from, cfg, args.seed + 1, args.device)
        print(f"# warm-started from {args.init_from}", flush=True)
    state, history = train(cfg, args.steps, seed=args.seed, log_every=args.log_every, state=state,
                           device=args.device)
    for step, m in history:
        if (step + 1) % args.log_every and step + 1 != args.steps:
            continue
        print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    out = args.out or DEFAULT_OUT
    save_params(params_to_jax(state.frontend), out, meta=checkpoint_meta(cfg))
    print(f"saved weights -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
