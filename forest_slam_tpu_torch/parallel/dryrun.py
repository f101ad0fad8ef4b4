"""Multi-device dry run (port of the JAX package's ``dryrun_multichip``):

    python -m forest_slam_tpu_torch.parallel.dryrun N [--device cpu]

On ``make_mesh(N)`` it takes one data- and tensor-parallel training step
at a tiny size (finite loss, step 1), then evaluates 2 x data distinct
tiny sequences (seed and speed vary by sequence, so a mix-up across ranks
would show) through ``run_batched_eval``, and holds each sequence's ATE to
a one-rank run's (``make_mesh(1)``, in this process) within 1e-6. With
``--device cpu`` it spawns N gloo ranks; on the card it runs one nccl rank
per card, so N must not exceed the cards visible (N = 1 runs in this
process). Exits 0 when every check holds.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from forest_slam_tpu_torch.parallel import launch
from forest_slam_tpu_torch.parallel.mesh import make_mesh, mesh_device

FRAMES, HEIGHT, WIDTH = 6, 64, 96
MAX_DATE = 1e-6


def train_config(batch_size: int):
    from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
    from forest_slam_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(superpoint=SuperPointConfig(max_keypoints=64),
                       superglue=SuperGlueConfig(gnn_layers=2, sinkhorn_iterations=5), height=64, width=80,
                       batch_size=batch_size, max_corners=16)


def stereo_config():
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig

    return StereoConfig(orb=OrbConfig(n_features=128, n_levels=3), sgm=SgmConfig(num_disparities=32),
                        n_hypotheses=128, compose_mode="odometry")


def sequences(n_seq: int, device):
    """(left, right, truth, rig) of ``n_seq`` distinct sequences: (S, N, H, W)
    stacks on the CPU, sequence s rendered from seed s at speed 0.10 + 0.03 s."""
    from forest_slam_tpu_torch.io.synthetic import render_sequence

    seqs = [render_sequence(FRAMES, height=HEIGHT, width=WIDTH, seed=s, speed=0.10 + 0.03 * s, device=device)
            for s in range(n_seq)]
    stack = lambda f: torch.stack([f(q).cpu() for q in seqs])
    return (stack(lambda q: q.images_left), stack(lambda q: q.images_right), stack(lambda q: q.T_world_cam),
            seqs[0].rig)


def batch_eval(mesh, n_seq: int):
    from forest_slam_tpu_torch.pipelines.batch_eval import run_batched_eval

    il, ir, gt, rig = sequences(n_seq, mesh_device(mesh))
    results, _ = run_batched_eval(il, ir, gt, rig, stereo_config(), mesh, frame_batch=6, pair_batch=5)
    return [r.ate_rmse for r in results], [r.ok_fraction for r in results]


def rank_main(n: int, device: str) -> dict:
    """Both halves on this rank of an n-rank mesh."""
    from forest_slam_tpu_torch.train.data import make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state, make_sharded_train_step

    mesh = make_mesh(n, device)
    dev = mesh_device(mesh)
    data, model = mesh.size(0), mesh.size(1)
    cfg = train_config(2 * data)
    state = create_train_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = make_training_batch(gen, cfg.batch_size, cfg.height, cfg.width, cfg.max_corners, device=dev)
    t0 = time.time()
    step, sharded = make_sharded_train_step(mesh, state, cfg)
    sharded, metrics = step(sharded, batch)
    t_train = time.time() - t0
    t0 = time.time()
    ates, oks = batch_eval(mesh, 2 * data)
    return dict(data=data, model=model, batch=cfg.batch_size, loss=float(metrics["loss"]), step=sharded.step,
                ates=ates, oks=oks, train_s=t_train, eval_s=time.time() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (devices) of the mesh")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one nccl rank per card; cpu: gloo ranks")
    args = ap.parse_args(argv)
    t0 = time.time()
    if args.n == 1:
        out = rank_main(1, args.device)
    else:
        out = launch.run(rank_main, args.n, args.device, args.n, args.device)
    mesh = {"data": out["data"], "model": out["model"]}
    failures = []
    if not np.isfinite(out["loss"]) or out["step"] != 1:
        failures.append(f"training: loss {out['loss']}, step {out['step']}")
    print(f"dryrun ok: mesh={mesh} batch={out['batch']} loss={out['loss']:.4f} step={out['step']} "
          f"({out['train_s']:.2f} s) (train {'ok' if not failures else 'FAILED'})", flush=True)
    ates = out["ates"]
    distinct = len({round(a, 6) for a in ates})
    if not all(np.isfinite(ates)):
        failures.append(f"non-finite ATE: {ates}")
    print(f"dryrun: batch-eval {len(ates)} distinct sequences sharded over data={mesh['data']}, ATEs "
          f"{[round(a, 4) for a in ates]} ({distinct} distinct), tracked {out['oks']} ({out['eval_s']:.2f} s)",
          flush=True)
    ates1, _ = batch_eval(make_mesh(1, args.device), len(ates))
    worst = max(abs(a - b) for a, b in zip(ates, ates1))
    if not worst < MAX_DATE:
        failures.append(f"sharded ATEs diverge from the one-rank run: {ates} vs {ates1}")
    print(f"dryrun: sharded == one rank per sequence (max |dATE| {worst:.2e}, bound {MAX_DATE})", flush=True)
    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(f"dryrun ok: {args.n} {args.device} rank(s) in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
