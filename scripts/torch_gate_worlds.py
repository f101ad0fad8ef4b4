#!/usr/bin/env python3
"""The port's vo gates in other worlds than bench.py's, on one GPU.

    python3 scripts/torch_gate_worlds.py [--numpy-seeds 0,1,2] [--jax-worlds WORLDS.npz] [--gates fplain_k10,fwb_k20]

``forest_slam_tpu_torch.bench.run_gates`` renders bench.py's worlds (the
corridor and forest of ``jax.random.PRNGKey(0)``, drawn by
``utils/threefry.py``), where the gates' bounds were set. This script runs
the same gates (worst of seeds 0 and 1, bench.py's bounds) in:

- the port's numpy-seeded corridor and forest of each of ``--numpy-seeds``
  (other draws of the same worlds: how much a gate depends on its draw);
- the JAX package's worlds from the arrays ``scripts/export_jax_worlds.py``
  wrote with JAX itself, when ``--jax-worlds`` is given (a check of the
  threefry draws at full size: its gates equal run_gates' own).

It prints a line a gate and world, and as its last line one JSON object
{world: {gates, failures}} with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from forest_slam_tpu_torch import bench  # noqa: E402
from forest_slam_tpu_torch.io.synthetic import ForestArrays, make_corridor_world, make_forest_world  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--numpy-seeds", default="")
    ap.add_argument("--jax-worlds", default=None)
    ap.add_argument("--gates", default=None, help="comma-separated tags (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tags = None if args.gates is None else set(args.gates.split(","))
    worlds = {}
    for s in filter(None, args.numpy_seeds.split(",")):
        worlds[f"numpy seed {s}"] = {"corridor": make_corridor_world(int(s), device=dev),
                                     "forest": make_forest_world(int(s), z_range=(-5.0, 44.0), device=dev)}
    if args.jax_worlds:
        z = np.load(args.jax_worlds)
        forest = ForestArrays(z["forest_textures"], z["forest_trunks"], z["forest_bark"])
        worlds["exported from JAX"] = {"corridor": make_corridor_world(textures=z["corridor_textures"], device=dev),
                                       "forest": make_forest_world(arrays=forest, device=dev)}
    out = {"device": smi}
    for name, w in worlds.items():
        gates, failures, not_run = bench.run_gates(dev, gates_to_run=tags, lowres=False, worlds=w)
        for g in bench.GATES:
            if g.tag + "_ok" in gates:
                print(f"{name}: gate {g.tag}: {gates[g.tag + '_ok']}/{gates[g.tag + '_n']} tracked, ATE "
                      f"{gates[g.tag + '_ate']} m, seeds {gates[g.tag + '_seeds']} (bounds >= {g.min_ok}, "
                      f"<= {g.max_ate} m) on {smi}", flush=True)
        out[name] = {"gates": gates, "failures": failures, "not_run": not_run}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
