#!/usr/bin/env python3
"""Write the JAX package's bench worlds as numpy arrays, for the port.

    JAX_PLATFORMS=cpu python3 scripts/export_jax_worlds.py OUT.npz

bench.py renders its clips from ``make_corridor_world(PRNGKey(0))`` and,
for its forest gates (8 frames at 3 m and 16 at 1.5 m, trunks to 44 m),
``make_forest_world(PRNGKey(0), z_range=(-5, 44))``. This script makes both
with the JAX package on the CPU and saves their random content:
``corridor_textures`` (3, 1024, 1024), ``forest_textures`` (4, 1024, 1024),
``forest_trunks`` (150, 5) and ``forest_bark`` (1024, 1024), float32, so
``scripts/torch_gate_worlds.py`` can run the port's gates, where JAX is not
installed, on arrays JAX itself drew.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from forest_slam_tpu.io.synthetic import make_corridor_world, make_forest_world  # noqa: E402


def main(out: str) -> None:
    corridor = make_corridor_world(jax.random.PRNGKey(0))
    forest = make_forest_world(jax.random.PRNGKey(0), z_range=(-5.0, 44.0))
    np.savez(out, corridor_textures=np.asarray(corridor.textures, np.float32),
             forest_textures=np.asarray(forest.textures, np.float32),
             forest_trunks=np.asarray(forest.trunks, np.float32),
             forest_bark=np.asarray(forest.trunk_texture, np.float32))
    print(f"wrote {out} (jax {jax.__version__})")


if __name__ == "__main__":
    main(sys.argv[1])
