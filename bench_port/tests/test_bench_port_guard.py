"""Nothing of the benchmark imports the JAX stack, compared by whole
top-level names (the measured package's name begins with the JAX
package's), and the reference, with every front end's reference part,
imports nothing of the measured package."""

import json
import os
import subprocess
import sys

from bench_port import guard, manifest


def test_whole_name_comparison():
    assert guard.forbidden_modules(["forest_slam_tpu_torch", "forest_slam_tpu_torch.frontend", "jaxtyping"]) == []
    assert guard.forbidden_modules(["forest_slam_tpu.core", "jax", "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "forest_slam_tpu.core", "jax", "jaxlib.xla"]


def test_no_module_of_the_benchmark_imports_jax():
    assert guard.scan(manifest.HERE) == {}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(manifest.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            names = set(guard.imported_names(os.path.join(ref, name)))
            assert not names & {"forest_slam_tpu_torch", "forest_slam_tpu", "jax", "bench"}, name


def test_a_run_loads_no_jax():
    code = ("import sys; from bench_port import guard, manifest, run; from bench_port.tests.conftest import tiny; "
            "run.run_cell(tiny(manifest.load_cell('orb512.seq962_c128')), 1, 0.0, False, 'cpu'); "
            "print(guard.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


REFERENCE_PATHS = """
import glob, json, os, sys
from bench_port import guard, manifest, run, traffic
from bench_port.reference import pipeline
from bench_port.tests.conftest import tiny

with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
    cells = {}
    for w in json.load(f)["workloads"]:
        cell = tiny(manifest.load_cell(w["name"]))
        cells.setdefault(cell.config["frontend"], cell)
names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(manifest.HERE, "frontends", "*.py")))
assert sorted(cells) == names, (sorted(cells), names)
for name, cell in cells.items():
    fe, cfg, tr = cell.frontend, cell.config, cell.traffic
    inputs = traffic.make_inputs(tr, cfg, 1, "cpu", fe)
    inputs["weights"] = fe.weights(cfg, cell.root, 1, "cpu")
    ref = pipeline.run(run._reference_inputs(inputs, cell.root), cfg, fe, pnp_batch=tr["pair_chunk"])
    K = ref["frames"]["valid"].shape[1]
    assert fe.keypoints(cfg) == K and fe.slot_groups(cfg, K).shape == (K,)
    assert fe.desc_gap(ref["frames"]["desc"], ref["frames"]["desc"]) == 0.0
    assert len(fe.costs(tr["height"], tr["width"], cfg)) == 5
print(json.dumps(sorted(cells)))
print(json.dumps(sorted(n for n in sys.modules if guard.top_level(n) in ("forest_slam_tpu_torch",) + guard.FORBIDDEN)))
"""


def test_every_front_ends_reference_path_loads_nothing_of_the_program():
    """Each frontends/*.py, through a cell that names it: the reference's
    load, extract and match, the keypoint budget, weights, slot groups,
    descriptor gap and costs, in a process that then holds no module of
    the measured package or the JAX stack."""
    p = subprocess.run([sys.executable, "-c", REFERENCE_PATHS], cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    *_, ran, loaded = p.stdout.strip().splitlines()
    assert set(json.loads(ran)) >= {"orb", "superpoint_superglue"}
    assert json.loads(loaded) == []
