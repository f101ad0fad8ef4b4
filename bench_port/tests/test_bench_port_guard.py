"""Nothing of the benchmark imports the JAX stack, compared by whole
top-level names (the measured package's name begins with the JAX
package's), and the reference imports nothing of the measured package."""

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
