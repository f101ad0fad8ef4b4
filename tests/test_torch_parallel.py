"""The port's mesh and sharding rules (forest_slam_tpu_torch.parallel)
against parallel/mesh.py, and its multi-device dry run, on gloo ranks on the
CPU (one process per rank, started by parallel.launch):

- ``mesh_shape(n)`` is JAX ``make_mesh(n).shape`` for n = 1..8 (the
  conftest's 8 virtual devices), and rank r of a (data, model) mesh sits
  where JAX puts device r, at (r // model, r % model);
- ``param_shardings`` on tests/test_training.py's TINY configuration shards
  exactly the leaves JAX's puts on 'model', for model 2 and 4, matched
  through frontend/weights.py's name mapping, each on the torch dim that
  holds the Flax kernel's last (output-feature) dim: the last for the
  GNN's Dense kernels, dim 0 for nn.Linear and nn.Conv2d weights;
- ``make_mesh`` raises for 'cuda' without a card, and in one process with
  no default group starts a one-rank gloo group and refuses more ranks;
- ``python -m forest_slam_tpu_torch.parallel.dryrun 8 --device cpu`` (the
  (2, 4) mesh: one sharded step, four sequences over two data ranks,
  equal per sequence to a one-rank run) exits 0, and without
  ``--device cpu`` it refuses to run where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from forest_slam_tpu.parallel import make_mesh as jmake_mesh
from forest_slam_tpu.parallel import param_shardings as jparam_shardings
from forest_slam_tpu.train import trainer as JT
from forest_slam_tpu_torch.frontend.weights import params_to_jax
from forest_slam_tpu_torch.parallel import launch, make_mesh, mesh_shape
from forest_slam_tpu_torch.train import trainer as TT
from _torch_train_parity import jax_tiny, torch_tiny
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture(scope="module")
def ranks():
    return launch.run(_torch_ranks.placements, 8, "cpu", torch_tiny())


def test_mesh_shape_matches_jax():
    assert len(jax.devices()) == 8
    for n in range(1, 9):
        want = jmake_mesh(n).shape
        assert mesh_shape(n) == (want["data"], want["model"]), n


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_mesh_layout_and_placements(ranks, shape):
    out = ranks[shape]
    data, model = shape
    assert sorted(out["layout"]) == [(r, r // model, r % model) for r in range(8)]
    assert out["replicated"] == "Replicate()"
    assert out["batch_type"] == "TrainingBatch" and set(out["batch"]) == {"Shard(dim=0)"}


def _flax_paths(fe):
    """Torch parameter name -> (Flax path, how a torch index maps into the
    Flax leaf): each parameter filled with its own distinct values, carried
    through params_to_jax, then found again."""
    with torch.no_grad():
        for p in fe.parameters():
            p.copy_(torch.arange(p.numel(), dtype=torch.float32).reshape(p.shape))
    leaves = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params_to_jax(fe))}
    out = {}
    for name, p in fe.named_parameters():
        hits = [k for k, v in leaves.items() if v.size == p.numel() and v.shape[-1:] and
                np.array_equal(np.sort(v.ravel()), np.arange(p.numel()))]
        out[name] = hits
    return out, leaves


@pytest.fixture(scope="module")
def jax_params():
    """JAX's TINY parameter tree as shapes (the rule reads nothing else)."""
    return jax.eval_shape(lambda k: JT.create_train_state(k, jax_tiny()).params, jax.random.PRNGKey(0))


@pytest.mark.parametrize("model", [2, 4])
def test_param_shardings_match_jax(ranks, jax_params, model):
    port = ranks[(8 // model, model)]["params"]
    cfg, params = torch_tiny(), jax_params
    jsh = {jax.tree_util.keystr(k): not s.is_fully_replicated
           for k, s in jax.tree_util.tree_leaves_with_path(jparam_shardings(params, jmake_mesh(model)))}
    fe = TT.create_train_state(cfg, 0, "cpu").frontend
    shapes = {n: tuple(p.shape) for n, p in fe.named_parameters()}
    paths, leaves = _flax_paths(fe)
    assert set(port) == set(shapes)
    sharded_flax = set()
    conv_or_linear = 0
    for name, placement in port.items():
        if placement == "Replicate()":
            continue
        dim = int(placement.split("dim=")[1].rstrip(")"))
        # the Flax leaf whose last-axis slices are this parameter's slices on ``dim``
        match = []
        for path in paths[name]:
            flax = leaves[path]
            torch_chunks = torch.arange(int(np.prod(shapes[name])), dtype=torch.float32).reshape(shapes[name]).chunk(
                model, dim)
            flax_chunks = np.split(flax, model, axis=-1)
            if all(np.array_equal(np.sort(t.numpy().ravel()), np.sort(f.ravel()))
                   for t, f in zip(torch_chunks, flax_chunks)):
                match.append(path)
        assert len(match) >= 1, name
        sharded_flax.update(match)
        conv_or_linear += dim == 0
    want = {k for k, v in jsh.items() if v}
    assert sharded_flax == want
    assert len(want) == 41 and conv_or_linear > 10  # the convolutions and the keypoint encoder's Linear layers


def test_make_mesh_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, "cuda")


def test_make_mesh_in_one_process():
    code = """
import torch.distributed as dist
from forest_slam_tpu_torch.parallel import make_mesh
try:
    make_mesh(2, "cpu")
except ValueError as e:
    print("refused:", e)
m = make_mesh(device="cpu")
print(tuple(m.shape), m.mesh_dim_names, dist.get_backend(), dist.get_world_size())
try:
    make_mesh(1, "cuda")
except (RuntimeError, ValueError) as e:
    print("cuda refused")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("refused:") and "launch" in lines[0]
    assert lines[1] == "(1, 1) ('data', 'model') gloo 1"
    assert lines[2] == "cuda refused"


def test_dryrun_on_eight_gloo_ranks():
    out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.parallel.dryrun", "8", "--device", "cpu"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh={'data': 2, 'model': 4} batch=4" in out.stdout and "step=1" in out.stdout
    assert "4 distinct sequences sharded over data=2" in out.stdout and "(4 distinct)" in out.stdout
    assert "max |dATE| 0.00e+00" in out.stdout


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.parallel.dryrun", "1"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr and "dryrun ok" not in out.stdout
