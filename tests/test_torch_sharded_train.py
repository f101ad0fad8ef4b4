"""The port's sharded training step (train/trainer.py:make_sharded_train_step)
on gloo ranks on the CPU, one process per rank as on the card, at
tests/test_training.py's TINY configuration from JAX's initial parameters
(carried over by ``params_from_jax``):

- on the (2, 4) mesh of 8 ranks and the (1, 2) mesh of 2, batch 2, and on
  the (4, 2) mesh of 8 ranks with batch 4, so that the data axis is 4 and
  each rank holds one pair, one step against the port's unsharded
  ``train_step`` on the same batch and parameters, within
  tests/test_training.py's envelope for JAX's own sharded step: loss to
  rtol 2e-3, update norm to 5e-2, global gradient cosine above 0.9 and
  norm to 5e-2, per-leaf norms to 1e-1 over the leaves above 1e-3 of the
  global norm, more than 20 of them; a rank that divided by its own counts
  or summed ``model`` identical gradients would miss the norms;
- each rank holds 1/model of every sharded kernel and of both its AdamW
  moments, and nothing of the kernel in its module between steps;
- the (2, 4) step against JAX's make_sharded_train_step on the virtual
  (2, 4) mesh, within tests/_torch_train_parity.py's envelope for the
  unsharded step (metrics and gradients), with the update norm to 5e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.parallel import make_mesh as jmake_mesh
from forest_slam_tpu.train import trainer as JT
from forest_slam_tpu_torch.parallel import launch
from forest_slam_tpu_torch.train.data import make_training_batch
from _torch_train_parity import (_jax_metrics_and_grads, assert_within_envelope, grads_to_jax, jax_start, jax_tiny,
                                 port_frontend, torch_batch, torch_tiny)
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_ranks

CASES = {"2x4": ((2, 4), 2), "1x2": ((1, 2), 2), "4x2": ((4, 2), 4)}


@pytest.fixture(scope="module")
def start():
    tree, batch2 = jax_start()
    gen = torch.Generator()
    gen.manual_seed(4)
    batch4 = JT.TrainingBatch(*(t.numpy() for t in make_training_batch(gen, 4, 64, 80, 24, device="cpu")))
    return tree, {2: batch2, 4: batch4}


@pytest.fixture(scope="module")
def sharded(start):
    tree, batches = start
    return {name: launch.run(_torch_ranks.sharded_step, shape[0] * shape[1], "cpu", shape, tree, tuple(batches[b]),
                             torch_tiny()._replace(batch_size=b))
            for name, (shape, b) in CASES.items()}


def _unsharded(tree, batch, cfg):
    """The port's train_step on one process: metrics, gradients by name,
    parameters after the update."""
    from forest_slam_tpu_torch.train import trainer as TT

    fe = port_frontend(tree, cfg)
    state = TT.TrainState(frontend=fe, optimizer=TT.make_optimizer(fe.parameters(), cfg), step=0)
    total, m = TT.loss_fn(fe, torch_batch(batch), cfg)
    names, params = zip(*fe.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    g = {n: np.zeros(p.shape) if d is None else d.double().numpy() for n, p, d in zip(names, params, grads)}
    state, _ = TT.train_step(state, torch_batch(batch), cfg)
    return ({k: float(v.detach()) for k, v in m.items()}, g,
            {n: p.detach().double().numpy() for n, p in state.frontend.named_parameters()})


def _update_norm(new: dict, old: dict) -> float:
    return float(np.sqrt(sum(np.sum((new[k] - old[k]) ** 2) for k in old)))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_unsharded(start, sharded, case):
    tree, batches = start
    shape, b = CASES[case]
    cfg = torch_tiny()._replace(batch_size=b)
    out = sharded[case]
    assert out["mesh"] == shape and out["step"] == 1
    assert not out["foreign_modules"]  # the ranks ran without JAX
    ref_m, ref_g, ref_p = _unsharded(tree, batches[b], cfg)
    np.testing.assert_allclose(out["metrics"]["loss"], ref_m["loss"], rtol=2e-3)
    np.testing.assert_allclose(out["step_metrics"]["loss"], ref_m["loss"], rtol=2e-3)
    start_p = {n: p.detach().double().numpy() for n, p in port_frontend(tree, cfg).named_parameters()}
    n_ref, n_got = _update_norm(ref_p, start_p), _update_norm(out["params"], start_p)
    assert n_ref > 0
    np.testing.assert_allclose(n_got, n_ref, rtol=5e-2)
    r = np.concatenate([ref_g[k].ravel() for k in ref_g])
    g = np.concatenate([out["g_all"][k].ravel() for k in ref_g])
    norm = np.linalg.norm(r)
    assert float(r @ g) / (norm * np.linalg.norm(g)) > 0.9
    np.testing.assert_allclose(np.linalg.norm(g), norm, rtol=5e-2)
    checked = 0
    for k in ref_g:
        nr = np.linalg.norm(ref_g[k])
        if nr < 1e-3 * norm:
            continue
        checked += 1
        np.testing.assert_allclose(np.linalg.norm(out["g_all"][k]), nr, rtol=1e-1, err_msg=k)
    assert checked > 20


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_one_model_share(sharded, case):
    out = sharded[case]
    model = CASES[case][0][1]
    shards = {k for k, v in out["placements"].items() if v.startswith("Shard")}
    assert len(shards) > 10 if model > 1 else not shards
    full = out["params"]
    assert len(out["held"]) == CASES[case][0][0] * model
    for held in out["held"]:
        assert set(held) == shards
        for name, h in held.items():
            dim = int(out["placements"][name].split("dim=")[1].rstrip(")"))
            want = list(full[name].shape)
            want[dim] //= model
            assert h["shard"] == h["exp_avg"] == h["exp_avg_sq"] == tuple(want), (name, h)
            assert int(np.prod(h["module"])) == 0, name


def test_sharded_step_matches_jax_sharded_step(start, sharded):
    tree, batches = start
    batch = batches[2]
    out = sharded["2x4"]
    mesh = jmake_mesh(8)
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    jcfg, cfg = jax_tiny(), torch_tiny()
    jax_step = _jax_metrics_and_grads(tree, batch, jcfg, mesh=mesh)
    fe = port_frontend(tree, cfg)
    port_step = (out["metrics"], grads_to_jax(fe, out["g_all"]), grads_to_jax(fe, out["g_sp"]))
    assert_within_envelope(jax_step, port_step)

    state = JT.create_train_state(jax.random.PRNGKey(0), jcfg)  # jax_start's parameters
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(tree)))
    step, sstate = JT.make_sharded_train_step(mesh, state, jcfg)
    new_state, metrics = step(sstate, JT.TrainingBatch(*map(jnp.asarray, batch)))
    assert int(new_state.step) == 1
    np.testing.assert_allclose(out["step_metrics"]["loss"], float(metrics["loss"]), rtol=2e-2)
    old = jax.tree.leaves(tree)
    n_jax = float(np.sqrt(sum(np.sum((np.asarray(a, np.float64) - b) ** 2)
                              for a, b in zip(jax.tree.leaves(new_state.params), old))))
    start_p = {n: p.detach().double().numpy() for n, p in fe.named_parameters()}
    np.testing.assert_allclose(_update_norm(out["params"], start_p), n_jax, rtol=5e-2)
