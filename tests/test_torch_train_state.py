"""The port's optimizer, checkpoints and training loop on the CPU, at
tests/test_training.py's TINY configuration.

- AdamW against ``optax.adamw`` over 1 and 10 updates from the same
  gradients: parameters within rtol 1e-6, and within 1e-6 of the steps'
  summed size (updates x learning rate) where a parameter passes near
  zero.
- ``params_to_jax(params_from_jax(tree)) == tree`` exactly, for a TINY tree
  and the flagship checkpoint.
- A port-written checkpoint: byte for byte what flax writes for the same
  tree, its ``__meta__`` read by frontend/weights.py's ``load_meta``, its
  parameters restored into a JAX template equal to the tree, and
  ``load_train_state`` giving the parameters back.
- ``python -m forest_slam_tpu_torch.train`` (its ``main``) on the CPU: a
  two-step run at a small size writes a checkpoint JAX's loader reads,
  with train-frontend's ``__meta__``; ``train`` refuses to run without a
  card unless given ``device="cpu"``.
- The corridor pool from a generator: a "mix" pool of one forest and one
  corridor pair, labels inside the views, the same pool again from the
  same seed.
- 30 steps of the port alone at TINY on the CPU (port initialisation and
  batches from seed 0, attention by the Function: the kernel's plain
  version on CPU tensors): every loss finite and the mean of the last five
  below 0.8x the mean of the first five, tests/test_training.py's rule; no
  kernel launches (CPU tensors).
"""

import numpy as np
import optax
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from _torch_train_parity import port_frontend, torch_tiny
from forest_slam_tpu.frontend import weights as jweights
from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward
from forest_slam_tpu_torch.frontend.learned import LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
from forest_slam_tpu_torch.frontend.weights import (
    FLAGSHIP_PATH,
    params_from_jax,
    params_to_jax,
    read_checkpoint,
    save_params,
)
from forest_slam_tpu_torch.train.trainer import (
    checkpoint_meta,
    create_train_state,
    load_train_state,
    make_optimizer,
    train,
)


@pytest.fixture(scope="module")
def tree():
    """A TINY parameter tree (the port's Flax-style initialisation, seed 0)."""
    return params_to_jax(create_train_state(torch_tiny(), seed=0, device="cpu").frontend)


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("n_updates", [1, 10])
def test_adamw_matches_optax(tree, n_updates):
    cfg = torch_tiny()
    fe = port_frontend(tree, cfg)
    opt = make_optimizer(fe.parameters(), cfg)
    jparams = jax.tree.map(jnp.asarray, params_to_jax(fe))
    tx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(n_updates)
    for _ in range(n_updates):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), jparams)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gfe = port_frontend(jax.tree.map(np.asarray, grads), cfg)
        for p, g in zip(fe.parameters(), gfe.parameters()):
            p.grad = g.detach().clone()
        opt.step()
    got = params_to_jax(fe)
    for (path, ref), new in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(got)):
        np.testing.assert_allclose(new, np.asarray(ref), rtol=1e-6, atol=1e-6 * n_updates * cfg.learning_rate, err_msg=jax.tree_util.keystr(path))
    moved = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - b).max()), got, tree))
    assert min(moved) > 0  # every parameter took the updates


def test_params_roundtrip_exact(tree):
    _assert_trees_equal(params_to_jax(port_frontend(tree, torch_tiny())), tree)
    meta, flagship = read_checkpoint(FLAGSHIP_PATH)
    cfg = LearnedFrontendConfig(superpoint=SuperPointConfig(stem_stride=meta["stem_stride"]),
                                superglue=SuperGlueConfig(gnn_layers=meta["gnn_layers"]))
    _assert_trees_equal(params_to_jax(params_from_jax(flagship, cfg)), flagship)


def test_checkpoint_read_by_jax(tree, tmp_path):
    cfg = torch_tiny(detector_soft=True)
    fe = port_frontend(tree, cfg)
    path = str(tmp_path / "port.msgpack")
    meta = checkpoint_meta(cfg)
    assert meta == {"stem_stride": 1, "gnn_layers": 2, "sinkhorn_iterations": 10, "subpixel": "com3"}
    save_params(params_to_jax(fe), path, meta=meta)
    raw = open(path, "rb").read()
    assert raw == serialization.to_bytes({"__meta__": meta, "params": params_to_jax(fe)})
    assert jweights.load_meta(path) == meta
    restored = serialization.from_state_dict(jax.tree.map(jnp.asarray, tree),
                                             serialization.msgpack_restore(raw)["params"])
    _assert_trees_equal(jax.tree.map(np.asarray, restored), tree)
    state = load_train_state(path, cfg, seed=5, device="cpu")
    _assert_trees_equal(params_to_jax(state.frontend), tree)
    assert state.step == 0 and not state.optimizer.state
    with pytest.raises(ValueError, match="shape"):
        load_train_state(path, cfg._replace(superpoint=SuperPointConfig(stem_stride=2)), device="cpu")


def test_entry_point_writes_a_jax_checkpoint(tmp_path):
    from forest_slam_tpu_torch.train.__main__ import main

    out = str(tmp_path / "cli.msgpack")
    assert main(["--steps", "2", "--batch", "2", "--height", "64", "--width", "80", "--corridor-fraction", "0",
                 "--log-every", "1", "--device", "cpu", "--out", out]) == 0
    assert jweights.load_meta(out) == {"stem_stride": 2, "gnn_layers": 9, "sinkhorn_iterations": 20}
    params = serialization.msgpack_restore(open(out, "rb").read())["params"]
    assert params["superpoint"]["params"]["enc1_0"]["kernel"].shape == (3, 3, 4, 64)
    assert set(params["superglue"]["params"]) >= {"self_8", "cross_8", "kenc", "final_proj", "bin_score"}


def test_train_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(torch_tiny(), 1)


def test_train_reduces_loss():
    n = attention_forward.launches
    state, history = train(torch_tiny("auto"), 30, seed=0, log_every=10, device="cpu", verbose=False)
    losses = np.array([m["loss"] for _, m in history])
    assert [step for step, _ in history] == list(range(30)) and state.step == 30
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < 0.8 * losses[:5].mean(), losses
    assert attention_forward.launches == n


def test_corridor_pool_from_generator():
    from forest_slam_tpu_torch.train.data import make_corridor_pool

    def pool():
        g = torch.Generator()
        g.manual_seed(2)
        return make_corridor_pool(g, 2, 64, 80, 24, chunk=1, scene="mix", forest_share=0.5, device="cpu")

    p = pool()
    assert p.image0.shape == (2, 64, 80) and p.corners1.shape == (2, 24, 2)
    assert p.valid0.sum() >= 10 and p.valid1.any() and not (p.valid1 & ~p.valid0).any()
    assert ((p.image0 >= 0) & (p.image0 <= 255)).all()
    c1 = p.corners1[p.valid1]
    assert (c1[:, 0] >= 4).all() and (c1[:, 0] < 80 - 4).all() and (c1[:, 1] >= 4).all() and (c1[:, 1] < 64 - 4).all()
    assert all(torch.equal(a, b) for a, b in zip(p, pool()))
