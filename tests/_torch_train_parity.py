"""Shared set-up of the trainer parity tests (test_torch_trainer*.py): the
JAX trainer's TINY configuration (tests/test_training.py) and its port,
JAX's initial parameters and a batch, and the comparison of one step's
loss and gradients.

The tolerances come from the JAX trainer's own spread
(scripts/train_grad_envelope.py). Through SuperGlue's Sinkhorn NLL at
initialisation the bf16 model is chaotic, by a degree that depends on the
batch: on the JAX package's own TINY batch, perturbing every JAX parameter
by 1e-6 of itself moves the matching loss by 0.18% and leaves the gradient
at cosine 0.977 (per leaf >= 0.95, rel-L2 0.22), and the same JAX step
jitted or not differs by 0.38% in the matching loss; on this file's batch
(the port's generator, seed 4) the same probe gives 0.20%, 0.9967 (per
leaf >= 0.994, rel-L2 0.088) and no difference. The bounds take the wider
envelope with room:

- the detector and descriptor terms, which do not pass through SuperGlue,
  are held tightly: losses to rtol 1e-4 and 1e-3, their gradients (every
  SuperPoint leaf) to cosine 0.99, and rel-L2 0.05 over all of them;
- the matching term to rtol 3e-2 and the total to 2e-2; the whole
  gradient to cosine 0.9 and rel-L2 0.5, each leaf that carries signal
  (norm above 1e-3 of the total) to cosine 0.85;
- the zoom term (w_zoom) to rtol 1e-3: its zoom factor comes from each
  image's pixel sum, which the two packages add in another order.
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JSPConfig
from forest_slam_tpu.train import trainer as JT
from forest_slam_tpu_torch.frontend.learned import LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
from forest_slam_tpu_torch.frontend.weights import params_from_jax, params_to_jax
from forest_slam_tpu_torch.train import trainer as TT
from forest_slam_tpu_torch.train.data import TrainingBatch, make_training_batch


def jax_tiny(attention_impl="xla", **kw):
    return JT.TrainConfig(superpoint=JSPConfig(max_keypoints=64),
                          superglue=JSGConfig(gnn_layers=2, sinkhorn_iterations=10, attention_impl=attention_impl),
                          height=64, width=80, batch_size=2, max_corners=24, learning_rate=2e-3, **kw)


def torch_tiny(attention_impl="xla", **kw):
    return TT.TrainConfig(superpoint=SuperPointConfig(max_keypoints=64),
                          superglue=SuperGlueConfig(gnn_layers=2, sinkhorn_iterations=10, attention_impl=attention_impl),
                          height=64, width=80, batch_size=2, max_corners=24, learning_rate=2e-3, **kw)


def jax_start():
    """JAX's initial TINY parameters (numpy tree) and a batch from seed 4
    (the port's generator on the CPU; numpy arrays for both sides)."""
    cfg = jax_tiny()
    params = jax.jit(lambda k: JT.create_train_state(k, cfg).params)(jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(4)
    batch = make_training_batch(gen, 2, 64, 80, 24, device="cpu")
    return jax.tree.map(np.asarray, params), JT.TrainingBatch(*(t.numpy() for t in batch))


def port_frontend(tree, cfg):
    return params_from_jax(tree, LearnedFrontendConfig(superpoint=cfg.superpoint, superglue=cfg.superglue))


def torch_batch(batch):
    return TrainingBatch(*(torch.as_tensor(np.array(a)) for a in batch))


def _jax_metrics_and_grads(tree, batch, cfg, mesh=None):
    """Metrics, the gradient of the total and that of detector + descriptor;
    on ``mesh``, with the parameters and the batch sharded as
    make_sharded_train_step shards them (tests/test_training.py)."""
    def run(p, b):
        metrics, pull = jax.vjp(lambda q: JT.loss_fn(q, b, cfg)[1], p)
        one = lambda names: pull({k: jnp.float32(k in names) for k in metrics})[0]
        return metrics, one(("loss",)), one(("detector", "descriptor"))

    params, jbatch = jax.tree.map(jnp.asarray, tree), JT.TrainingBatch(*map(jnp.asarray, batch))
    if mesh is None:
        fn = jax.jit(run)
    else:
        from forest_slam_tpu.parallel.mesh import batch_shardings, param_shardings

        fn = jax.jit(run, in_shardings=(param_shardings(params, mesh), batch_shardings(jbatch, mesh)))
    m, g_all, g_sp = fn(params, jbatch)
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, g_all), jax.tree.map(np.asarray, g_sp)


def _port_metrics_and_grads(tree, batch, cfg):
    fe = port_frontend(tree, cfg)
    total, m = TT.loss_fn(fe, torch_batch(batch), cfg)
    params = list(fe.parameters())
    g_all = torch.autograd.grad(total, params, retain_graph=True)
    g_sp = torch.autograd.grad(m["detector"] + m["descriptor"], params, allow_unused=True)

    def tree_of(grads):
        return grads_to_jax(fe, {n: torch.zeros_like(p) if d is None else d for (n, p), d in
                                 zip(fe.named_parameters(), grads)})

    return {k: float(v.detach()) for k, v in m.items()}, tree_of(g_all), tree_of(g_sp)


def grads_to_jax(fe, grads: dict) -> dict:
    """Gradients by the port's parameter names -> the JAX parameter tree."""
    g = copy.deepcopy(fe)
    for name, p in g.named_parameters():
        p.data = torch.as_tensor(grads[name]).detach().float().clone()
    return params_to_jax(g)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64).ravel()
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _cos(a, b):
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def assert_step_matches(tree, batch, jax_cfg, torch_cfg):
    return assert_within_envelope(_jax_metrics_and_grads(tree, batch, jax_cfg),
                                  _port_metrics_and_grads(tree, batch, torch_cfg))


def assert_within_envelope(jax_step, port_step):
    """Hold one step's (metrics, gradient of the total, gradient of detector
    + descriptor) of the port to JAX's, within the envelope above."""
    (jm, jg_all, jg_sp), (tm, tg_all, tg_sp) = jax_step, port_step
    assert set(jm) == set(tm)
    np.testing.assert_allclose(tm["detector"], jm["detector"], rtol=1e-4)
    np.testing.assert_allclose(tm["descriptor"], jm["descriptor"], rtol=1e-3)
    np.testing.assert_allclose(tm["matching"], jm["matching"], rtol=3e-2)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-2)
    if "zoom" in jm:
        np.testing.assert_allclose(tm["zoom"], jm["zoom"], rtol=1e-3)
    # detector + descriptor: SuperPoint's leaves, tightly
    r, g = _flat(jg_sp), _flat(tg_sp)
    assert set(r) == set(g)
    sp = [k for k in r if k.startswith("['superpoint']")]
    for k in sp:
        assert _cos(r[k], g[k]) >= 0.99, (k, _cos(r[k], g[k]))
    ra, ga = np.concatenate([r[k] for k in sp]), np.concatenate([g[k] for k in sp])
    assert np.linalg.norm(ra - ga) <= 0.05 * np.linalg.norm(ra)
    for k in r:
        if k not in sp:  # SuperGlue gets no gradient from these terms
            assert not g[k].any() and not r[k].any(), k
    # the whole loss: within the chaotic envelope
    r, g = _flat(jg_all), _flat(tg_all)
    ra, ga = np.concatenate(list(r.values())), np.concatenate([g[k] for k in r])
    total = np.linalg.norm(ra)
    assert _cos(ra, ga) >= 0.9 and np.linalg.norm(ra - ga) <= 0.5 * total
    checked = 0
    for k in r:
        if np.linalg.norm(r[k]) >= 1e-3 * total:
            checked += 1
            assert _cos(r[k], g[k]) >= 0.85, (k, _cos(r[k], g[k]))
    assert checked >= 40
    return jm, tm
