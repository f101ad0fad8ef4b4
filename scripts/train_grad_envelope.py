#!/usr/bin/env python3
"""How far one training step's loss and gradient move when every parameter
moves by a relative 1e-6: the rounding envelope that the trainer's parity
tolerances are set against, taken on the CPU.

    python3 scripts/train_grad_envelope.py --side jax    # the JAX trainer at tests/test_training.py's TINY
    python3 scripts/train_grad_envelope.py --side jax --jax-batch   # the same on the JAX package's own batch
    python3 scripts/train_grad_envelope.py --side port   # the port at chip_smoke.py's full-width recipe
    python3 scripts/train_grad_envelope.py --side distill   # the port's distillation step, chip_smoke's recipe

``--side jax`` takes the JAX trainer's initial TINY parameters and the batch
of the port's generator at seed 4, as tests/_torch_train_parity.py does (or,
with ``--jax-batch``, the JAX package's ``make_training_batch(PRNGKey(4))``),
and compares the jitted gradient with the gradient at parameters scaled by
``1 + 1e-6 * N(0, 1)`` (numpy seed 0), and the jitted matching loss with the
eager one. ``--side port`` does the same for the port's own step at
``chip_smoke.train_config()`` on a batch drawn with an 8-pair pool, through
``chip_smoke.step_agreement``. ``--side distill`` does it on the CPU for
one step of ``chip_smoke.distill_config()`` (the stem-2 teacher into a
stem-4 student, batch 8 of 240x320, every term on), perturbing the student,
through ``chip_smoke.distill_agreement``. With a card it takes the batch
that ``chip_smoke.py``'s distillation phase holds (``distill_setup``: the
64-frame pool rendered on the card) and also reports the card's step
against the CPU's, split in two: the CPU student on the card teacher's
outputs against the CPU's step (the teacher's share) and against the
card's step (the student's share), with how far the teacher's outputs
differ. Without a card it draws from an 8-frame pool rendered on the CPU.
It reads the teacher checkpoint and renders 600x960 frames, so run it where
the memory allows (the card's machine). Prints one JSON line: each loss
term's relative change, the gradient's cosine and relative L2, and the
least cosine of a leaf carrying more than 1e-3 of the gradient's norm.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cos(a, b):
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def jax_side(jax_batch: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from forest_slam_tpu.frontend.superglue import SuperGlueConfig
    from forest_slam_tpu.frontend.superpoint import SuperPointConfig
    from forest_slam_tpu.train import trainer as JT
    from forest_slam_tpu.train.data import make_training_batch as jax_training_batch
    from forest_slam_tpu_torch.train.data import make_training_batch

    cfg = JT.TrainConfig(superpoint=SuperPointConfig(max_keypoints=64),
                         superglue=SuperGlueConfig(gnn_layers=2, sinkhorn_iterations=10, attention_impl="xla"),
                         height=64, width=80, batch_size=2, max_corners=24, learning_rate=2e-3)
    params = jax.jit(lambda k: JT.create_train_state(k, cfg).params)(jax.random.PRNGKey(0))
    if jax_batch:
        batch = jax_training_batch(jax.random.PRNGKey(4), 2, 64, 80, 24)
    else:
        gen = torch.Generator()
        gen.manual_seed(4)
        batch = JT.TrainingBatch(*(jnp.asarray(t.numpy()) for t in make_training_batch(gen, 2, 64, 80, 24,
                                                                                        device="cpu")))
    grad_fn = jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, cfg), has_aux=True)
    (_, m0), g0 = jax.jit(grad_fn)(params, batch)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    moved = tdef.unflatten([x * (1 + 1e-6 * rng.standard_normal(x.shape).astype(np.float32)) for x in leaves])
    (_, m1), g1 = jax.jit(grad_fn)(moved, batch)
    (_, m_eager), _ = grad_fn(params, batch)
    a = {jax.tree_util.keystr(p): np.asarray(x, np.float64).ravel() for p, x in jax.tree_util.tree_leaves_with_path(g0)}
    b = {jax.tree_util.keystr(p): np.asarray(x, np.float64).ravel() for p, x in jax.tree_util.tree_leaves_with_path(g1)}
    A, B = np.concatenate(list(a.values())), np.concatenate([b[k] for k in a])
    total = np.linalg.norm(A)
    leaf = {k: _cos(a[k], b[k]) for k in a if np.linalg.norm(a[k]) >= 1e-3 * total}
    rel = {k: abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k])) for k in m0}
    return dict(side="jax", config="TINY", batch="jax" if jax_batch else "port, seed 4", rel=rel,
                global_cos=_cos(A, B), global_rel=float(np.linalg.norm(A - B) / total),
                leaf_min_cos=min(leaf.values()), leaves_checked=len(leaf),
                matching_jit_vs_eager=abs(float(m_eager["matching"]) - float(m0["matching"])) / abs(float(m0["matching"])))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def port_side() -> dict:
    import torch

    cs = _chip_smoke()
    from forest_slam_tpu_torch.train.data import make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state

    cfg = cs.train_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    pool = make_corridor_pool(gen, 8, cfg.height, cfg.width, cfg.max_corners, chunk=8, device="cpu")
    batch = make_training_batch(gen, cfg.batch_size, cfg.height, cfg.width, cfg.max_corners, cfg.texture_fraction,
                                cfg.corridor_fraction, pool, "cpu")
    ref = cs.step_gradients(state.frontend, batch, cfg)
    moved = copy.deepcopy(state.frontend)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
    out = cs.step_agreement(ref, cs.step_gradients(moved, batch, cfg))
    return dict(side="port", config="chip_smoke.train_config()", **{k: out[k] for k in (
        "rel", "global_cos", "global_rel", "leaf_min_cos", "leaf_worst", "leaves_checked", "sp_min_cos")})


def distill_side() -> dict:
    import time

    import torch

    from forest_slam_tpu_torch.frontend.superpoint import SuperPointRaw
    from forest_slam_tpu_torch.train.distill import _cell_com, step_inputs, teacher_outputs

    cs = _chip_smoke()
    card = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    cfg = cs.distill_config() if card else cs.distill_config()._replace(pool_frames=8)
    cfg, (teacher, _, _), state, gen, host, pool = cs.distill_setup(dev, cfg)
    inputs = step_inputs(gen, host, cfg, pool)
    cpu_inputs = (inputs[0].cpu(), tuple(t.cpu() for t in inputs[1]), inputs[2].cpu())
    student = copy.deepcopy(state.student).cpu()
    t_cpu = teacher_outputs(copy.deepcopy(teacher).cpu(), cpu_inputs[0])
    t0 = time.time()
    ref = cs.distill_gradients(student, t_cpu, cpu_inputs, cfg)
    seconds = time.time() - t0
    moved = copy.deepcopy(student)
    host_gen = torch.Generator()
    host_gen.manual_seed(0)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=host_gen))
    keys = ("rel", "global_cos", "global_rel", "leaf_min_cos", "leaf_worst", "leaves_checked")
    pick = lambda out: {k: out[k] for k in keys}
    envelope = cs.distill_agreement(ref, cs.distill_gradients(moved, t_cpu, cpu_inputs, cfg))
    out = dict(side="distill", config="chip_smoke.distill_config()", pool_frames=cfg.pool_frames,
               cpu_step_seconds=seconds, **pick(envelope))
    if card:
        # the card's step against the CPU's, then split: the CPU student on
        # the card teacher's outputs differs from the CPU's step only by the
        # teacher's forward, and from the card's step only by the student's
        t_card = teacher_outputs(teacher, inputs[0])
        t_mixed = SuperPointRaw(*(t.cpu() for t in t_card))
        mixed = cs.distill_gradients(student, t_mixed, cpu_inputs, cfg)
        got = cs.distill_gradients(state.student, t_card, inputs, cfg)
        com = lambda t: _cell_com(t.det_logits.float())
        out["card_vs_cpu"] = pick(cs.distill_agreement(ref, got))
        out["teacher_share"] = pick(cs.distill_agreement(ref, mixed))
        out["student_share"] = pick(cs.distill_agreement(mixed, got))
        d = (t_mixed.det_logits.float() - t_cpu.det_logits.float()).abs()
        out["teacher_outputs"] = dict(
            det_logits_max_abs=float(d.max()), det_logits_share_differing=float((d > 0).float().mean()),
            coarse_desc_max_abs=float((t_mixed.coarse_desc.float() - t_cpu.coarse_desc.float()).abs().max()),
            cell_com_max_abs_px=float((com(t_mixed) - com(t_cpu)).abs().max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=["jax", "port", "distill"], required=True)
    ap.add_argument("--jax-batch", action="store_true", help="--side jax: the JAX package's batch")
    args = ap.parse_args()
    sides = {"jax": lambda: jax_side(args.jax_batch), "port": port_side, "distill": distill_side}
    print(json.dumps(sides[args.side]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
