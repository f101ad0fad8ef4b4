"""Functions the port's multi-rank tests run on every rank
(forest_slam_tpu_torch.parallel.launch). Each rank imports this module
afresh, so it imports no JAX (and the tests' conftest never runs there).
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from forest_slam_tpu_torch.frontend.learned import LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.weights import params_from_jax
from torch.distributed.device_mesh import init_device_mesh

from forest_slam_tpu_torch.parallel import make_mesh, mesh_shape
from forest_slam_tpu_torch.pipelines.batch_eval import run_batched_eval
from forest_slam_tpu_torch.train import trainer as TT
from forest_slam_tpu_torch.train.data import TrainingBatch


def mesh_of(shape):
    """``make_mesh`` when ``shape`` is its own for the world, else the
    (data, model) mesh of that shape, as JAX tests build a Mesh by hand."""
    if tuple(shape) == mesh_shape(dist.get_world_size()):
        return make_mesh(dist.get_world_size(), "cpu")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))


def _np(tensors: dict) -> dict:
    return {k: v.detach().double().cpu().numpy() for k, v in tensors.items()}


def sharded_step(shape, tree, batch, cfg):
    """One sharded step on a mesh of ``shape`` from JAX's parameter tree
    (numpy) and a batch of numpy arrays: the metrics, the whole gradients
    of the total loss and of detector + descriptor, the whole parameters
    after the update, and each rank's shapes of its shards, their moments
    and its frontend's copies of the sharded kernels, from rank 0."""
    mesh = mesh_of(shape)
    fe = params_from_jax(tree, LearnedFrontendConfig(superpoint=cfg.superpoint, superglue=cfg.superglue))
    state = TT.TrainState(frontend=fe, optimizer=TT.make_optimizer(fe.parameters(), cfg), step=0)
    batch = TrainingBatch(*(torch.as_tensor(np.array(a)) for a in batch))
    step, st = TT.make_sharded_train_step(mesh, state, cfg)
    _, g_sp = step.gradients(st, batch, of=lambda m: m["detector"] + m["descriptor"])
    metrics, g_all = step.gradients(st, batch)
    st, step_metrics = step(st, batch)
    held = {name: dict(shard=tuple(sh.shape), exp_avg=tuple(st.optimizer.state[sh]["exp_avg"].shape),
                       exp_avg_sq=tuple(st.optimizer.state[sh]["exp_avg_sq"].shape),
                       module=tuple(dict(st.frontend.named_parameters())[name].shape))
            for name, sh in st.shards.items()}
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, held)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                step_metrics={k: float(v) for k, v in step_metrics.items()}, g_all=_np(g_all), g_sp=_np(g_sp),
                params=_np(step.parameters(st)), step=st.step, placements={k: repr(v) for k, v in st.placements.items()},
                held=per_rank, mesh=(mesh.size(0), mesh.size(1)), foreign_modules=foreign_modules())


def foreign_modules() -> list:
    """The modules of JAX or of the JAX package this rank has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "forest_slam_tpu"))


def batch_eval(shape, cases):
    """``run_batched_eval`` on a mesh of ``shape`` of each case, a dict of
    (il, ir, gt, rig, cfg, draws): (ATEs, ok fractions, poses, ok flags)
    for each, and under "odd" the ValueError's message for the first
    case's sequences less one (None if it did not raise)."""
    mesh = mesh_of(shape)
    out = {}
    for name, (il, ir, gt, rig, cfg, draws) in cases.items():
        results, poses, ok = run_batched_eval(il, ir, gt, rig, cfg, mesh, frame_batch=6, pair_batch=5,
                                              with_ok=True, **(draws or {}))
        out[name] = ([r.ate_rmse for r in results], [r.ok_fraction for r in results], poses, ok)
    il, ir, gt, rig, cfg, _ = next(iter(cases.values()))
    try:
        run_batched_eval(il[1:], ir[1:], gt[1:], rig, cfg, mesh)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    out["foreign_modules"] = foreign_modules()
    return out


def placements(cfg):
    """On 8 ranks, for the (2, 4) and (4, 2) meshes: ``param_shardings`` of
    a fresh front end, ``batch_shardings`` of a batch, ``replicated``, and
    each rank's (rank, data index, model index)."""
    from forest_slam_tpu_torch.parallel import batch_shardings, param_shardings, replicated
    from forest_slam_tpu_torch.train.data import make_training_batch

    out = {}
    for shape in ((2, 4), (4, 2)):
        mesh = mesh_of(shape)
        fe = TT.create_train_state(cfg, 0, "cpu").frontend
        gen = torch.Generator()
        gen.manual_seed(0)
        batch = make_training_batch(gen, cfg.batch_size, cfg.height, cfg.width, cfg.max_corners, device="cpu")
        layout = [None] * dist.get_world_size()
        dist.all_gather_object(layout, (dist.get_rank(), mesh.get_local_rank("data"), mesh.get_local_rank("model")))
        bs = batch_shardings(batch, mesh)
        out[shape] = dict(params={k: repr(v) for k, v in param_shardings(fe, mesh).items()}, layout=layout,
                          batch=[repr(p) for p in bs], batch_type=type(bs).__name__, replicated=repr(replicated(mesh)))
    return out
