"""Training loop for the learned front end, SuperPoint and SuperGlue jointly
(port of train/trainer.py).

One :func:`train_step` computes the detector cell cross-entropy on both
images of a pair, the descriptor InfoNCE at ground-truth correspondences,
SuperGlue's Sinkhorn NLL (and, with ``w_zoom``, a zoomed-view descriptor
term), then an AdamW update of every float32 parameter. :func:`train` draws
each batch on the device from one ``torch.Generator`` and runs the steps in
a Python loop (the reference scans them on the device), reading the
metrics back to the host only every ``log_every`` steps. It runs on the
card unless given ``device="cpu"``. :func:`make_sharded_train_step` is the
same step over a ('data', 'model') mesh of ranks (parallel/mesh.py).
"""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from forest_slam_tpu_torch.core.camera import remap_bilinear
from forest_slam_tpu_torch.frontend.learned import LearnedFrontend, LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, SuperPointNet, _sample_coarse_descriptors
from forest_slam_tpu_torch.frontend.weights import read_checkpoint, superglue_from_jax, superpoint_from_jax
from forest_slam_tpu_torch.train.data import TrainingBatch, make_corridor_pool, make_training_batch
from forest_slam_tpu_torch.train.losses import descriptor_nce_loss, detector_loss, detector_loss_soft, matching_loss
from forest_slam_tpu_torch.utils.corrupt import apply_motion_blur
from forest_slam_tpu_torch.utils.filters import maxpool2d_same


class TrainConfig(NamedTuple):
    """The reference's fields and defaults (train/trainer.py:41-97)."""

    superpoint: SuperPointConfig = SuperPointConfig()
    superglue: SuperGlueConfig = SuperGlueConfig()
    height: int = 120
    width: int = 160
    batch_size: int = 8
    max_corners: int = 48
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    w_detector: float = 1.0
    w_descriptor: float = 1.0
    w_matching: float = 0.5
    texture_fraction: float = 0.5
    corridor_fraction: float = 0.0  # 3D-supervised corridor pairs
    corridor_pool_size: int = 4096  # pairs rendered once per run, sampled per step
    corridor_scene: str = "corridor"  # "corridor", "forest" or "mix"
    forest_share: float = 0.5  # forest share of a "mix" pool
    corridor_min_forward: float = 0.15  # forward gap of the 3D pairs, metres
    corridor_max_forward: float = 3.0
    detector_soft: bool = False  # bilinear sub-pixel detector targets
    w_zoom: float = 0.0  # zoomed-view descriptor InfoNCE weight
    zoom_min: float = 1.2
    zoom_max: float = 2.0
    blur_fraction: float = 0.0  # share of images motion-blurred in random regions
    blur_kernel: int = 15


class TrainState(NamedTuple):
    """The modules and optimizer (updated in place by :func:`train_step`)
    and the number of steps taken."""

    frontend: LearnedFrontend
    optimizer: torch.optim.Optimizer
    step: int


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be there when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA card and none is available; pass device='cpu' to train on the CPU")
    return dev


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose step does ``optax.adamw``'s arithmetic in
    its order: moments ``(1 - b) g^k + b m``, bias corrections ``1 - b^t``
    rounded to float32 (PyTorch's own step takes them in float64 and is up
    to 5e-5 off optax on a first update, 3e-4 after ten), the update
    ``m_hat / (sqrt(v_hat) + eps) + wd p`` scaled by ``-lr`` and added.
    Same hyperparameters and state (``step``, ``exp_avg``, ``exp_avg_sq``),
    multi-tensor ops, and the host reads nothing back from the card."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["step"] += 1
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            t = self.state[params[0]]["step"].float()
            bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** t) for b in (b1, b2))
            den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
        return loss


def make_optimizer(params, cfg: TrainConfig) -> AdamW:
    """``optax.adamw(lr, weight_decay=cfg.weight_decay)`` at its defaults,
    over every parameter (PyTorch's own default decay is 0.01)."""
    return AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated to +-2 standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(t.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    t.copy_(torch.clamp(z, -2.0, 2.0) * std)


def superpoint_init_(net: SuperPointNet, gen: torch.Generator) -> None:
    """Flax's initialisers of a SuperPointNet from ``gen``: LeCun-normal
    conv kernels, zero biases."""
    with torch.no_grad():
        for conv in net.convs.values():
            o, i, kh, kw = conv.weight.shape
            _lecun_normal_(conv.weight, i * kh * kw, gen)
            conv.bias.zero_()


def flax_init_(fe: LearnedFrontend, gen: torch.Generator) -> None:
    """Flax's initialisers from ``gen``: LeCun-normal Dense and Conv
    kernels, zero biases, LayerNorm scale one and bias zero, bin_score 1."""
    superpoint_init_(fe.superpoint, gen)
    with torch.no_grad():
        sg = fe.superglue
        for lin in [*sg.kenc.mlp, sg.kenc.mlp_out, sg.final_proj]:
            _lecun_normal_(lin.weight, lin.weight.shape[1], gen)
            lin.bias.zero_()
        for layer in sg.layers.values():
            for dense in [*layer.attn.values(), layer.mlp0, layer.mlp1]:
                _lecun_normal_(dense.kernel, dense.kernel.shape[0], gen)
                dense.bias.zero_()
            layer.ln.scale.fill_(1.0)
            layer.ln.bias.zero_()
        sg.bin_score.fill_(1.0)


def create_train_state(cfg: TrainConfig, seed: int = 0, device="cuda") -> TrainState:
    """Freshly initialised modules (drawn on the CPU from ``seed``, so every
    device starts from the same parameters) and a new AdamW."""
    dev = resolve_device(device)
    fe = LearnedFrontend(LearnedFrontendConfig(superpoint=cfg.superpoint, superglue=cfg.superglue),
                         SuperPointNet(cfg.superpoint), SuperGlue(cfg.superglue))
    gen = torch.Generator()
    gen.manual_seed(seed)
    flax_init_(fe, gen)
    fe = fe.to(dev)
    return TrainState(frontend=fe, optimizer=make_optimizer(fe.parameters(), cfg), step=0)


def load_train_state(path: str, cfg: TrainConfig, seed: int = 0, device="cuda") -> TrainState:
    """Warm start from a checkpoint (the optimizer starts afresh): it must
    match ``cfg``'s architecture; a parameter of another shape raises."""
    state = create_train_state(cfg, seed, device)
    _, tree = read_checkpoint(path)
    superpoint_from_jax(tree["superpoint"]["params"], cfg.superpoint, net=state.frontend.superpoint)
    superglue_from_jax(tree["superglue"]["params"], cfg.superglue, sg=state.frontend.superglue)
    return state


def checkpoint_meta(cfg: TrainConfig) -> dict:
    """The ``__meta__`` the reference's train-frontend writes (cli.py:615-625)."""
    meta = {"stem_stride": cfg.superpoint.stem_stride, "gnn_layers": cfg.superglue.gnn_layers,
            "sinkhorn_iterations": cfg.superglue.sinkhorn_iterations}
    if cfg.detector_soft:
        meta["subpixel"] = "com3"  # soft targets make the heat interpolable
    return meta


def loss_fn(fe: LearnedFrontend, batch: TrainingBatch, cfg: TrainConfig, global_count=None):
    """(total loss, metrics) of one batch, as the reference's loss_fn. With
    ``global_count`` (a local count -> the global batch's), ``batch`` is one
    data-parallel rank's slice and every term its share of the global term."""
    kw = {} if global_count is None else {"total": global_count}
    B, M = batch.valid0.shape
    images = torch.cat([batch.image0, batch.image1]) / 255.0
    raw = fe.superpoint(images)
    det_fn = detector_loss_soft if cfg.detector_soft else detector_loss
    l_det = det_fn(raw.det_logits, torch.cat([batch.corners0, batch.corners1]),
                   torch.cat([batch.valid0, batch.valid1]), **kw)
    # descriptors at the ground-truth correspondences (differentiable sampling)
    desc0 = _sample_coarse_descriptors(raw.coarse_desc[:B], batch.corners0)
    desc1 = _sample_coarse_descriptors(raw.coarse_desc[B:], batch.corners1)
    matchable = batch.valid0 & batch.valid1
    l_desc = descriptor_nce_loss(desc0, desc1, matchable, **kw)
    score = torch.ones_like(batch.valid0, dtype=torch.float32)
    log_p = fe.superglue(batch.corners0, score, desc0, batch.valid0, batch.corners1, score, desc1, batch.valid1,
                         (cfg.height, cfg.width), return_couplings=True)
    idx = torch.arange(M, device=matchable.device).expand(B, M)
    l_match = matching_loss(log_p, torch.where(matchable, idx, torch.full_like(idx, -1)), batch.valid0, batch.valid1,
                            **kw)
    metrics = {"detector": l_det, "descriptor": l_desc, "matching": l_match}
    total = cfg.w_detector * l_det + cfg.w_descriptor * l_desc + cfg.w_matching * l_match
    if cfg.w_zoom > 0:
        H, W = cfg.height, cfg.width
        dev = batch.image0.device
        ctr = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=dev)
        # a zoom factor for each sample from its content (any spread in the range serves)
        u = torch.remainder(batch.image0.sum(dim=(1, 2)) * 1e-3, 1.0)
        s = (cfg.zoom_min + (cfg.zoom_max - cfg.zoom_min) * u)[:, None, None]
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        src = torch.stack([(gx - ctr[0]) / s + ctr[0], (gy - ctr[1]) / s + ctr[1]], dim=-1)
        raw_z = fe.superpoint(remap_bilinear(batch.image0 / 255.0, src))
        cz = (batch.corners0 - ctr) * s + ctr
        in_z = (cz[..., 0] >= 4) & (cz[..., 0] < W - 4) & (cz[..., 1] >= 4) & (cz[..., 1] < H - 4)
        l_zoom = descriptor_nce_loss(desc0, _sample_coarse_descriptors(raw_z.coarse_desc, cz), batch.valid0 & in_z,
                                     **kw)
        metrics["zoom"] = l_zoom
        total = total + cfg.w_zoom * l_zoom
    metrics["loss"] = total
    return total, metrics


def train_step(state: TrainState, batch: TrainingBatch, cfg: TrainConfig):
    """Gradients of :func:`loss_fn`, then one AdamW update (every parameter
    gets one, a zero gradient where the loss does not reach it, as optax
    does): (state with step + 1, detached metrics)."""
    fe, opt = state.frontend, state.optimizer
    opt.zero_grad(set_to_none=True)
    total, metrics = loss_fn(fe, batch, cfg)
    total.backward()
    for p in fe.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return state._replace(step=state.step + 1), {k: v.detach() for k, v in metrics.items()}


class ShardedTrainState(NamedTuple):
    """A TrainState spread over a mesh (train/trainer.py:299-329). Each
    tensor-shardable kernel lives as this rank's ``1/model`` slice in
    ``shards`` (float32 masters), and ``optimizer`` (AdamW over the shards
    and the replicated parameters) holds its moments as slices too;
    ``frontend`` holds the replicated parameters whole and the sharded
    kernels empty between steps (a step gathers them, then frees them)."""

    frontend: LearnedFrontend
    optimizer: torch.optim.Optimizer
    step: int
    shards: dict  # parameter name -> nn.Parameter, this rank's slice
    placements: dict  # parameter name -> Replicate() or Shard(dim) (parallel.param_shardings)
    mesh: Any


class ShardedTrainStep:
    """:func:`train_step` over a mesh. Called on every rank with the same
    state and global batch, it takes the rank's slice of the batch on
    'data', gathers the sharded kernels over 'model' (the bf16 working
    copies are built from them afresh under autograd), divides each loss
    term's local sum by its count over the whole batch, and reduces the
    gradients: a sharded kernel's by a reduce-scatter over 'model' (each
    model rank computed the same gradient, so the sum is divided by
    ``model``) and a sum over 'data'; a replicated parameter's by a sum
    over all ranks divided by ``model``. Then AdamW updates the shards and
    the replicated parameters; the metrics are the global batch's."""

    def __init__(self, mesh, cfg: TrainConfig):
        self.mesh, self.cfg = mesh, cfg
        self.data, self.model = mesh.size(0), mesh.size(1)
        self.data_rank = mesh.get_local_rank("data")
        self.data_group, self.model_group = mesh.get_group("data"), mesh.get_group("model")

    def _global_count(self, count: torch.Tensor) -> torch.Tensor:
        count = count.clone()
        dist.all_reduce(count, group=self.data_group)
        return count

    def local_batch(self, batch: TrainingBatch, device) -> TrainingBatch:
        B = batch.valid0.shape[0]
        if B % self.data:
            raise ValueError(f"batch of {B} not divisible by the data axis {self.data}")
        b = B // self.data
        return TrainingBatch(*(t[self.data_rank * b:(self.data_rank + 1) * b].to(device) for t in batch))

    def gather(self, st: ShardedTrainState) -> None:
        """Each sharded kernel of ``st.frontend`` whole, from the shards of
        its model peers (one all-gather for all of them)."""
        if not st.shards:
            return
        params = dict(st.frontend.named_parameters())
        local = torch.cat([sh.detach().reshape(-1) for sh in st.shards.values()])
        out = local.new_empty(self.model * local.numel())
        dist.all_gather_into_tensor(out, local, group=self.model_group)
        out = out.view(self.model, -1)
        off = 0
        for name, sh in st.shards.items():
            k = sh.numel()
            params[name].data = torch.cat([out[r, off:off + k].view(sh.shape) for r in range(self.model)],
                                          dim=st.placements[name].dim)
            off += k

    def release(self, st: ShardedTrainState) -> None:
        params = dict(st.frontend.named_parameters())
        for name in st.shards:
            params[name].data = params[name].data.new_empty(0)
            params[name].grad = None

    def _reduce_gradients(self, st: ShardedTrainState) -> None:
        params = dict(st.frontend.named_parameters())
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        rep = [p for name, p in params.items() if name not in st.shards]
        flat = torch.cat([p.grad.reshape(-1) for p in rep])
        dist.all_reduce(flat)  # every rank: the data ranks' sum, model times over
        flat /= self.model
        off = 0
        for p in rep:
            p.grad.copy_(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        if not st.shards:
            return
        send = torch.cat([params[name].grad.chunk(self.model, st.placements[name].dim)[r].reshape(-1)
                          for r in range(self.model) for name in st.shards])
        recv = send.new_empty(send.numel() // self.model)
        dist.reduce_scatter_tensor(recv, send, group=self.model_group)
        dist.all_reduce(recv, group=self.data_group)
        recv /= self.model
        off = 0
        for sh in st.shards.values():
            sh.grad = recv[off:off + sh.numel()].view(sh.shape).clone()
            off += sh.numel()

    def backward(self, st: ShardedTrainState, batch: TrainingBatch, of=None) -> dict:
        """The global batch's metrics; the reduced gradients of the total
        loss (or of ``of(metrics)``) left on the shards and the replicated
        parameters."""
        fe = st.frontend
        dev = next(p.device for p in fe.parameters())
        local = self.local_batch(batch, dev)
        self.gather(st)
        fe.zero_grad(set_to_none=True)
        try:
            total, metrics = loss_fn(fe, local, self.cfg, global_count=self._global_count)
            (total if of is None else of(metrics)).backward()
            self._reduce_gradients(st)
        finally:
            self.release(st)
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(vals, group=self.data_group)
        return dict(zip(keys, vals.unbind()))

    def gradients(self, st: ShardedTrainState, batch: TrainingBatch, of=None) -> tuple[dict, dict]:
        """(metrics, whole gradients by parameter name) of one step, without
        the update: the gradients the step would apply."""
        metrics = self.backward(st, batch, of)
        grads = {name: p.grad for name, p in st.frontend.named_parameters() if name not in st.shards}
        grads.update(self.gather_tensors(st, {name: sh.grad for name, sh in st.shards.items()}))
        return metrics, grads

    def gather_tensors(self, st: ShardedTrainState, slices: dict) -> dict:
        """Whole tensors from each rank's slices (keyed as ``st.shards``)."""
        out = {}
        for name, sl in slices.items():
            buf = sl.new_empty(self.model * sl.numel())
            dist.all_gather_into_tensor(buf, sl.contiguous().reshape(-1), group=self.model_group)
            out[name] = torch.cat(list(buf.view(self.model, *sl.shape).unbind()), dim=st.placements[name].dim)
        return out

    def parameters(self, st: ShardedTrainState) -> dict:
        """Every parameter whole, by name (the sharded ones gathered)."""
        full = {name: p.detach() for name, p in st.frontend.named_parameters() if name not in st.shards}
        full.update(self.gather_tensors(st, {name: sh.detach() for name, sh in st.shards.items()}))
        return full

    def __call__(self, st: ShardedTrainState, batch: TrainingBatch):
        metrics = self.backward(st, batch)
        st.optimizer.step()
        return st._replace(step=st.step + 1), metrics


def make_sharded_train_step(mesh, state: TrainState, cfg: TrainConfig):
    """(step, sharded_state): :func:`train_step` with explicit data/tensor
    parallelism on ``mesh`` (train/trainer.py:299-329). ``state`` (whole,
    on this rank's device, left as it is) is split by
    ``parallel.param_shardings``: each shardable kernel and its AdamW
    moments keep this rank's ``1/model`` slice, the rest is replicated, and
    the step count is replicated. ``step(sharded_state, batch)`` takes the
    global batch, split on its leading axis over 'data'."""
    from torch.distributed.tensor import Shard

    from forest_slam_tpu_torch.parallel.mesh import param_shardings

    placements = param_shardings(state.frontend, mesh)
    model, m = mesh.size(1), mesh.get_local_rank("model")
    src = dict(state.frontend.named_parameters())
    fe = copy.deepcopy(state.frontend)
    shards, masters, carried = {}, [], []
    for name, p in fe.named_parameters():
        old = state.optimizer.state.get(src[name], {})
        if isinstance(placements[name], Shard):
            dim = placements[name].dim
            master = nn.Parameter(p.detach().chunk(model, dim)[m].clone())
            shards[name] = master
            carried.append({k: v.clone() if k == "step" else v.chunk(model, dim)[m].clone() for k, v in old.items()})
            p.data = p.data.new_empty(0)
        else:
            master = p
            carried.append({k: v.clone() for k, v in old.items()})
        masters.append(master)
    opt = make_optimizer(masters, cfg)
    for master, st in zip(masters, carried):
        if st:
            opt.state[master] = st
    sharded = ShardedTrainState(frontend=fe, optimizer=opt, step=state.step, shards=shards, placements=placements,
                                mesh=mesh)
    return ShardedTrainStep(mesh, cfg), sharded


class BlurDraws(NamedTuple):
    """A view's blur draws: which images, their region share and angle (on
    the host, so choosing needs no read-back), and the region seeds."""

    selected: torch.Tensor  # (B,) bool, CPU
    percentage: torch.Tensor  # (B,) in [0.25, 0.75), CPU
    angle: torch.Tensor  # (B,) degrees in [0, 180), CPU
    seeds: torch.Tensor  # (B, H, W) uniform [0, 1) on the images' device


def blur_draws(gen, host_gen, shape, fraction: float, device="cuda") -> BlurDraws:
    B = shape[0]
    return BlurDraws(selected=torch.rand(B, generator=host_gen) < fraction,
                     percentage=0.25 + 0.5 * torch.rand(B, generator=host_gen),
                     angle=180.0 * torch.rand(B, generator=host_gen),
                     seeds=torch.rand(tuple(shape), generator=gen, device=device))


def blur_images(images: torch.Tensor, draws: BlurDraws, kernel_size: int = 15) -> torch.Tensor:
    """The reference corruptor's random-region motion blur on the selected
    images: pixels seed with probability ``percentage``, a SAME k x k
    maximum grows them into regions, which take the blurred values."""
    out = images.clone()
    for i in torch.nonzero(draws.selected).flatten().tolist():
        seeds = (draws.seeds[i] < float(draws.percentage[i])).float()
        mask = maxpool2d_same(seeds, kernel_size)
        blurred = apply_motion_blur(images[i], kernel_size, float(draws.angle[i]))
        out[i] = torch.where(mask > 0, blurred, images[i])
    return out


def blur_training_batch(batch: TrainingBatch, cfg: TrainConfig, gen, host_gen) -> TrainingBatch:
    """Blur a ``cfg.blur_fraction`` share of both views, independent draws;
    labels untouched (blur moves no pixels)."""
    dev = batch.image0.device
    views = [blur_images(im, blur_draws(gen, host_gen, im.shape, cfg.blur_fraction, dev), cfg.blur_kernel)
             for im in (batch.image0, batch.image1)]
    return batch._replace(image0=views[0], image1=views[1])


def train(cfg: TrainConfig, n_steps: int, seed: int = 0, log_every: int = 50, state: TrainState | None = None,
          device="cuda", corridor_pool: TrainingBatch | None = None, verbose: bool = True):
    """Single-device training loop: (state, history of (step, metrics) for
    every step). Batches, the corridor pool (unless one is given) and the
    blur seeds are drawn on ``device`` from one generator seeded with
    ``seed``; the host reads the metrics back in one transfer every
    ``log_every`` steps and at the last, and nowhere else."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    host_gen = torch.Generator()
    host_gen.manual_seed(seed)
    if state is None:
        state = create_train_state(cfg, seed, dev)
    pool = corridor_pool
    if pool is None and cfg.corridor_fraction > 0 and cfg.corridor_pool_size > 0:
        t0 = time.time()
        pool = make_corridor_pool(gen, cfg.corridor_pool_size, cfg.height, cfg.width, cfg.max_corners,
                                  scene=cfg.corridor_scene, forest_share=cfg.forest_share,
                                  min_forward=cfg.corridor_min_forward, max_forward=cfg.corridor_max_forward,
                                  device=dev)
        float(pool.image0[-1, ::37, ::37].sum())  # the render is done when this value is back
        if verbose:
            print(f"# corridor pool: {pool.image0.shape[0]} pairs ready in {time.time() - t0:.1f}s", file=sys.stderr,
                  flush=True)
    history, pending = [], []
    t_run = time.time()
    for i in range(n_steps):
        batch = make_training_batch(gen, cfg.batch_size, cfg.height, cfg.width, cfg.max_corners,
                                    cfg.texture_fraction, cfg.corridor_fraction, pool, dev)
        if cfg.blur_fraction > 0:
            batch = blur_training_batch(batch, cfg, gen, host_gen)
        state, metrics = train_step(state, batch, cfg)
        pending.append(metrics)
        if (i + 1) % log_every == 0 or i + 1 == n_steps:
            keys = list(metrics)
            rows = torch.stack([torch.stack([m[k] for k in keys]) for m in pending]).tolist()
            history += [(i + 1 - len(rows) + j, dict(zip(keys, r))) for j, r in enumerate(rows)]
            pending = []
            if verbose:
                m = history[-1][1]
                print(f"# step {i + 1}/{n_steps} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                      + f" ({(i + 1) / max(time.time() - t_run, 1e-9):.1f} steps/s)", file=sys.stderr, flush=True)
    return state, history
