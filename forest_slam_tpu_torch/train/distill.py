"""Dense distillation of a trained SuperPoint into a faster stem (port of
train/distill.py), and its entry point, the ``forest-slam
distill-frontend`` command (cli.py:629-655, 774-811) with its flags and
defaults, on a CUDA card (``--device cpu`` for the CPU):

    python -m forest_slam_tpu_torch.train.distill --teacher T.msgpack --out S.msgpack

The student, a SuperPointNet at ``stem_stride``, learns the teacher's dense
outputs: the teacher's 65-way cell distribution (cross-entropy), its
descriptors (a cosine loss weighted by the teacher's keypoint-ness plus a
uniform floor) and, each behind its weight, the in-cell centre of mass of
the detector (``w_subpix``), the teacher's descriptors at the source cells
of a central zoom-in (``w_scale``) and the teacher's clean targets on a
motion-blurred view (``w_blur``). The saved checkpoint pairs the student
with the teacher's SuperGlue subtree as read.

Images are crops of a pool of corridor and forest frames rendered at the
teacher's native scale, plus the texture and corner scenes of
``train/data.py``, with photometric jitter. Every batch function takes its
random numbers as a ``*Draws`` tuple made by a ``*_draws`` function from a
``torch.Generator`` (the blur's region shares and angles from a host
generator, so no step reads the card back), and a test can hand both
packages the same numbers. :func:`distill` runs the steps in a Python loop
(the reference scans them on the device) and reads the metrics back once a
``log_every`` chunk.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.core.lie import se3_matrix, so3_exp
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, SuperPointNet, SuperPointRaw
from forest_slam_tpu_torch.frontend.weights import WEIGHTS_DIR, read_checkpoint, save_params, superpoint_from_jax, \
    superpoint_to_jax
from forest_slam_tpu_torch.train.data import (
    CornerDraws,
    TextureDraws,
    _uniform,
    corner_draws,
    corner_image,
    random_world,
    texture_draws,
    texture_image,
)
from forest_slam_tpu_torch.train.trainer import AdamW, resolve_device, superpoint_init_
from forest_slam_tpu_torch.utils.corrupt import motion_blur_kernel
from forest_slam_tpu_torch.utils.filters import map_coordinates_linear, maxpool2d_same

DEFAULT_TEACHER = os.path.join(WEIGHTS_DIR, "learned_frontend.msgpack")


class DistillConfig(NamedTuple):
    """The reference's fields and defaults (train/distill.py:48-108)."""

    teacher_path: str = DEFAULT_TEACHER
    stem_stride: int = 2
    # architecture (the teacher checkpoint's encoder)
    channels: tuple = (64, 64, 128, 128)
    descriptor_dim: int = 256
    height: int = 240  # training crop size (cells: H/8 x W/8)
    width: int = 320
    batch_size: int = 8
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    w_det: float = 1.0
    w_desc: float = 4.0
    desc_floor: float = 0.25  # uniform share of the descriptor cell weights
    # batch mix: the rest after these two are pool crops
    texture_fraction: float = 0.3
    corner_fraction: float = 0.2
    # rendered-scene pool: full frames at the teacher's native scale
    pool_frames: int = 256
    pool_height: int = 600
    pool_width: int = 960
    # photometric jitter per step
    noise_sigma: float = 2.0
    max_gain: float = 0.25  # log-uniform contrast
    max_bias: float = 16.0  # gray levels
    # cross-scale descriptor consistency on a central zoom-in; 0 disables
    w_scale: float = 2.0
    scale_min: float = 1.2
    scale_max: float = 2.0
    # blur robustness: clean-image targets on a motion-blurred view; 0 disables
    w_blur: float = 0.0
    blur_kernel: int = 15
    blur_pct_min: float = 25.0  # per-image region percentage range
    blur_pct_max: float = 75.0
    # in-cell detector centre of mass (what the com3 readout reads); 0 disables
    w_subpix: float = 0.0


class DistillState(NamedTuple):
    """The student and its optimizer (updated in place by
    :func:`distill_step`) and the number of steps taken."""

    student: SuperPointNet
    optimizer: AdamW
    step: int


def _net_config(cfg: DistillConfig, stem_stride: int) -> SuperPointConfig:
    return SuperPointConfig(stem_stride=stem_stride, channels=tuple(cfg.channels), descriptor_dim=cfg.descriptor_dim)


def load_teacher(cfg: DistillConfig, device="cuda") -> tuple[SuperPointNet, dict, dict]:
    """(teacher on ``device``, the checkpoint's whole tree, its meta). The
    teacher's stride comes from the meta; its parameters take no gradient,
    so their bf16 copies are made once. The tree keeps the SuperGlue
    subtree the distilled checkpoint writes back."""
    meta, tree = read_checkpoint(cfg.teacher_path)
    net = superpoint_from_jax(tree["superpoint"]["params"], _net_config(cfg, int(meta.get("stem_stride", 1))))
    return net.to(device).requires_grad_(False), tree, meta


def create_student_state(cfg: DistillConfig, seed: int = 0, device="cuda") -> DistillState:
    """A student at ``cfg.stem_stride``, float32 parameters drawn in Flax's
    manner on the CPU from ``seed``, and an AdamW doing ``optax.adamw``'s
    arithmetic."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    net = SuperPointNet(_net_config(cfg, cfg.stem_stride))
    superpoint_init_(net, gen)
    net = net.to(resolve_device(device))
    opt = AdamW(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return DistillState(student=net, optimizer=opt, step=0)


STATIONS_PER_WORLD = 8


def make_scene_pool(gen, cfg: DistillConfig, device="cuda") -> torch.Tensor:
    """(pool_frames, pool_H, pool_W) frames rendered on ``device``: corridor
    and forest worlds in turn (the trainer's ``random_world`` draws from
    ``gen``), eight random stations a world."""
    from forest_slam_tpu_torch.io.synthetic import default_rig, render_view

    H, W = cfg.pool_height, cfg.pool_width
    K = default_rig(H, W, device=device).left.K
    t = lambda *a: torch.tensor(a, dtype=torch.float32, device=device)
    parts = []
    for i in range(-(-cfg.pool_frames // STATIONS_PER_WORLD)):
        world = random_world(gen, "forest" if i % 2 else "corridor", device=device)
        p = _uniform(gen, (STATIONS_PER_WORLD, 3), t(-1.5, -0.4, 0.0), t(1.5, 0.4, 40.0), device)
        w = _uniform(gen, (STATIONS_PER_WORLD, 3), t(-0.08, -0.5, -0.06), t(0.08, 0.5, 0.06), device)
        parts.append(render_view(world, se3_matrix(so3_exp(w), p), K, H, W)[0])
    return torch.cat(parts)[:cfg.pool_frames]


# --- batches ---------------------------------------------------------------

class DistillBatchDraws(NamedTuple):
    """Draws of one batch: pool crops, texture and corner scenes, jitter."""

    crop_index: torch.Tensor  # (n_scene,) int64 pool frame
    crop_y: torch.Tensor  # (n_scene,) int64 top row
    crop_x: torch.Tensor  # (n_scene,) int64 left column
    texture: TextureDraws  # n_tex scenes
    corner: CornerDraws  # n_cor scenes
    log_gain: torch.Tensor  # (B,) uniform in +-max_gain
    bias: torch.Tensor  # (B,) uniform in +-max_bias
    noise: torch.Tensor  # (B, H, W) standard normal


def batch_split(cfg: DistillConfig) -> tuple[int, int, int]:
    """(scene crops, texture scenes, corner scenes) of a batch, rounded as
    the reference rounds."""
    n_tex = int(round(cfg.batch_size * cfg.texture_fraction))
    n_cor = int(round(cfg.batch_size * cfg.corner_fraction))
    return cfg.batch_size - n_tex - n_cor, n_tex, n_cor


def distill_batch_draws(gen, cfg: DistillConfig, pool_shape, device="cuda") -> DistillBatchDraws:
    n_scene, n_tex, n_cor = batch_split(cfg)
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    N, PH, PW = pool_shape
    ri = lambda hi: torch.randint(0, hi, (n_scene,), generator=gen, device=device)
    return DistillBatchDraws(
        crop_index=ri(N), crop_y=ri(PH - H + 1), crop_x=ri(PW - W + 1),
        texture=texture_draws(gen, n_tex, H, W, device), corner=corner_draws(gen, n_cor, H, W, device=device),
        log_gain=_uniform(gen, (B,), -cfg.max_gain, cfg.max_gain, device),
        bias=_uniform(gen, (B,), -cfg.max_bias, cfg.max_bias, device),
        noise=torch.randn((B, H, W), generator=gen, device=device),
    )


def distill_batch(draws: DistillBatchDraws, cfg: DistillConfig, pool: torch.Tensor) -> torch.Tensor:
    """One (B, H, W) image batch: pool crops, then texture scenes, then
    corner scenes, under gain, bias and pixel noise, clipped to [0, 255]."""
    H, W = cfg.height, cfg.width
    dev = pool.device
    parts = []
    if draws.crop_index.numel():
        rows = draws.crop_y[:, None, None] + torch.arange(H, device=dev)[None, :, None]
        cols = draws.crop_x[:, None, None] + torch.arange(W, device=dev)[None, None, :]
        parts.append(pool[draws.crop_index[:, None, None], rows, cols])
    if draws.texture.fine.shape[0]:
        parts.append(texture_image(draws.texture, H, W))
    if draws.corner.bg.shape[0]:
        parts.append(corner_image(draws.corner, H, W))
    imgs = torch.cat(parts)
    gain = torch.exp(draws.log_gain)[:, None, None]
    return torch.clamp((imgs - 127.5) * gain + 127.5 + draws.bias[:, None, None] + draws.noise * cfg.noise_sigma,
                       0, 255)


def zoom_draws(gen, cfg: DistillConfig, device="cuda") -> torch.Tensor:
    """(B,) zoom ratios, uniform in [scale_min, scale_max)."""
    return _uniform(gen, (cfg.batch_size,), cfg.scale_min, cfg.scale_max, device)


def _centre_grid(H: int, W: int, device):
    return torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")


def zoom_batch(images: torch.Tensor, ratios: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (H, W) image zoomed in about its centre by its ratio, bilinear
    and clamped to the edge on the same canvas: (zoomed (B, H, W), ratios),
    what the scene looks like that many times closer."""
    B, H, W = images.shape
    yy, xx = _centre_grid(H, W, images.device)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    s = ratios[:, None, None]
    return map_coordinates_linear(images, cy + (yy - cy) / s, cx + (xx - cx) / s), ratios


def sample_cells_at_zoom(grid: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample a (B, Hc, Wc, C) cell grid of the source image at
    the source positions of the zoomed image's cell centres: cell (i, j)
    covers pixels [8i, 8i + 8), so its centre is 8i + 3.5."""
    B, Hc, Wc, _ = grid.shape
    H, W = Hc * 8, Wc * 8
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = _centre_grid(Hc, Wc, grid.device)
    yy, xx = yy * 8.0 + 3.5, xx * 8.0 + 3.5
    s = ratios[:, None, None]
    return map_coordinates_linear(grid, (cy + (yy - cy) / s - 3.5) / 8.0, (cx + (xx - cx) / s - 3.5) / 8.0)


class BlurBatchDraws(NamedTuple):
    """A batch's blur draws: each image's region share and angle (on the
    host, so building the kernels reads nothing back) and its region seeds."""

    percentage: torch.Tensor  # (B,) in [blur_pct_min, blur_pct_max) / 100, CPU
    angle: torch.Tensor  # (B,) degrees in [0, 180), CPU
    seeds: torch.Tensor  # (B, H, W) uniform [0, 1) on the images' device


def blur_batch_draws(gen, host_gen, cfg: DistillConfig, device="cuda") -> BlurBatchDraws:
    B = cfg.batch_size
    lo, hi = cfg.blur_pct_min / 100.0, cfg.blur_pct_max / 100.0
    return BlurBatchDraws(percentage=lo + (hi - lo) * torch.rand(B, generator=host_gen),
                          angle=180.0 * torch.rand(B, generator=host_gen),
                          seeds=torch.rand((B, cfg.height, cfg.width), generator=gen, device=device))


def blur_batch(images: torch.Tensor, draws: BlurBatchDraws, kernel_size: int) -> torch.Tensor:
    """The reference corruptor's random-region motion blur, each image its
    own line kernel: pixels seed with the image's probability, a SAME
    k x k maximum grows them into regions, which take the blurred values.
    The B kernels are built on the host; each tap of their union is one
    shifted slice of the batch times each image's weight there (zero where
    its kernel has none), summed in the taps' order as
    ``utils/corrupt.py:apply_motion_blur`` sums one kernel."""
    B, H, W = images.shape
    dev = images.device
    kernels = torch.stack([motion_blur_kernel(kernel_size, a) for a in draws.angle.tolist()])  # (B, k, k)
    taps = torch.nonzero(kernels.ne(0).any(0)).tolist()
    weights = kernels[:, [t[0] for t in taps], [t[1] for t in taps]].t().contiguous().to(dev)  # (T, B)
    r = (kernel_size - 1) // 2
    p = F.pad(images.float(), (r, kernel_size - 1 - r, r, kernel_size - 1 - r))
    blurred = torch.zeros_like(images, dtype=torch.float32)
    for (dy, dx), w in zip(taps, weights):
        blurred = blurred + p[:, dy:dy + H, dx:dx + W] * w[:, None, None]
    seeds = (draws.seeds < draws.percentage.to(dev)[:, None, None]).float()
    return torch.where(maxpool2d_same(seeds, kernel_size) > 0, blurred, images)


# --- loss and step -----------------------------------------------------------

def _cell_com(logits: torch.Tensor) -> torch.Tensor:
    """In-cell centre of mass (x, y) of the 64 position bins, in pixels."""
    pos = torch.arange(64, device=logits.device)
    p = torch.softmax(logits[..., :64], dim=-1)
    return torch.stack([(p * (pos % 8).float()).sum(-1), (p * (pos // 8).float()).sum(-1)], dim=-1)


def distill_loss(student: SuperPointNet, teacher_out: SuperPointRaw, images: torch.Tensor, cfg: DistillConfig,
                 zoom=None, blurred=None):
    """(total loss, metrics) of the student against the teacher's raw
    outputs on ``images``. ``zoom`` is ``(zoomed images, ratios)`` from
    :func:`zoom_batch`, ``blurred`` the images from :func:`blur_batch`."""
    s = student(images / 255.0)
    t_logits = teacher_out.det_logits.detach()
    t_desc = teacher_out.coarse_desc.detach()
    t_probs = torch.softmax(t_logits, dim=-1)  # (B, Hc, Wc, 65)

    # detector: CE against the teacher's whole 65-way cell distribution
    l_det = -(t_probs * torch.log_softmax(s.det_logits, dim=-1)).sum(-1).mean()
    # descriptors: cosine loss, keypoint-ness weighted cells + a uniform floor
    cos = (s.coarse_desc * t_desc).sum(-1)
    kp = 1.0 - t_probs[..., 64]
    kp = kp / torch.clamp(kp.mean(), min=1e-6)
    w = cfg.desc_floor + (1.0 - cfg.desc_floor) * kp
    l_desc = (w * (1.0 - cos)).mean()
    total = cfg.w_det * l_det + cfg.w_desc * l_desc
    metrics = {"det": l_det, "desc": l_desc, "cos_kp": (kp * cos).sum() / torch.clamp(kp.sum(), min=1e-6)}

    if cfg.w_subpix > 0:
        com_err = ((_cell_com(s.det_logits) - _cell_com(t_logits)) ** 2).sum(-1)  # px^2
        l_subpix = (w * com_err).mean()
        total = total + cfg.w_subpix * l_subpix
        metrics["subpix"] = l_subpix

    if zoom is not None:
        images_z, ratios = zoom
        s_z = student(images_z / 255.0)
        t_desc_z = sample_cells_at_zoom(t_desc, ratios).detach()
        # bilinear blends of unit vectors are shorter than one: renormalise
        t_desc_z = t_desc_z / torch.clamp(torch.linalg.vector_norm(t_desc_z, dim=-1, keepdim=True), min=1e-6)
        kp_z = sample_cells_at_zoom(kp[..., None], ratios)[..., 0].detach()
        kp_z = kp_z / torch.clamp(kp_z.mean(), min=1e-6)
        w_z = cfg.desc_floor + (1.0 - cfg.desc_floor) * kp_z
        l_scale = (w_z * (1.0 - (s_z.coarse_desc * t_desc_z).sum(-1))).mean()
        total = total + cfg.w_scale * l_scale
        metrics["scale"] = l_scale

    if blurred is not None:
        s_b = student(blurred / 255.0)
        l_bdet = -(t_probs * torch.log_softmax(s_b.det_logits, dim=-1)).sum(-1).mean()
        l_bdesc = (w * (1.0 - (s_b.coarse_desc * t_desc).sum(-1))).mean()
        l_blur = l_bdet + cfg.w_desc / cfg.w_det * l_bdesc if cfg.w_det > 0 else l_bdesc
        total = total + cfg.w_blur * l_blur
        metrics["blur"] = l_blur

    metrics["loss"] = total
    return total, metrics


def step_inputs(gen, host_gen, cfg: DistillConfig, pool: torch.Tensor):
    """One step's (images, zoom, blurred), drawn from ``gen`` (the blur's
    shares and angles from ``host_gen``) on the pool's device; ``zoom`` and
    ``blurred`` are None where their term is off, and then take no draw."""
    dev = pool.device
    images = distill_batch(distill_batch_draws(gen, cfg, pool.shape, dev), cfg, pool)
    zoom = zoom_batch(images, zoom_draws(gen, cfg, dev)) if cfg.w_scale > 0 else None
    blurred = blur_batch(images, blur_batch_draws(gen, host_gen, cfg, dev), cfg.blur_kernel) if cfg.w_blur > 0 else None
    return images, zoom, blurred


def teacher_outputs(teacher: SuperPointNet, images: torch.Tensor) -> SuperPointRaw:
    """The teacher's raw outputs on ``images``, without a graph."""
    with torch.no_grad():
        return teacher(images / 255.0)


def distill_step(state: DistillState, teacher: SuperPointNet, images: torch.Tensor, cfg: DistillConfig, zoom=None,
                 blurred=None):
    """The teacher's outputs without a graph, the student's one to three
    forwards and gradients, one AdamW update: (state with step + 1,
    detached metrics)."""
    net, opt = state.student, state.optimizer
    opt.zero_grad(set_to_none=True)
    total, metrics = distill_loss(net, teacher_outputs(teacher, images), images, cfg, zoom, blurred)
    total.backward()
    opt.step()
    return state._replace(step=state.step + 1), {k: v.detach() for k, v in metrics.items()}


def distill(cfg: DistillConfig, n_steps: int, seed: int = 0, log_every: int = 100, state: DistillState | None = None,
            pool: torch.Tensor | None = None, teacher: tuple | None = None, verbose: bool = False, device="cuda"):
    """Distil ``n_steps`` steps on ``device``: (state, history, payload).
    ``history`` holds (step, metrics) of the last step of each ``log_every``
    chunk, as the reference's scan returns them; ``payload`` is the
    checkpoint tree: the student and the teacher's SuperGlue subtree.
    ``teacher`` is :func:`load_teacher`'s (net, tree, meta), read from
    ``cfg.teacher_path`` when not given. The pool (unless one is given) and
    every batch are drawn from one generator seeded with ``seed``, the
    blur's shares and angles from a host one."""
    dev = resolve_device(device)
    teacher, tree, _ = teacher if teacher is not None else load_teacher(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    host_gen = torch.Generator()
    host_gen.manual_seed(seed)
    if state is None:
        state = create_student_state(cfg, seed, dev)
    if pool is None:
        t0 = time.time()
        pool = make_scene_pool(gen, cfg, dev)
        if verbose:
            float(pool[-1, ::37, ::37].sum())  # the render is done when this value is back
            print(f"# scene pool: {pool.shape[0]} frames @ {pool.shape[2]}x{pool.shape[1]} in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    history = []
    t_run = time.time()
    for i in range(n_steps):
        images, zoom, blurred = step_inputs(gen, host_gen, cfg, pool)
        state, metrics = distill_step(state, teacher, images, cfg, zoom, blurred)
        if (i + 1) % log_every == 0 or i + 1 == n_steps:
            history.append((i, dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))))
            if verbose:
                print(f"# step {i + 1}/{n_steps} " + " ".join(f"{k}={v:.4f}" for k, v in history[-1][1].items())
                      + f" ({(i + 1) / max(time.time() - t_run, 1e-9):.1f} steps/s)", file=sys.stderr, flush=True)
    payload = {"superpoint": {"params": superpoint_to_jax(state.student)}, "superglue": tree["superglue"]}
    return state, history, payload


def save_distilled(payload: dict, cfg: DistillConfig, path: str, teacher_meta: dict) -> None:
    """Write the distilled checkpoint with the teacher's meta, the loader's
    defaults for SuperGlue's depth and iterations where the teacher has
    none, and the student's stem stride."""
    meta = dict(teacher_meta)
    meta.setdefault("gnn_layers", 9)
    meta.setdefault("sinkhorn_iterations", 20)
    meta["stem_stride"] = cfg.stem_stride
    save_params(payload, path, meta=meta)


# --- entry point ---------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m forest_slam_tpu_torch.train.distill",
                                description="Distil a trained SuperPoint into a faster stem, keeping the teacher's "
                                            "SuperGlue.")
    add_arguments(p)
    return p


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The flags of ``distill-frontend`` (here and in cli.py)."""
    p.add_argument("--teacher", default=None,
                   help=f"teacher checkpoint (default {os.path.relpath(DEFAULT_TEACHER)}, the stride-1 one)")
    p.add_argument("--out", required=True, help="output .msgpack")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--stem-stride", type=int, default=2, choices=(2, 4, 8))
    p.add_argument("--pool-frames", type=int, default=256, help="rendered corridor/forest frames in the crop pool")
    p.add_argument("--pool-height", type=int, default=600, help="pool render rows (the teacher's native scale)")
    p.add_argument("--pool-width", type=int, default=960)
    p.add_argument("--w-scale", type=float, default=2.0,
                   help="cross-scale descriptor-consistency weight (0 disables the zoom term)")
    p.add_argument("--w-blur", type=float, default=0.0,
                   help="blur-robustness weight: the teacher's clean targets on motion-blurred views (0 disables)")
    p.add_argument("--w-subpix", type=float, default=0.0,
                   help="weight of the in-cell detector centre of mass against the teacher's (0 disables)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


def run(args) -> int:
    """Distil by the parsed flags and write the checkpoint."""
    cfg = DistillConfig(
        teacher_path=args.teacher or DEFAULT_TEACHER, stem_stride=args.stem_stride, height=args.height,
        width=args.width, batch_size=args.batch, learning_rate=args.lr, pool_frames=args.pool_frames,
        pool_height=args.pool_height, pool_width=args.pool_width, w_scale=args.w_scale, w_blur=args.w_blur,
        w_subpix=args.w_subpix,
    )
    teacher = load_teacher(cfg, resolve_device(args.device))
    _, history, payload = distill(cfg, args.steps, seed=args.seed, log_every=args.log_every, teacher=teacher,
                                  verbose=True, device=args.device)
    for step, m in history:
        print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    save_distilled(payload, cfg, args.out, teacher[2])
    print(f"saved distilled weights -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
