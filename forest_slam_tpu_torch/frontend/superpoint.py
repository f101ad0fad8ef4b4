"""SuperPoint-style keypoint detector + descriptor network (port of
frontend/superpoint.py).

A VGG encoder (optionally behind a space-to-depth stem), a 65-channel
detector head (8x8 cells + dustbin) and a 256-d descriptor head. Keypoint
selection is NMS pooled per 4x4 block (the select kernel, ``select_kernel.py``)
+ exact top-k into fixed ``max_keypoints`` slots with a validity mask, then
bilinear descriptor sampling on the coarse grid. Images
are (B, H, W) in [0, 1] for the network. The convolutions keep float32
master weights and run in ``cfg.dtype``: kernel and bias cast to it, the
bias added after the output is rounded, as flax.linen.Conv does. The cast
copies are made once per parameter version outside autograd
(``params.cached_copy``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from forest_slam_tpu_torch.frontend.fast import top_k
from forest_slam_tpu_torch.frontend.params import cached_copy
from forest_slam_tpu_torch.frontend.select_kernel import BLOCK, BORDER, nms_block_max, nms_block_max_plain, nms_kept_plain
from forest_slam_tpu_torch.utils.filters import conv2d_separable


class SuperPointConfig(NamedTuple):
    nms_radius: int = 4
    keypoint_threshold: float = 0.005
    max_keypoints: int = 1024
    descriptor_dim: int = 256
    channels: tuple = (64, 64, 128, 128)
    dtype: torch.dtype = torch.bfloat16
    stem_stride: int = 1
    desc_sample_dtype: torch.dtype = torch.bfloat16
    subpixel: str = "none"  # "none", "com3" or "com5"
    # NMS + block pooling: "auto" launches the select kernel for CUDA heat
    # (its plain version for CPU heat); "plain" takes the plain version on
    # any device. Shapes off the block path take the dense top-k either way.
    nms_backend: str = "auto"


class SuperPointFeatures(NamedTuple):
    """Fixed-size keypoint sets, batched. Invalid slots: valid=False."""

    xy: torch.Tensor  # (B, K, 2) float32 pixel coords (x, y)
    score: torch.Tensor  # (B, K) float32
    desc: torch.Tensor  # (B, K, D) float32, L2-normalised
    valid: torch.Tensor  # (B, K) bool


class SuperPointRaw(NamedTuple):
    heat: torch.Tensor  # (B, H, W) keypoint probability
    coarse_desc: torch.Tensor  # (B, H/8, W/8, D) L2-normalised
    det_logits: torch.Tensor  # (B, H/8, W/8, 65)


_CONVS = (
    "enc1_0", "enc1_1", "enc2_0", "enc2_1", "enc3_0", "enc3_1", "enc4_0", "enc4_1",
    "det_conv", "det_out", "desc_conv", "desc_out",
)


class SuperPointNet(nn.Module):
    """Raw network: (B, H, W) image in [0, 1] -> SuperPointRaw."""

    def __init__(self, cfg: SuperPointConfig = SuperPointConfig()):
        super().__init__()
        s = cfg.stem_stride
        if s not in (1, 2, 4, 8):
            raise ValueError(f"stem_stride must be 1/2/4/8, got {s}")
        self.cfg = cfg
        c1, c2, c3, c4 = cfg.channels
        io = {
            "enc1_0": (s * s, c1), "enc1_1": (c1, c1), "enc2_0": (c1, c2), "enc2_1": (c2, c2),
            "enc3_0": (c2, c3), "enc3_1": (c3, c3), "enc4_0": (c3, c4), "enc4_1": (c4, c4),
            "det_conv": (c4, 256), "det_out": (256, 65),
            "desc_conv": (c4, 256), "desc_out": (256, cfg.descriptor_dim),
        }
        self.convs = nn.ModuleDict({
            name: nn.Conv2d(i, o, 1 if name.endswith("_out") else 3) for name, (i, o) in io.items()
        })

    def conv_weights(self) -> dict:
        """name -> (kernel, bias) in ``cfg.dtype``."""
        dt = self.cfg.dtype
        return cached_copy(self, lambda: {n: (c.weight.to(dt), c.bias.to(dt)) for n, c in self.convs.items()})

    def forward(self, image: torch.Tensor) -> SuperPointRaw:
        cfg = self.cfg
        s = cfg.stem_stride
        weights = self.conv_weights()

        def conv(name, x):
            w, b = weights[name]
            return F.conv2d(x, w, None, padding=w.shape[-1] // 2) + b[None, :, None, None]

        B, H, W = image.shape
        x = image.to(cfg.dtype)
        if s > 1:  # space-to-depth, channel = dy * s + dx
            x = x.reshape(B, H // s, s, W // s, s).permute(0, 2, 4, 1, 3)
            x = x.reshape(B, s * s, H // s, W // s)
        else:
            x = x[:, None]
        n_pools = 3 - {1: 0, 2: 1, 4: 2, 8: 3}[s]
        for blk in range(1, 5):
            for i in range(2):
                x = torch.relu(conv(f"enc{blk}_{i}", x))
            if blk <= n_pools:
                x = F.max_pool2d(x, 2, 2)
        det = torch.relu(conv("det_conv", x))
        logits = conv("det_out", det).float()  # (B, 65, Hc, Wc)
        probs = torch.softmax(logits, dim=1)[:, :64]
        heat = F.pixel_shuffle(probs, 8)[:, 0]  # depth-to-space
        dsc = torch.relu(conv("desc_conv", x))
        dsc = conv("desc_out", dsc).float()
        dsc = dsc / torch.clamp(torch.linalg.vector_norm(dsc, dim=1, keepdim=True), min=1e-8)
        return SuperPointRaw(
            heat=heat,
            coarse_desc=dsc.permute(0, 2, 3, 1).contiguous(),
            det_logits=logits.permute(0, 2, 3, 1),
        )


def _sample_coarse_descriptors(coarse, xy, cell: int = 8, sample_dtype=None):
    """Bilinear-sample (B, Hc, Wc, D) coarse descriptors at (B, K, 2) pixel
    coords; L2-normalised float32 (B, K, D)."""
    B, Hc, Wc, D = coarse.shape
    if sample_dtype is not None:
        coarse = coarse.to(sample_dtype)
    flat = coarse.reshape(B, Hc * Wc, D)
    u = (xy[..., 0] + 0.5) / cell - 0.5
    v = (xy[..., 1] + 0.5) / cell - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.long().clamp(0, Wc - 1)
    v0 = v0.long().clamp(0, Hc - 1)
    u1 = (u0 + 1).clamp(0, Wc - 1)
    v1 = (v0 + 1).clamp(0, Hc - 1)

    def at(vv, uu):
        idx = (vv * Wc + uu)[..., None].expand(-1, -1, D)
        return flat.gather(1, idx).float()

    d = (
        at(v0, u0) * (1 - fu) * (1 - fv)
        + at(v0, u1) * fu * (1 - fv)
        + at(v1, u0) * (1 - fu) * fv
        + at(v1, u1) * fu * fv
    )
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)


def subpixel_com(heat, xy, valid, radius: int = 1):
    """Refine integer peaks of (B, H, W) heat by the (2r+1)^2 centre of mass."""
    B, H, W = heat.shape
    n = 2 * radius + 1
    k_sum = torch.ones(n)
    k_off = torch.arange(-radius, radius + 1, dtype=torch.float32)
    den = conv2d_separable(heat, k_sum, k_sum)
    num_x = conv2d_separable(heat, k_off, k_sum)
    num_y = conv2d_separable(heat, k_sum, k_off)
    xi = xy[..., 0].long().clamp(0, W - 1)
    yi = xy[..., 1].long().clamp(0, H - 1)
    flat = yi * W + xi

    def at(img):
        return img.reshape(B, H * W).gather(1, flat)

    d = torch.clamp(at(den), min=1e-12)
    off = torch.stack([at(num_x) / d, at(num_y) / d], dim=-1)
    lim = 0.5 if radius == 1 else 1.0
    return xy + torch.clamp(off, -lim, lim) * valid[..., None]


def block_path(cfg: SuperPointConfig, H: int, W: int) -> bool:
    """Selection runs over 4x4 block maxima (superpoint.py:321-326): after
    NMS of radius >= 3 a block holds at most one survivor, ties excepted."""
    b = BLOCK
    return cfg.nms_radius >= b - 1 and H % b == 0 and W % b == 0 and (H // b) * (W // b) >= cfg.max_keypoints


def select_keypoints(heat, coarse_desc, cfg: SuperPointConfig) -> SuperPointFeatures:
    """(B, H, W) heat maps -> fixed-size keypoint sets: 9x9 NMS, threshold,
    a 4 px border, exact top-k over 4x4 block maxima (superpoint.py's XLA
    path with topk_method="exact"), or over all pixels where the block path
    does not apply. Equal scores keep index order, as ``jax.lax.top_k``
    returns them (``fast.top_k``), so a tie at the K-th slot keeps the
    lower block or pixel on every device."""
    if cfg.nms_backend not in ("auto", "plain"):
        raise ValueError(f"unknown nms_backend {cfg.nms_backend!r}")
    B, H, W = heat.shape
    K = cfg.max_keypoints
    if block_path(cfg, H, W):
        pool = nms_block_max if cfg.nms_backend == "auto" else nms_block_max_plain
        bvals, bidx = pool(heat.contiguous(), cfg.nms_radius, cfg.keypoint_threshold, BORDER)
        vals, t = top_k(bvals.reshape(B, -1), K)
        idx = bidx.reshape(B, -1).gather(1, t).long()
    else:
        kept = nms_kept_plain(heat, cfg.nms_radius, cfg.keypoint_threshold, BORDER)
        vals, idx = top_k(kept.reshape(B, H * W), K)
    valid = vals > 0.0
    xy = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()], dim=-1)
    xy = xy * valid[..., None]
    if cfg.subpixel in ("com3", "com5"):
        xy = subpixel_com(heat, xy, valid, radius=1 if cfg.subpixel == "com3" else 2)
    desc = _sample_coarse_descriptors(coarse_desc, xy, sample_dtype=cfg.desc_sample_dtype)
    return SuperPointFeatures(xy=xy, score=vals, desc=desc, valid=valid)
