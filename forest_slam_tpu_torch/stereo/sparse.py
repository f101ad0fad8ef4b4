"""Sparse per-keypoint stereo matching (port of stereo/sparse.py).

For each keypoint: SAD over a w x w window of the x-Sobel-prefiltered left
image against the D candidate windows along the same row of the right image,
winner-take-all, a best/second-best uniqueness gate and a parabola for the
sub-pixel disparity. Batched over frames: images (B, H, W), keypoints
(B, K, 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forest_slam_tpu_torch.stereo.sparse_kernel import (
    sparse_cost_rows,
    sparse_cost_rows_plain,
)
from forest_slam_tpu_torch.utils.filters import sobel


class SparseStereoConfig(NamedTuple):
    num_disparities: int = 96
    window: int = 7  # SAD window (odd)
    prefilter_cap: float = 31.0
    max_cost_ratio: float = 0.8  # best/second-best uniqueness gate
    subpixel: bool = True
    # "auto": the CUDA kernel for CUDA tensors (its plain version on CPU);
    # "plain": the plain version on any device.
    cost_path: str = "auto"


def prefilter(img: torch.Tensor, cap: float) -> torch.Tensor:
    """x-Sobel clipped to [-cap, cap] (stereo/disparity.py:_prefilter)."""
    gx, _ = sobel(img.float())
    return torch.clamp(gx * 0.25, -cap, cap)


def sparse_disparity_at_keypoints(left, right, xy, cfg: SparseStereoConfig = SparseStereoConfig()):
    """((B, K) float32 disparity, (B, K) bool validity) for (B, K, 2)
    keypoints on (B, H, W) images."""
    B, H, W = left.shape
    pl = prefilter(left, cfg.prefilter_cap).contiguous()
    pr = prefilter(right, cfg.prefilter_cap).contiguous()
    # round, not floor: keypoints may be fractional (sub-pixel readouts)
    xi = torch.round(xy[..., 0]).to(torch.int32).contiguous()
    yi = torch.round(xy[..., 1]).to(torch.int32).contiguous()
    if cfg.cost_path == "plain":
        cost = sparse_cost_rows_plain(pl, pr, xi, yi, cfg.num_disparities, cfg.window)
    elif cfg.cost_path == "auto":
        cost = sparse_cost_rows(pl, pr, xi, yi, cfg.num_disparities, cfg.window)
    else:
        raise ValueError(f"unknown cost_path {cfg.cost_path!r}")
    return decide_from_cost(cost, xi, yi, H, W, cfg)


def decide_from_cost(cost, xi, yi, H: int, W: int, cfg: SparseStereoConfig):
    """(B, K, D) SAD cost -> (disp, valid): winner-take-all, uniqueness gate,
    sub-pixel parabola and bounds masks (stereo/sparse.py:_decide_from_cost)."""
    D = cfg.num_disparities
    r = cfg.window // 2
    ds = torch.arange(D, device=cost.device)
    max_cost = 2.0 * cfg.prefilter_cap * cfg.window * cfg.window
    xi = xi.long()
    yi = yi.long()
    in_range = (xi[..., None] - ds) >= r
    cost = torch.where(in_range, cost, torch.full_like(cost, max_cost))

    best_cost = cost.min(dim=-1).values
    best = torch.argmin(cost, dim=-1)  # first minimum, as jnp.argmin
    near = (ds - best[..., None]).abs() <= 1
    second = torch.where(near, torch.full_like(cost, max_cost), cost).min(dim=-1).values
    unique = best_cost < cfg.max_cost_ratio * second

    b = best.clamp(1, D - 2)
    cm = cost.gather(-1, (b - 1)[..., None])[..., 0]
    cc = cost.gather(-1, b[..., None])[..., 0]
    cp = cost.gather(-1, (b + 1)[..., None])[..., 0]
    denom = cm - 2 * cc + cp
    offset = torch.where(
        denom > 1e-6, torch.clamp((cm - cp) / (2 * denom), -0.5, 0.5), torch.zeros_like(denom)
    )
    disp = best.float() + (offset if cfg.subpixel else 0.0)

    valid = (
        unique
        & (best >= 1)
        & (best <= D - 2)
        & (xi >= r)
        & (xi < W - r)
        & (yi >= r)
        & (yi < H - r)
        & (best_cost < max_cost)
    )
    return disp, valid


def sparse_depth_at_keypoints(left, right, xy, fx, baseline, cfg: SparseStereoConfig = SparseStereoConfig()):
    """((B, K) depth, (B, K) validity) via sparse matching."""
    disp, valid = sparse_disparity_at_keypoints(left, right, xy, cfg)
    depth = fx * baseline / torch.clamp(disp, min=0.1)
    return depth, valid & (disp > 0.1)
