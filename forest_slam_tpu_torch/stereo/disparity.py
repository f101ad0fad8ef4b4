"""Semi-global matching (SGM) disparity (port of stereo/disparity.py),
batched over frames.

The reference's ``cv2.StereoSGBM_create(numDisparities=96, blockSize=7,
P1=8*49, P2=32*49, MODE_SGBM_3WAY)`` as the JAX package computes it:

- matching cost: SAD over a 7x7 window of x-Sobel prefiltered intensities,
  for all disparities at once as a (B, H, W, D) volume (disparity minor);
  columns x < d take the maximum cost;
- aggregation: the SGM recurrence along four directions. Each scan is a
  Python loop over the scan axis whose step works on whole lines, across
  every frame, line and disparity at once; the two directions of an axis
  run in the same loop, stacked;
- winner-take-all (first index on ties), parabola sub-pixel offset,
  validity and uniqueness rules; invalid pixels are -1. No left-right
  check is made, as in the reference, so the config has no field for one.

On integer-valued images every quantity up to the winner-take-all is a
multiple of 0.25 well below 2^22, so the sums are exact in any order and
the integer disparity equals the reference's on every pixel. This is plain
PyTorch: the reference computes SGM in XLA, with no TPU kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.stereo.sparse import prefilter


class SgmConfig(NamedTuple):
    num_disparities: int = 96  # stereo_slam.py:109
    block_size: int = 7
    p1: float = 8.0 * 7 * 7
    p2: float = 32.0 * 7 * 7
    prefilter_cap: float = 31.0
    uniqueness_ratio: float = 0.0  # OpenCV create() default: disabled
    subpixel: bool = True


def _box_sum(vol: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """SAME zero-padded sum of ``size`` taps along ``dim``, taps in order."""
    lo = (size - 1) // 2
    n = vol.shape[dim]
    pad = [0, 0] * (vol.dim() - 1 - dim) + [lo, size - 1 - lo]
    p = F.pad(vol, pad)
    out = p.narrow(dim, 0, n).clone()
    for i in range(1, size):
        out.add_(p.narrow(dim, i, n))
    return out


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg: SgmConfig = SgmConfig()) -> torch.Tensor:
    """(B, H, W, D) SAD cost of (B, H, W) frames: disparity d matches
    left(x) with right(x - d); columns x < d hold the maximum cost."""
    W = left.shape[-1]
    D, b = cfg.num_disparities, cfg.block_size
    pl = prefilter(left, cfg.prefilter_cap)
    pr = prefilter(right, cfg.prefilter_cap)
    # win[..., x, j] = pr[x + j - (D - 1)], zeros left of the image; j = D-1-d
    win = F.pad(pr, (D - 1, 0)).unfold(-1, D, 1)
    ad = (pl[..., None] - win.flip(-1)).abs_()
    c = _box_sum(_box_sum(ad, b, 1), b, 2)
    xs = torch.arange(W, device=left.device)[:, None]
    ds = torch.arange(D, device=left.device)[None, :]
    return c.masked_fill_(xs < ds, 2.0 * cfg.prefilter_cap * b * b)


def _scan(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Aggregate (L, N, D) costs along axis 0 (L the scan length, N lines):
    L(p, d) = C(p, d) + min(Lp(d), Lp(d +- 1) + P1, min Lp + P2) - min Lp.
    The aggregate is kept with an inf column on each side of D, so a
    step's neighbours Lp(d +- 1) are two slices of the previous row."""
    L, N, D = cost.shape
    agg = torch.empty((L, N, D + 2), dtype=cost.dtype, device=cost.device)
    agg[..., 0] = agg[..., -1] = float("inf")
    agg[0, :, 1:-1] = cost[0]
    for i in range(1, L):
        padded = agg[i - 1]
        prev = padded[:, 1:-1]
        pm = prev.amin(-1, keepdim=True)
        # min(Lp(d+1) + P1, Lp(d-1) + P1); rounding is monotone, so one add
        side = torch.minimum(padded[:, 2:], padded[:, :-2]).add_(p1)
        m = torch.minimum(torch.minimum(prev, pm + p2), side)
        torch.sub(cost[i] + m, pm, out=agg[i, :, 1:-1])
    return agg[..., 1:-1]


def _scan_both_ways(vol: torch.Tensor, p1: float, p2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward aggregation along axis 0 of (L, ...), both in
    one loop: (forward, backward), each in ``vol``'s order."""
    L = vol.shape[0]
    agg = _scan(torch.stack([vol, vol.flip(0)], 1).reshape(L, -1, vol.shape[-1]), p1, p2)
    agg = agg.reshape(L, 2, *vol.shape[1:])
    return agg[:, 0], agg[:, 1].flip(0)


@torch.no_grad()
def sgm_disparity(left: torch.Tensor, right: torch.Tensor, cfg: SgmConfig = SgmConfig()) -> torch.Tensor:
    """Dense disparity (B, H, W) float32 of (B, H, W) rectified frames;
    invalid pixels are -1.0, the convention the reference reads after its
    ``/16`` (stereo_slam.py:117-121)."""
    W = left.shape[-1]
    D = cfg.num_disparities
    vol = cost_volume(left.float(), right.float(), cfg)  # (B, H, W, D)

    # horizontal: scan over x, lines are the frames' rows
    lr, rl = _scan_both_ways(vol.permute(2, 0, 1, 3), cfg.p1, cfg.p2)  # (W, B, H, D)
    total = (lr + rl).permute(1, 2, 0, 3)
    del lr, rl
    # vertical: scan over y, lines are the columns
    td, bu = _scan_both_ways(vol.permute(1, 0, 2, 3), cfg.p1, cfg.p2)  # (H, B, W, D)
    del vol
    total = total + td.permute(1, 0, 2, 3)
    total = total + bu.permute(1, 0, 2, 3)
    del td, bu

    best = total.argmin(-1)  # first index of the minimum, as jnp.argmin
    best_cost = total.gather(-1, best[..., None])[..., 0]

    # sub-pixel parabola
    d0 = best.clamp(1, D - 2)[..., None]
    cm = total.gather(-1, d0 - 1)[..., 0]
    cc = total.gather(-1, d0)[..., 0]
    cp = total.gather(-1, d0 + 1)[..., 0]
    denom = cm - 2.0 * cc + cp
    offset = torch.where(denom > 1e-6, torch.clamp((cm - cp) / (2.0 * denom), -0.5, 0.5), torch.zeros_like(denom))
    bf = best.float()
    disp = torch.where((best >= 1) & (best <= D - 2), bf + offset if cfg.subpixel else bf, bf)

    # validity
    xs = torch.arange(W, device=left.device)
    valid = (xs >= best) & (xs >= cfg.block_size // 2)
    if cfg.uniqueness_ratio > 0:
        # second best outside d_best +- 1
        d_idx = torch.arange(D, device=left.device)
        second = total.masked_fill((d_idx - best[..., None]).abs() <= 1, float("inf")).amin(-1)
        valid = valid & (second * (100 - cfg.uniqueness_ratio) / 100.0 >= best_cost)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))
