"""Post-match keypoint refinement by local template search (port of
frontend/refine.py).

An 8x8 template around each frame-0 keypoint is matched by SAD against a
(2R+1)^2 neighbourhood of the frame-1 estimate, with a uniqueness gate and a
parabola sub-pixel step per axis. With several ``scales``, each s != 1 runs
the search again with frame 0 upscaled by s (frame 1 stays at its own size),
and each keypoint takes the scale of lowest best/second cost ratio. Batched
over pairs: images (B, H, W), keypoints (B, K, 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from forest_slam_tpu_torch.frontend.refine_kernel import (
    refine_cost_volume,
    refine_cost_volume_plain,
)
from forest_slam_tpu_torch.utils.filters import resize_bilinear


class RefineConfig(NamedTuple):
    radius: int = 12  # search +-radius px around the matcher's estimate
    template: int = 8  # template side (even: centred on the pixel grid)
    max_cost_ratio: float = 0.9  # best/second-best uniqueness gate
    # "auto": the CUDA kernel for CUDA tensors (its plain version on CPU);
    # "plain" (or the JAX name "xla"): the plain version on any device;
    # "pallas" (the JAX name of the kernel route): the CUDA kernel, and an
    # error for CPU tensors
    cost_path: str = "auto"
    # template-to-window scale ratios searched: forward motion enlarges
    # approaching patches, so each s != 1 matches frame 0 upscaled by s
    # against frame 1 at its own resolution (refine.py:53)
    scales: tuple = (1.0,)


def _subpix(b, axis_cost, n: int):
    bc = b.clamp(1, n - 2)
    cm = axis_cost.gather(-1, (bc - 1)[..., None])[..., 0]
    cc = axis_cost.gather(-1, bc[..., None])[..., 0]
    cp = axis_cost.gather(-1, (bc + 1)[..., None])[..., 0]
    den = cm - 2 * cc + cp
    off = torch.where(den > 1e-6, torch.clamp((cm - cp) / (2 * den), -0.5, 0.5), torch.zeros_like(den))
    return torch.where((b >= 1) & (b <= n - 2), off, torch.zeros_like(off))


def _refine_single(img0, img1, xy0, xy1, valid, cfg: RefineConfig, nvalid):
    """One fixed-scale search: ((B, K, 2) refined frame-1 coords, (B, K) ok,
    (B, K) best/second cost ratio)."""
    H0, W0 = img0.shape[-2:]
    H1, W1 = img1.shape[-2:]
    R, t = cfg.radius, cfg.template
    ht = t // 2
    n = 2 * R + 1
    xi0 = torch.round(xy0[..., 0]).long().clamp(0, W0 - 1).to(torch.int32).contiguous()
    yi0 = torch.round(xy0[..., 1]).long().clamp(0, H0 - 1).to(torch.int32).contiguous()
    xi1 = torch.round(xy1[..., 0]).long().clamp(0, W1 - 1).to(torch.int32).contiguous()
    yi1 = torch.round(xy1[..., 1]).long().clamp(0, H1 - 1).to(torch.int32).contiguous()
    args = (img0.float().contiguous(), img1.float().contiguous(), xi0, yi0, xi1, yi1, t, R,
            nvalid.to(torch.int32).contiguous())
    if cfg.cost_path in ("plain", "xla"):
        cost = refine_cost_volume_plain(*args)
    elif cfg.cost_path == "auto":
        cost = refine_cost_volume(*args)
    elif cfg.cost_path == "pallas":
        if img1.device.type != "cuda":
            raise ValueError("cost_path 'pallas' runs the CUDA kernel, which takes CUDA tensors; "
                             f"got {img1.device.type} tensors ('auto' takes the plain version there)")
        cost = refine_cost_volume(*args)
    else:
        raise ValueError(f"unknown cost_path {cfg.cost_path!r}")
    B, K = xi0.shape
    flat = cost.reshape(B, K, n * n)
    best = torch.argmin(flat, dim=-1)
    by = torch.div(best, n, rounding_mode="floor")
    bx = best % n
    best_cost = flat.min(dim=-1).values

    # uniqueness: best must beat the best candidate outside the winner's 3x3
    oy = torch.arange(n, device=cost.device)
    near = ((oy[:, None] - by[..., None, None]).abs() <= 1) & (
        (oy[None, :] - bx[..., None, None]).abs() <= 1
    )
    big = torch.full_like(cost, 1e30)
    second = torch.where(near, big, cost).reshape(B, K, n * n).min(dim=-1).values
    unique = best_cost < cfg.max_cost_ratio * second

    col_at_by = cost.gather(2, by[..., None, None].expand(B, K, 1, n))[:, :, 0, :]  # (B, K, n) over x
    row_at_bx = cost.gather(3, bx[..., None, None].expand(B, K, n, 1))[..., 0]  # (B, K, n) over y
    sx = _subpix(bx, col_at_by, n)
    sy = _subpix(by, row_at_bx, n)
    dx = bx.float() - R + sx
    dy = by.float() - R + sy
    refined = torch.stack([xi1.float() + dx, yi1.float() + dy], dim=-1)

    xi0, yi0, xi1, yi1 = (a.long() for a in (xi0, yi0, xi1, yi1))
    in_bounds = (
        (xi1 - R - ht >= 0)
        & (xi1 + R + ht < W1)
        & (yi1 - R - ht >= 0)
        & (yi1 + R + ht < H1)
        & (xi0 - ht >= 0)
        & (xi0 + ht < W0)
        & (yi0 - ht >= 0)
        & (yi0 + ht < H0)
    )
    ok = valid & unique & in_bounds
    ratio = best_cost / torch.clamp(second, min=1e-6)
    return refined, ok, torch.where(ok, ratio, torch.full_like(ratio, 2.0))


def refine_matches_quality(img0, img1, xy0, xy1, valid, cfg: RefineConfig = RefineConfig()):
    """((B, K, 2) refined frame-1 coords, (B, K) ok, (B, K) quality).

    Valid keypoints are compacted to the front before the search so the
    kernel's work is bounded by the live count ``nvalid``; results are
    un-permuted on return. Points that fail the gate (at every scale) keep
    their input coordinate with ok=False; quality is 1 - best/second of the
    winning scale in [0, 1].
    """
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    take = lambda a: a.gather(1, order[..., None].expand_as(a)) if a.dim() == 3 else a.gather(1, order)
    xy0, xy1, valid = take(xy0), take(xy1), take(valid)
    nvalid = valid.sum(dim=1)
    H, W = img0.shape[-2:]
    best = None
    for s in cfg.scales:
        if s == 1.0:
            cand = _refine_single(img0, img1, xy0, xy1, valid, cfg, nvalid)
        else:
            H0s, W0s = int(round(H * s)), int(round(W * s))
            img0s = resize_bilinear(img0, H0s, W0s)
            sc0 = torch.tensor([W0s / W, H0s / H], dtype=torch.float32, device=xy0.device)
            cand = _refine_single(img0s, img1, xy0 * sc0, xy1, valid, cfg, nvalid)
        if best is None:
            best = cand
            continue
        # the first scale of lowest ratio wins (argmin over the scales)
        score = lambda c: torch.where(c[1], c[2], torch.full_like(c[2], 3.0))
        pick = score(cand) < score(best)
        best = (torch.where(pick[..., None], cand[0], best[0]), torch.where(pick, cand[1], best[1]),
                torch.where(pick, cand[2], best[2]))
    refined, ok, ratio = best
    out = torch.where(ok[..., None], refined, xy1)
    quality = torch.where(ok, torch.clamp(1.0 - ratio, 0.0, 1.0), torch.zeros_like(ratio))
    back = lambda a: a.gather(1, inv[..., None].expand_as(a)) if a.dim() == 3 else a.gather(1, inv)
    return back(out), back(ok), back(quality)


def refine_matches(img0, img1, xy0, xy1, valid, cfg: RefineConfig = RefineConfig()):
    """:func:`refine_matches_quality` without the quality channel:
    ((B, K, 2) refined frame-1 coords, (B, K) ok)."""
    out, ok, _ = refine_matches_quality(img0, img1, xy0, xy1, valid, cfg)
    return out, ok
