"""Sparse stereo at keypoints and SAD refinement of matches, plain.

Sparse stereo: SAD over a w x w window of the x-Sobel-prefiltered (clipped)
left image against D candidates along the row of the right image,
winner-take-all, a best/second-best uniqueness gate, a parabola for the
sub-pixel disparity, depth = fx * baseline / disparity.

Refinement: an 8x8 template around each frame-0 keypoint matched by SAD
over the (2R+1)^2 neighbourhood of the frame-1 estimate, a uniqueness gate
outside the winner's 3x3, a parabola per axis; a point that fails keeps its
input coordinate; quality = 1 - best/second."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.common import SOUND, Precision, sobel


def _parabola(cm, cc, cp):
    den = cm - 2 * cc + cp
    return torch.where(den > 1e-6, torch.clamp((cm - cp) / (2 * den), -0.5, 0.5), torch.zeros_like(den))


def sparse_depth(left, right, xy, fx: float, baseline: float, cfg: dict, prec: Precision = SOUND):
    """((B, K) depth, (B, K) validity) of (B, K, 2) keypoints."""
    D, w, cap = cfg["num_disparities"], cfg["window"], cfg["prefilter_cap"]
    B, H, W = left.shape
    r = w // 2
    pl = prec.f32(torch.clamp(sobel(left)[0] * 0.25, -cap, cap))
    pr = prec.f32(torch.clamp(sobel(right)[0] * 0.25, -cap, cap))
    xi = torch.round(xy[..., 0]).long()
    yi = torch.round(xy[..., 1]).long()
    x, y = xi.clamp(0, W - 1), yi.clamp(0, H - 1)
    S = D + w - 1
    pl_pad = F.pad(pl, (r, r, r, r))
    pr_pad = F.pad(pr, (D - 1 + r, r, r, r))
    bi = torch.arange(B, device=left.device)[:, None, None, None]
    rows = (y[..., None] + torch.arange(w, device=left.device))[..., :, None]
    patch = pl_pad[bi, rows, x[..., None, None] + torch.arange(w, device=left.device)]
    strip = pr_pad[bi, rows, x[..., None, None] + torch.arange(S, device=left.device)]
    cost = prec.f32((patch[..., :, None, :] - strip.unfold(-1, w, 1)).abs().sum(dim=(2, 4)).flip(-1))
    ds = torch.arange(D, device=left.device)
    max_cost = 2.0 * cap * w * w
    cost = torch.where((xi[..., None] - ds) >= r, cost, torch.full_like(cost, max_cost))
    best_cost = cost.min(-1).values
    best = torch.argmin(cost, -1)
    second = torch.where((ds - best[..., None]).abs() <= 1, torch.full_like(cost, max_cost), cost).min(-1).values
    b = best.clamp(1, D - 2)
    g = lambda o: cost.gather(-1, (b + o)[..., None])[..., 0]
    disp = best.float() + (_parabola(g(-1), g(0), g(1)) if cfg["subpixel"] else 0.0)
    valid = ((best_cost < cfg["max_cost_ratio"] * second) & (best >= 1) & (best <= D - 2) & (xi >= r)
             & (xi < W - r) & (yi >= r) & (yi < H - r) & (best_cost < max_cost))
    depth = prec.f32(fx * baseline / torch.clamp(disp, min=0.1))
    return depth, valid & (disp > 0.1)


def refine(img0, img1, xy0, xy1, valid, radius: int, template: int, max_ratio: float, prec: Precision = SOUND):
    """((B, K, 2) refined frame-1 coordinates, (B, K) ok, (B, K) quality)."""
    B, K = valid.shape
    H0, W0 = img0.shape[-2:]
    H1, W1 = img1.shape[-2:]
    R, t = radius, template
    ht, n = t // 2, 2 * radius + 1
    rnd = lambda a, hi: torch.round(a).long().clamp(0, hi - 1)
    xi0, yi0 = rnd(xy0[..., 0], W0), rnd(xy0[..., 1], H0)
    xi1, yi1 = rnd(xy1[..., 0], W1), rnd(xy1[..., 1], H1)
    bi = torch.arange(B, device=img0.device)[:, None, None, None]
    p0 = F.pad(img0.float(), (ht, ht, ht, ht))
    p1 = F.pad(img1.float(), (ht + R,) * 4)
    at, aS = torch.arange(t, device=img0.device), torch.arange(n + t - 1, device=img0.device)
    tpl = p0[bi, (yi0[..., None] + at)[..., :, None], (xi0[..., None] + at)[..., None, :]]
    win = p1[bi, (yi1[..., None] + aS)[..., :, None], (xi1[..., None] + aS)[..., None, :]]
    cost = torch.zeros((B, K, n, n), dtype=torch.float32, device=img0.device)
    for ty in range(t):
        for tx in range(t):
            cost = cost + (win[..., ty:ty + n, tx:tx + n] - tpl[..., ty:ty + 1, tx:tx + 1]).abs()
    cost = prec.f32(cost)
    flat = cost.reshape(B, K, n * n)
    best = torch.argmin(flat, -1)
    by, bx = torch.div(best, n, rounding_mode="floor"), best % n
    best_cost = flat.min(-1).values
    o = torch.arange(n, device=img0.device)
    near = ((o[:, None] - by[..., None, None]).abs() <= 1) & ((o[None, :] - bx[..., None, None]).abs() <= 1)
    second = torch.where(near, torch.full_like(cost, 1e30), cost).reshape(B, K, n * n).min(-1).values

    def sub(bb, axis_cost):
        c = bb.clamp(1, n - 2)
        g = lambda d: axis_cost.gather(-1, (c + d)[..., None])[..., 0]
        return torch.where((bb >= 1) & (bb <= n - 2), _parabola(g(-1), g(0), g(1)), torch.zeros_like(best_cost))

    sx = sub(bx, cost.gather(2, by[..., None, None].expand(B, K, 1, n))[:, :, 0, :])
    sy = sub(by, cost.gather(3, bx[..., None, None].expand(B, K, n, 1))[..., 0])
    refined = prec.f32(torch.stack([xi1.float() + bx.float() - R + sx, yi1.float() + by.float() - R + sy], -1))
    inb = ((xi1 - R - ht >= 0) & (xi1 + R + ht < W1) & (yi1 - R - ht >= 0) & (yi1 + R + ht < H1)
           & (xi0 - ht >= 0) & (xi0 + ht < W0) & (yi0 - ht >= 0) & (yi0 + ht < H0))
    ok = valid & (best_cost < max_ratio * second) & inb
    ratio = best_cost / torch.clamp(second, min=1e-6)
    quality = torch.where(ok, torch.clamp(1.0 - ratio, 0.0, 1.0), torch.zeros_like(ratio))
    return torch.where(ok[..., None], refined, xy1), ok, quality
