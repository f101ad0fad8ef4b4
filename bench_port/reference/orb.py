"""ORB (Rublee et al., ICCV 2011) as the configuration runs it: FAST-9
corners over a bilinear pyramid, ranked by the Harris response, the best
corner of each 8x8 cell after 3x3 NMS, the best cells of each level by a
stable top-k under geometric budgets; intensity-centroid orientation in 12
degree bins and rotated-BRIEF 256-bit descriptors on the sigma-2 blurred
level; matching by cross-checked Hamming nearest neighbours under a
distance gate."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import (
    SOUND, Precision, box_sum, gaussian_blur, maxpool_same, resize_bilinear, sobel, top_k)

CELL = 8
PATCH = 31
PR = PATCH // 2
# FAST-16 ring of radius 3 as (dy, dx), clockwise from 12 o'clock
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def interior(H: int, W: int, m: int, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= m) & (ys < H - m) & (xs >= m) & (xs < W - m)


def fast_score(img, threshold: float):
    """FAST-9 score (the best arc's smallest absolute difference), 0 where
    no arc of 9 passes or within 3 px of the border."""
    H, W = img.shape[-2:]
    p = F.pad(img, (3, 3, 3, 3))
    diff = torch.stack([p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in RING]) - img
    diff2 = torch.cat([diff, diff[:8]])
    bright = torch.stack([diff2[s:s + 9].amin(0) for s in range(16)]).amax(0)
    dark = torch.stack([(-diff2[s:s + 9]).amin(0) for s in range(16)]).amax(0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    return torch.where(interior(H, W, 3, img.device), score, torch.zeros_like(score))


def harris(img, block: int, k: float = 0.04):
    gx, gy = sobel(img)
    s = 1.0 / (4 * block * 255.0)
    gx, gy = gx * s, gy * s
    ixx, iyy, ixy = box_sum(gx * gx, block), box_sum(gy * gy, block), box_sum(gx * gy, block)
    tr = ixx + iyy
    return ixx * iyy - ixy * ixy - k * tr * tr


def detect_cells(img, threshold: float, block: int, margin: int, prec: Precision = SOUND):
    """Per 8x8 cell the largest Harris response among FAST corners that
    survive 3x3 NMS, and its flat index (first maximum in row-major order);
    -inf for empty cells."""
    B, H, W = img.shape
    neg = torch.full((B, H, W), float("-inf"), device=img.device)
    ranked = torch.where((fast_score(img, threshold) > 0) & interior(H, W, margin, img.device),
                         prec.f32(harris(img, block)), neg)
    kept = torch.where((ranked >= maxpool_same(ranked, 3)) & torch.isfinite(ranked), ranked, neg)
    ncy, ncx = -(-H // CELL), -(-W // CELL)
    kp = F.pad(kept, (0, ncx * CELL - W, 0, ncy * CELL - H), value=float("-inf"))
    tiles = kp.reshape(B, ncy, CELL, ncx, CELL).permute(0, 1, 3, 2, 4).reshape(B, ncy, ncx, CELL * CELL)
    within = torch.argmax(tiles, -1)
    ys = torch.arange(ncy, device=img.device)[:, None] * CELL + torch.div(within, CELL, rounding_mode="floor")
    xs = torch.arange(ncx, device=img.device)[None, :] * CELL + within % CELL
    return tiles.amax(-1), ys * W + xs


def level_geometry(H: int, W: int, cfg: dict):
    n, sf = cfg["n_levels"], cfg["scale_factor"]
    sizes = [(max(int(round(H / sf ** l)), 32), max(int(round(W / sf ** l)), 32), sf ** l) for l in range(n)]
    q = 1.0 / sf
    norm = (1.0 - q) / (1.0 - q ** n)
    budgets = [int(round(cfg["n_features"] * norm * q ** l)) for l in range(n)]
    budgets[-1] += cfg["n_features"] - sum(budgets)
    return sizes, budgets


def pyramid(images, cfg: dict, prec: Precision = SOUND):
    sizes, _ = level_geometry(images.shape[-2], images.shape[-1], cfg)
    levels = [images.float()]
    for h, w, _ in sizes[1:]:
        levels.append(prec.f32(resize_bilinear(levels[-1], h, w)))
    return levels


@functools.lru_cache(maxsize=None)
def brief_index(seed: int, n_bins: int) -> np.ndarray:
    """(n_bins, 256, 2) flat patch indices of each bit's two rotated points
    (bit = patch[point 1] > patch[point 0]): the seeded Gaussian pattern,
    radius <= 13, rotated to each bin's angle."""
    pts = np.random.default_rng(seed).normal(scale=31 / 5.0, size=(256, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    base = np.round(np.where(r > 13.0, pts * (13.0 / r), pts)).astype(np.int32).astype(np.float64)
    out = np.zeros((n_bins, 256, 2, 2), np.int64)
    for b in range(n_bins):
        a = 2.0 * math.pi * b / n_bins
        dy, dx = base[..., 0], base[..., 1]
        out[b, ..., 0] = np.round(dx * math.sin(a) + dy * math.cos(a))
        out[b, ..., 1] = np.round(dx * math.cos(a) - dy * math.sin(a))
    return (out[..., 0] + PR) * PATCH + (out[..., 1] + PR)


def describe(level, xy, cfg: dict, prec: Precision = SOUND):
    """(B, K, 8) int64 packed rotated-BRIEF words of the keypoints at
    integer-cast level coordinates, on the blurred level."""
    blurred = prec.f32(gaussian_blur(level))
    B = blurred.shape[0]
    pad = PR + 1
    padded = F.pad(blurred, (pad, pad, pad, pad))
    off = torch.arange(PATCH, device=level.device)
    xi = xy[..., 0].long() + pad - PR
    yi = xy[..., 1].long() + pad - PR
    patches = padded[torch.arange(B, device=level.device)[:, None, None, None], (yi[..., None] + off)[..., :, None],
                     (xi[..., None] + off)[..., None, :]]
    K = xy.shape[1]
    flat = patches.reshape(B, K, PATCH * PATCH)
    ys, xs = np.mgrid[-PR:PR + 1, -PR:PR + 1]
    disc = (ys * ys + xs * xs <= PR * PR).astype(np.float32)
    mom = torch.as_tensor(np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], 1).astype(np.float32),
                          device=level.device)
    angle = torch.atan2((flat * mom[:, 1]).sum(-1), (flat * mom[:, 0]).sum(-1))
    nb = cfg["n_angle_bins"]
    bins = torch.floor(torch.remainder(angle, 2 * math.pi) / (2 * math.pi) * nb).long().clamp(0, nb - 1)
    pts = torch.as_tensor(brief_index(cfg["pattern_seed"], nb), device=level.device)[bins]
    bits = (flat.gather(2, pts[..., 1]) > flat.gather(2, pts[..., 0])).long().reshape(B, K, 8, 32)
    return (bits << torch.arange(32, device=level.device)).sum(-1)


def extract(images, cfg: dict, prec: Precision = SOUND):
    """ORB features of (B, H, W) images: dict of xy (B, N, 2) level-0
    pixels, desc (B, N, 8) int64 and valid (B, N)."""
    H, W = images.shape[-2:]
    sizes, budgets = level_geometry(H, W, cfg)
    xys, descs, valids = [], [], []
    for level, (_, _, scale), budget in zip(pyramid(images, cfg, prec), sizes, budgets):
        B, h, w = level.shape
        vals, idx = detect_cells(level, cfg["fast_threshold"], cfg["harris_block"], cfg["edge_margin"], prec)
        fv, fi = vals.reshape(B, -1), idx.reshape(B, -1)
        if budget > fv.shape[1]:
            fv = F.pad(fv, (0, budget - fv.shape[1]), value=float("-inf"))
            fi = F.pad(fi, (0, budget - fi.shape[1]))
        v, sel = top_k(fv, budget)
        f = fi.gather(1, sel)
        valid = torch.isfinite(v)
        xy = torch.stack([(f % w).float(), torch.div(f, w, rounding_mode="floor").float()], -1) * valid[..., None]
        descs.append(describe(level, xy, cfg, prec))
        xys.append(xy * scale)
        valids.append(valid)
    return dict(xy=torch.cat(xys, 1), desc=torch.cat(descs, 1), valid=torch.cat(valids, 1))


def hamming(da, db):
    """(B, N, 8) x (B, M, 8) packed words -> (B, N, M) Hamming distances."""
    shifts = torch.arange(32, device=da.device)
    unpack = lambda d: (((d[..., None] >> shifts) & 1) * 2 - 1).reshape(*d.shape[:-1], 256).float()
    dot = (unpack(da) @ unpack(db).transpose(-1, -2)).round().long()
    return torch.div(256 - dot, 2, rounding_mode="floor")


def match(f0: dict, f1: dict, max_distance: int):
    """(B, N) cross-checked nearest neighbour of f0's keypoints in f1 within
    ``max_distance`` bits, or -1."""
    big = 1 << 30
    d = hamming(f0["desc"], f1["desc"])
    d = torch.where(f0["valid"][..., :, None] & f1["valid"][..., None, :], d, torch.full_like(d, big))
    best_b = torch.argmin(d, -1)
    best_a = torch.argmin(d, -2)
    mutual = best_a.gather(-1, best_b) == torch.arange(d.shape[-2], device=d.device)
    db = d.gather(-1, best_b[..., None])[..., 0]
    ok = mutual & (db < big) & (db <= max_distance) & f0["valid"]
    return torch.where(ok, best_b, torch.full_like(best_b, -1))
