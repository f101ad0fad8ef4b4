"""ORB feature extraction over a batch of images (port of frontend/orb.py).

FAST-9 corners over an 8-level 1.2x pyramid, ranked by Harris, at most one
per 8x8 cell (the JAX package's ``cell_size=8``, the only bucketing the
port has), the best cells per level by a stable top-k; intensity-centroid
orientation quantised to 12 degree bins and rotated-BRIEF 256-bit
descriptors from a 31x31 patch of the sigma-2 blurred level. The BRIEF
pattern is the JAX package's seeded Gaussian sample, rebuilt here with numpy
from the same seed, so the descriptors are the same bits.

The pyramid is built first; detection then takes every level of the batch
in one call of :func:`detect_pooled_levels` (one launch of the CUDA kernel
``csrc/detect.cu`` for CUDA tensors, its plain version for CPU tensors), or
the plain version level by level on any device with ``detect_path="plain"``.
BRIEF compares the two rotated pattern points of each bit directly
(``I[p1] > I[p0]``): the same bits as the JAX package's one-hot difference
matmul, with no matmul that TF32 could round.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.frontend.detect_kernel import detect_pooled_levels, detect_pooled_plain
from forest_slam_tpu_torch.frontend.fast import top_k
from forest_slam_tpu_torch.utils.filters import gaussian_blur, resize_bilinear


class OrbConfig(NamedTuple):
    n_features: int = 512
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    harris_block: int = 7
    edge_margin: int = 16  # keypoints closer to a level border are dropped
    n_angle_bins: int = 30  # OpenCV quantizes BRIEF rotation into 12 degree bins
    pattern_seed: int = 77
    # "auto": the detection kernel for CUDA tensors (its plain version on
    # CPU); "plain": the plain version on any device
    detect_path: str = "auto"


class OrbFeatures(NamedTuple):
    """Fixed-size keypoint sets over a batch. Invalid slots: valid=False,
    xy=(0, 0)."""

    xy: torch.Tensor  # (B, N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (B, N) float32 Harris response
    angle: torch.Tensor  # (B, N) float32 radians
    octave: torch.Tensor  # (B, N) int32 pyramid level
    desc: torch.Tensor  # (B, N, 8) int64, 32 descriptor bits per word (bit j of word w is bit 32w + j)
    valid: torch.Tensor  # (B, N) bool


# --------------------------------------------------------------------------
# Static tables (numpy, exactly as the JAX package builds them)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _brief_pattern(seed: int) -> np.ndarray:
    """(256, 2, 2) int32: per bit, two (dy, dx) offsets, radius <= 13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=31 / 5.0, size=(256, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(r > 13.0, pts * (13.0 / r), pts)
    return np.round(pts).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _rotated_patterns(seed: int, n_bins: int) -> np.ndarray:
    """(n_bins, 256, 2, 2) int32 rotated copies of the BRIEF pattern; for
    angle a the offset (dy, dx) samples (dx sin a + dy cos a, dx cos a - dy sin a)."""
    base = _brief_pattern(seed).astype(np.float64)
    out = np.zeros((n_bins, 256, 2, 2), np.int32)
    for b in range(n_bins):
        a = 2.0 * math.pi * b / n_bins
        ca, sa = math.cos(a), math.sin(a)
        dy, dx = base[..., 0], base[..., 1]
        out[b, ..., 0] = np.round(dx * sa + dy * ca)
        out[b, ..., 1] = np.round(dx * ca - dy * sa)
    return out


_PATCH = 31  # patch side for orientation + BRIEF (offsets are <= 15)
_PR = _PATCH // 2


@functools.lru_cache(maxsize=None)
def _moment_matrix() -> np.ndarray:
    """(31*31, 2) float32 disc-masked (dx, dy) weights: the m10, m01 moments."""
    ys, xs = np.mgrid[-_PR:_PR + 1, -_PR:_PR + 1]
    disc = (ys * ys + xs * xs <= _PR * _PR).astype(np.float32)
    return np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_flat_index(seed: int, n_bins: int) -> np.ndarray:
    """(n_bins, 256, 2) int64 flat patch indices of each bit's rotated
    points 0 and 1; bit = patch[point 1] > patch[point 0]."""
    pats = _rotated_patterns(seed, n_bins).astype(np.int64)
    return (pats[..., 0] + _PR) * _PATCH + (pats[..., 1] + _PR)


def _level_geometry(height: int, width: int, cfg: OrbConfig):
    """Per-level (h, w, scale) and keypoint budgets, geometric like OpenCV
    ORB's, summing to n_features."""
    sizes = []
    for lvl in range(cfg.n_levels):
        s = cfg.scale_factor ** lvl
        sizes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32), s))
    q = 1.0 / cfg.scale_factor
    norm = (1.0 - q) / (1.0 - q ** cfg.n_levels)
    budgets = [int(round(cfg.n_features * norm * q ** lvl)) for lvl in range(cfg.n_levels)]
    budgets[-1] += cfg.n_features - sum(budgets)
    return sizes, budgets


# --------------------------------------------------------------------------
# Per-level feature computation
# --------------------------------------------------------------------------


def _detect(levels, cfg: OrbConfig):
    """Cell-pooled detection of every level: a list of (vals, idx)."""
    args = (cfg.fast_threshold, cfg.harris_block, cfg.edge_margin)
    if cfg.detect_path == "auto":
        return detect_pooled_levels(levels, *args)
    if cfg.detect_path == "plain":
        return [detect_pooled_plain(lv, *args) for lv in levels]
    raise ValueError(f"unknown detect_path {cfg.detect_path!r}")


def _select_keypoints(level_img: torch.Tensor, budget: int, cfg: OrbConfig, pooled=None):
    """The top ``budget`` cells of the cell-pooled detection ``pooled`` of
    the level (detected here when None), equal scores in cell order, as
    ``jax.lax.top_k``. Returns (xy (B, K, 2) float32 level coords, score
    (B, K), valid (B, K))."""
    B, H, W = level_img.shape
    vals, idx = _detect([level_img], cfg)[0] if pooled is None else pooled
    flat_v = vals.reshape(B, -1)
    flat_i = idx.reshape(B, -1)
    if budget > flat_v.shape[1]:  # tiny pyramid level: fewer cells
        pad = budget - flat_v.shape[1]
        flat_v = F.pad(flat_v, (0, pad), value=float("-inf"))
        flat_i = F.pad(flat_i, (0, pad))
    v, sel = top_k(flat_v, budget)
    fi = flat_i.gather(1, sel).long()
    valid = torch.isfinite(v)
    xy = torch.stack([(fi % W).float(), torch.div(fi, W, rounding_mode="floor").float()], dim=-1)
    return xy * valid[..., None], torch.where(valid, v, torch.zeros_like(v)), valid


def _extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, K, 31, 31) patches of (B, H, W) centred on the integer-cast
    keypoints, zero outside the image (invalid slots sit at (0, 0))."""
    B = img.shape[0]
    pad = _PR + 1
    padded = F.pad(img, (pad, pad, pad, pad))
    off = torch.arange(_PATCH, device=img.device)
    xi = xy[..., 0].long() + pad - _PR
    yi = xy[..., 1].long() + pad - _PR
    rows = (yi[..., None] + off)[..., :, None]  # (B, K, 31, 1)
    cols = (xi[..., None] + off)[..., None, :]  # (B, K, 1, 31)
    bi = torch.arange(B, device=img.device)[:, None, None, None]
    return padded[bi, rows, cols]


def _orient_and_describe(patches: torch.Tensor, cfg: OrbConfig):
    """IC angle + rotated BRIEF of (B, K, 31, 31) patches: ((B, K) angle,
    (B, K, 8) int64 packed descriptor words)."""
    B, K = patches.shape[:2]
    flat = patches.reshape(B, K, _PATCH * _PATCH)
    mom = torch.as_tensor(_moment_matrix(), device=flat.device)
    m10 = (flat * mom[:, 0]).sum(-1)
    m01 = (flat * mom[:, 1]).sum(-1)
    angle = torch.atan2(m01, m10)

    two_pi = 2.0 * math.pi
    nb = cfg.n_angle_bins
    bins = torch.floor(torch.remainder(angle, two_pi) / two_pi * nb).long().clamp(0, nb - 1)
    table = torch.as_tensor(_brief_flat_index(cfg.pattern_seed, nb), device=flat.device)
    pts = table[bins]  # (B, K, 256, 2)
    p0 = flat.gather(2, pts[..., 0])
    p1 = flat.gather(2, pts[..., 1])
    bits = (p1 > p0).long().reshape(B, K, 8, 32)
    shifts = torch.arange(32, device=flat.device)
    packed = (bits << shifts).sum(-1)
    return angle, packed


def _extract_level(level_img: torch.Tensor, pooled, budget: int, scale: float, lvl: int,
                   cfg: OrbConfig) -> OrbFeatures:
    xy, resp, valid = _select_keypoints(level_img, budget, cfg, pooled)
    # one patch slab from the blurred level serves orientation and BRIEF
    # (the JAX package's documented deviation from ORB's raw-image angle)
    blurred = gaussian_blur(level_img, sigma=2.0, radius=3)
    angle, desc = _orient_and_describe(_extract_patches(blurred, xy), cfg)
    B = level_img.shape[0]
    return OrbFeatures(
        xy=xy * scale,
        response=resp,
        angle=angle,
        octave=torch.full((B, budget), lvl, dtype=torch.int32, device=level_img.device),
        desc=desc,
        valid=valid,
    )


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


@torch.no_grad()
def extract_orb(images: torch.Tensor, cfg: OrbConfig = OrbConfig()) -> OrbFeatures:
    """ORB features of grayscale images (B, H, W) in [0, 255]:
    ``cfg.n_features`` slots per image. Level l is resized from level l-1;
    every level is detected in one call before any is described."""
    images = images.float().contiguous()
    H, W = images.shape[-2:]
    sizes, budgets = _level_geometry(H, W, cfg)
    levels = [images]
    for h, w, _ in sizes[1:]:
        levels.append(resize_bilinear(levels[-1], h, w).contiguous())
    pooled = _detect(levels, cfg)
    per_level = [_extract_level(lv, pl, budget, scale, lvl, cfg)
                 for lvl, (lv, pl, (_, _, scale), budget) in enumerate(zip(levels, pooled, sizes, budgets))]
    return OrbFeatures(*(torch.cat(parts, dim=1) for parts in zip(*per_level)))
