"""FAST-9/16 corner scores and the Harris response (port of frontend/fast.py).

Dense map arithmetic over (..., H, W) images: the segment test as 16 shifted
differences and a circular arc reduction, Harris from Sobel gradients and an
unnormalised box sum. :func:`harris_response` sums its taps in the order of
utils/filters.py (rows, then columns, each tap in turn), which the detection
kernel (``csrc/detect.cu``) repeats so the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.utils.filters import box_filter, maxpool2d_same, sobel

# FAST-16 Bresenham circle of radius 3, (dy, dx), clockwise from 12 o'clock
# (the ring OpenCV uses).
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def interior_mask(H: int, W: int, m: int, device) -> torch.Tensor:
    """(H, W) bool: pixels at least ``m`` from every border."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= m) & (ys < H - m) & (xs >= m) & (xs < W - m)


def fast_score_map(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9 corner score of (..., H, W); 0 where not a corner.

    A pixel is a corner if >= 9 contiguous ring pixels are all brighter than
    ``center + t`` or all darker than ``center - t``; the score is the best
    arc's smallest absolute difference, kept only where it exceeds
    ``threshold``. A 3-pixel border is zeroed (the ring reads padding there).
    """
    img = img.float()
    H, W = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    diff = torch.stack([padded[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in FAST_OFFSETS]) - img
    diff2 = torch.cat([diff, diff[:8]])  # (24, ..., H, W): circular windows of 9
    bright = torch.stack([diff2[s:s + 9].amin(0) for s in range(16)]).amax(0)
    dark = torch.stack([(-diff2[s:s + 9]).amin(0) for s in range(16)]).amax(0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    return torch.where(interior_mask(H, W, 3, img.device), score, torch.zeros_like(score))


def harris_response(img: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Dense Harris response det - k trace^2 of (..., H, W) (OpenCV ORB's
    HARRIS_SCORE: blockSize 7, k 0.04, gradients scaled by 1/(4*255*block))."""
    gx, gy = sobel(img.float())
    scale = 1.0 / ((1 << 2) * block_size * 255.0)
    gx = gx * scale
    gy = gy * scale
    ixx = box_filter(gx * gx, block_size, normalize=False)
    iyy = box_filter(gy * gy, block_size, normalize=False)
    ixy = box_filter(gx * gy, block_size, normalize=False)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def nms_topk(score: torch.Tensor, max_keypoints: int, nms_size: int = 3):
    """3x3 non-max suppression + top-K of (B, H, W) scores, fixed output
    shape: (xy (B, K, 2) float32, score (B, K), valid (B, K)); invalid slots
    have score 0 and xy (0, 0). Equal scores keep index order (``top_k``)."""
    B, H, W = score.shape
    is_max = score >= maxpool2d_same(score, nms_size)
    kept = torch.where(is_max & (score > 0.0), score, torch.zeros_like(score))
    vals, idx = top_k(kept.reshape(B, H * W), max_keypoints)
    valid = vals > 0.0
    xy = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()], dim=-1)
    return xy * valid[..., None], vals, valid


def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim, equal
    values in index order, as ``jax.lax.top_k`` returns them: a stable sort,
    since ``torch.topk`` promises no order among ties on the card."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
