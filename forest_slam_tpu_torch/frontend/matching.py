"""Binary descriptor matching over batches (port of frontend/matching.py).

All pairwise Hamming distances of 256-bit descriptors as one product of
unpacked +-1 vectors, ``hamming = (256 - dot) / 2``, then mutual nearest
neighbours (``BFMatcher(NORM_HAMMING, crossCheck=True)``) as two argmins.
The product is exact: every partial sum is an integer of magnitude <= 256,
which half precision (on the card, accumulated in float32) and float32 (on
the CPU) hold exactly; no TF32 path is taken.
"""

from __future__ import annotations

import torch


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) packed words (32 bits each, bit j of word w is bit 32w + j)
    -> (..., 256) int8 in {-1, +1}."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.long()[..., None] >> shifts) & 1
    return (2 * bits - 1).reshape(*desc.shape[:-1], 256).to(torch.int8)


def hamming_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(B, N, 8) x (B, M, 8) packed descriptors -> (B, N, M) int32 Hamming
    distances."""
    dtype = torch.float32 if desc_a.device.type == "cpu" else torch.float16
    a = unpack_bits_pm1(desc_a).to(dtype)
    b = unpack_bits_pm1(desc_b).to(dtype)
    dot = torch.matmul(a, b.transpose(-1, -2)).round().to(torch.int32)  # in [-256, 256]
    return torch.div(256 - dot, 2, rounding_mode="floor")


def mutual_nn_match(dist: torch.Tensor, valid_a: torch.Tensor | None = None, valid_b: torch.Tensor | None = None,
                    max_distance: float | None = None) -> torch.Tensor:
    """Cross-checked nearest neighbours of (B, N, M) distances (smaller is
    better): (B, N) int32 index into the M side, or -1. Invalid rows and
    columns never match; ``max_distance`` gates the distance. Argmins take
    the first minimum, as ``jnp.argmin``."""
    big = torch.iinfo(torch.int32).max
    if valid_a is not None:
        dist = torch.where(valid_a[..., :, None], dist, torch.full_like(dist, big))
    if valid_b is not None:
        dist = torch.where(valid_b[..., None, :], dist, torch.full_like(dist, big))
    best_b = torch.argmin(dist, dim=-1)  # (B, N)
    best_a = torch.argmin(dist, dim=-2)  # (B, M)
    n = dist.shape[-2]
    mutual = best_a.gather(-1, best_b) == torch.arange(n, device=dist.device)
    d = dist.gather(-1, best_b[..., None])[..., 0]
    ok = mutual & (d < big)
    if max_distance is not None:
        ok = ok & (d <= max_distance)
    if valid_a is not None:
        ok = ok & valid_a
    return torch.where(ok, best_b, torch.full_like(best_b, -1)).to(torch.int32)


def gather_matched_points(xy_a: torch.Tensor, xy_b: torch.Tensor, matches: torch.Tensor):
    """Fixed-shape matched pairs: (pts_a (B, N, 2), pts_b (B, N, 2), mask
    (B, N)); unmatched slots carry mask=False instead of being dropped."""
    mask = matches >= 0
    idx = torch.where(mask, matches, torch.zeros_like(matches)).long()
    return xy_a, xy_b.gather(-2, idx[..., None].expand(*idx.shape, 2)), mask
