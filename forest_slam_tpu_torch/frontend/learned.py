"""Learned front end: SuperPoint extraction + SuperGlue matching (port of
frontend/learned.py), with multi-scale extraction."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from forest_slam_tpu_torch.frontend.fast import top_k
from forest_slam_tpu_torch.frontend.superglue import MatchResult, SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import (
    SuperPointConfig,
    SuperPointFeatures,
    SuperPointNet,
    select_keypoints,
)
from forest_slam_tpu_torch.utils.filters import resize_bilinear


class LearnedFrontendConfig(NamedTuple):
    superpoint: SuperPointConfig = SuperPointConfig()
    superglue: SuperGlueConfig = SuperGlueConfig()
    # extraction octaves; (1.0,) is single scale. Other octaves run the
    # extractor on resized copies and merge the keypoint sets by score into
    # the same max_keypoints slots, in full-resolution pixels.
    scales: tuple = (1.0,)


def octave_shape(H: int, W: int, s: float, s8: int) -> tuple[int, int]:
    """(Hs, Ws) of octave ``s``: rounded, then down to a multiple of the
    network's total stride ``s8`` (learned.py:107-108)."""
    return max(int(round(H * s)) // s8 * s8, s8), max(int(round(W * s)) // s8 * s8, s8)


def _duplicates(cell, score):
    """(B, M) bool: all but the best-scoring entry of each cell, the
    reference's ``lexsort((-score, cell))`` by two stable sorts."""
    by_score = torch.sort(-score, dim=1, stable=True).indices
    by_cell = torch.sort(cell.gather(1, by_score), dim=1, stable=True).indices
    order = by_score.gather(1, by_cell)
    sc = cell.gather(1, order)
    dup_sorted = torch.cat([torch.zeros_like(sc[:, :1], dtype=torch.bool), sc[:, 1:] == sc[:, :-1]], dim=1)
    return torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)


class LearnedFrontend(nn.Module):
    """SuperPoint network + SuperGlue matcher with their weights."""

    def __init__(self, cfg: LearnedFrontendConfig, superpoint: SuperPointNet, superglue: SuperGlue):
        super().__init__()
        self.cfg = cfg
        self.superpoint = superpoint
        self.superglue = superglue

    def _extract_one(self, images):
        raw = self.superpoint(images / 255.0)
        return select_keypoints(raw.heat, raw.coarse_desc, self.cfg.superpoint)

    @torch.no_grad()
    def extract(self, images: torch.Tensor) -> SuperPointFeatures:
        """(B, H, W) images in [0, 255] -> batched features. With octaves
        beyond (1.0,), the per-octave sets are merged (learned.py:98-155):
        coordinates scaled back to full resolution, cross-octave duplicates
        in one ``nms_radius`` cell dropped but the best, then the top K by
        score, equal scores in slot order."""
        if tuple(self.cfg.scales) == (1.0,):
            return self._extract_one(images)
        B, H, W = images.shape
        s8 = self.cfg.superpoint.stem_stride * 8
        per_scale = []
        for s in self.cfg.scales:
            imgs_s = images if s == 1.0 else resize_bilinear(images, *octave_shape(H, W, s, s8))
            f = self._extract_one(imgs_s)
            Hs, Ws = imgs_s.shape[1:]
            back = torch.tensor([W / Ws, H / Hs], dtype=torch.float32, device=images.device)
            per_scale.append(f._replace(xy=f.xy * back))
        merged = SuperPointFeatures(*(torch.cat(xs, dim=1) for xs in zip(*per_scale)))
        r = max(self.cfg.superpoint.nms_radius, 1)
        M = merged.xy.shape[1]
        cell = (torch.round(merged.xy[..., 0] / r).to(torch.int32)
                + torch.round(merged.xy[..., 1] / r).to(torch.int32) * 65536)
        sentinel = -(torch.arange(M, dtype=torch.int32, device=images.device) + 1)
        cell = torch.where(merged.valid, cell, sentinel)
        valid = merged.valid & ~_duplicates(cell, merged.score)
        score = torch.where(valid, merged.score, torch.full_like(merged.score, float("-inf")))
        top_score, top = top_k(score, self.cfg.superpoint.max_keypoints)
        return SuperPointFeatures(
            xy=merged.xy.gather(1, top[..., None].expand(-1, -1, 2)),
            score=merged.score.gather(1, top),
            desc=merged.desc.gather(1, top[..., None].expand(-1, -1, merged.desc.shape[-1])),
            valid=valid.gather(1, top) & torch.isfinite(top_score),
        )

    @torch.no_grad()
    def match_features(self, f0: SuperPointFeatures, f1: SuperPointFeatures, image_shape) -> MatchResult:
        return self.superglue(
            f0.xy, f0.score, f0.desc, f0.valid,
            f1.xy, f1.score, f1.desc, f1.valid,
            image_shape,
        )
