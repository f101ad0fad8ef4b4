"""Learned front end: SuperPoint extraction + SuperGlue matching (port of
frontend/learned.py, single scale)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from forest_slam_tpu_torch.frontend.superglue import MatchResult, SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import (
    SuperPointConfig,
    SuperPointFeatures,
    SuperPointNet,
    select_keypoints,
)


class LearnedFrontendConfig(NamedTuple):
    superpoint: SuperPointConfig = SuperPointConfig()
    superglue: SuperGlueConfig = SuperGlueConfig()


class LearnedFrontend(nn.Module):
    """SuperPoint network + SuperGlue matcher with their weights."""

    def __init__(self, cfg: LearnedFrontendConfig, superpoint: SuperPointNet, superglue: SuperGlue):
        super().__init__()
        self.cfg = cfg
        self.superpoint = superpoint
        self.superglue = superglue

    @torch.no_grad()
    def extract(self, images: torch.Tensor) -> SuperPointFeatures:
        """(B, H, W) images in [0, 255] -> batched features."""
        raw = self.superpoint(images / 255.0)
        return select_keypoints(raw.heat, raw.coarse_desc, self.cfg.superpoint)

    @torch.no_grad()
    def match_features(self, f0: SuperPointFeatures, f1: SuperPointFeatures, image_shape) -> MatchResult:
        return self.superglue(
            f0.xy, f0.score, f0.desc, f0.valid,
            f1.xy, f1.score, f1.desc, f1.valid,
            image_shape,
        )
