"""Disparity -> depth and keypoint back-projection (port of stereo/depth.py),
batched over frames.

The reference's stereo depth stage (stereo_slam.py:117-121, 264-288):
disparities of 0 or -1 are clamped to 0.1 before the division (huge depths
the validity gate drops later, not NaNs); depth = fx * baseline /
disparity; a keypoint reads the depth at its truncated-int pixel (quirk
B3); the gate is 0.1 < Z < 1000.
"""

from __future__ import annotations

import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, backproject_depth


def disparity_to_depth(disparity: torch.Tensor, fx, baseline) -> torch.Tensor:
    """Disparity (..., H, W) -> depth (..., H, W) with the reference's clamp."""
    d = torch.where((disparity == 0.0) | (disparity == -1.0), torch.full_like(disparity, 0.1), disparity)
    return fx * baseline / d


def depth_at_keypoints(depth: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, K) depths of (B, H, W) maps at (B, K, 2) pixels, coordinates
    truncated to int and clamped to the image (B3)."""
    B, H, W = depth.shape
    xi = xy[..., 0].long().clamp(0, W - 1)
    yi = xy[..., 1].long().clamp(0, H - 1)
    return depth.reshape(B, H * W).gather(1, yi * W + xi)


def backproject_keypoints(xy: torch.Tensor, depth_map: torch.Tensor, cam: PinholeCamera, min_depth: float = 0.1,
                          max_depth: float = 1000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """((B, K, 3) camera-frame points, (B, K) depth gate) of (B, K, 2)
    keypoints through (B, H, W) depth maps (stereo_slam.py:274-288)."""
    z = depth_at_keypoints(depth_map, xy)
    return backproject_depth(xy, z, cam), (z > min_depth) & (z < max_depth)
