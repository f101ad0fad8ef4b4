"""Synthetic corridor renderer (port of io/synthetic.py, the corridor).

A textured corridor (ground plane + two walls) ray-cast per pixel, with each
plane bilinearly sampling its own wrapped noise texture; ground-truth poses
are exact. Renders on the device it is given, so a run's frames are made on
the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.core.lie import se3_matrix


class Plane(NamedTuple):
    origin: torch.Tensor  # (3,) a point on the plane
    e1: torch.Tensor  # (3,) texture u axis (unit)
    e2: torch.Tensor  # (3,) texture v axis (unit)


class CorridorWorld(NamedTuple):
    planes: tuple
    textures: torch.Tensor  # (P, TH, TW) float32 intensities
    texture_scale: float  # metres per texture pixel


def _smooth(t: np.ndarray) -> np.ndarray:
    """[0.25, 0.5, 0.25] 'same' convolution along rows, then columns."""
    k = (0.25, 0.5, 0.25)
    for axis in (0, 1):
        p = np.pad(t, [(1, 1) if a == axis else (0, 0) for a in range(2)])
        n = t.shape[axis]
        t = sum(np.float32(k[i]) * np.take(p, np.arange(i, i + n), axis=axis) for i in range(3))
    return t.astype(np.float32)


def make_corridor_world(seed: int = 0, textures=None, half_width: float = 4.0, ground_y: float = 1.5,
                        wall_height: float = 6.0, texture_px: int = 1024, texture_scale: float = 0.05,
                        device="cuda") -> CorridorWorld:
    """Ground plane + left/right walls. Textures are smoothed uniform noise
    in [0, 255] from a numpy seed, or the (3, TH, TW) arrays given."""
    if textures is None:
        rng = np.random.default_rng(seed)
        textures = np.stack([
            _smooth(rng.uniform(0.0, 255.0, (texture_px, texture_px)).astype(np.float32)) for _ in range(3)
        ])
    tex = torch.as_tensor(np.asarray(textures, np.float32), device=device)
    v = lambda *a: torch.tensor(a, dtype=torch.float32, device=device)
    planes = (
        Plane(origin=v(0.0, ground_y, 0.0), e1=v(1.0, 0.0, 0.0), e2=v(0.0, 0.0, 1.0)),
        Plane(origin=v(-half_width, ground_y - wall_height, 0.0), e1=v(0.0, 0.0, 1.0), e2=v(0.0, 1.0, 0.0)),
        Plane(origin=v(half_width, ground_y - wall_height, 0.0), e1=v(0.0, 0.0, 1.0), e2=v(0.0, 1.0, 0.0)),
    )
    return CorridorWorld(planes=planes, textures=tex, texture_scale=texture_scale)


def _sample_texture(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with wraparound."""
    TH, TW = tex.shape
    u = torch.remainder(u, TW)
    v = torch.remainder(v, TH)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    fu = u - u0f
    fv = v - v0f
    u0 = u0f.long()
    v0 = v0f.long()
    u1 = (u0 + 1) % TW
    v1 = (v0 + 1) % TH
    flat = tex.reshape(-1)

    def at(vv, uu):
        # out-of-range indices (u rounding up to TW after the remainder)
        # clamp, as a JAX gather does
        return flat[vv.clamp(0, TH - 1) * TW + uu.clamp(0, TW - 1)]

    return (at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u1) * fu * (1 - fv)
            + at(v1, u0) * (1 - fu) * fv + at(v1, u1) * fu * fv)


def render_view(world: CorridorWorld, T_world_cam: torch.Tensor, K: torch.Tensor, height: int, width: int):
    """Render camera view(s) of the corridor: T_world_cam (..., 4, 4) ->
    (image (..., H, W) float32 in [0, 255], z-depth (..., H, W), inf where
    nothing is hit)."""
    dev = T_world_cam.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dcx = (gx - cx) / fx
    dcy = (gy - cy) / fy
    batch = T_world_cam.shape[:-2]
    R = T_world_cam[..., :3, :3].reshape(batch + (1, 1, 3, 3))
    o = T_world_cam[..., :3, 3]
    # dirs = R @ [dcx, dcy, 1], summed in full float32
    dirs = [R[..., i, 0] * dcx + R[..., i, 1] * dcy + R[..., i, 2] for i in range(3)]
    best_depth = torch.full(batch + (height, width), float("inf"), device=dev)
    best_val = torch.zeros(batch + (height, width), device=dev)
    for pi, plane in enumerate(world.planes):
        n = torch.linalg.cross(plane.e1, plane.e2, dim=-1)
        denom = dirs[0] * n[0] + dirs[1] * n[1] + dirs[2] * n[2]
        tnum = ((plane.origin - o) * n).sum(-1).reshape(batch + (1, 1))
        t = tnum / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        hit = t > 1e-3
        zdepth = t  # the camera-frame ray has z = 1, so t is the z-depth
        rel = [o[..., i].reshape(batch + (1, 1)) + t * dirs[i] - plane.origin[i] for i in range(3)]
        u = (rel[0] * plane.e1[0] + rel[1] * plane.e1[1] + rel[2] * plane.e1[2]) / world.texture_scale
        v = (rel[0] * plane.e2[0] + rel[1] * plane.e2[1] + rel[2] * plane.e2[2]) / world.texture_scale
        val = _sample_texture(world.textures[pi], u, v)
        closer = hit & (zdepth < best_depth) & (zdepth > 0)
        best_depth = torch.where(closer, zdepth, best_depth)
        best_val = torch.where(closer, val, best_val)
    return best_val, best_depth


def corridor_trajectory(n_frames: int, speed: float = 0.15, sway: float = 0.5, sway_period: float = 120.0,
                        device="cuda") -> torch.Tensor:
    """(N, 4, 4) T_world_cam: forward motion with gentle lateral sway and
    matching yaw."""
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    z = i * speed
    x = sway * torch.sin(2 * torch.pi * i / sway_period)
    dxdz = sway * (2 * torch.pi / sway_period) * torch.cos(2 * torch.pi * i / sway_period) / speed
    yaw = torch.arctan(dxdz * speed)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(cy)
    one = torch.ones_like(cy)
    R = torch.stack([
        torch.stack([cy, zero, sy], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-sy, zero, cy], -1),
    ], dim=-2)
    t = torch.stack([x, torch.zeros_like(x), z], dim=-1)
    return se3_matrix(R, t)


def default_rig(height: int, width: int, baseline: float = 0.25, device="cuda") -> StereoRig:
    """Ideal (distortion-free) rig at the requested resolution."""
    f = 0.67 * width
    K = np.array([[f, 0, width / 2 - 0.5], [0, f, height / 2 - 0.5], [0, 0, 1]], np.float32)
    cam = PinholeCamera.create(K, None, width, height, device=device)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = baseline
    return StereoRig(left=cam, right=cam, T_left_right=torch.as_tensor(T, device=device))
