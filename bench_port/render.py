"""The traffic's frames: a textured corridor (ground plane and two walls,
each bilinearly sampling its own wrapped noise texture) ray-cast per pixel on
the device, along a forward trajectory with a gentle lateral sway and
matching yaw, seen by an ideal stereo rig; and the ping-pong order that
turns U rendered frames into a long virtual sequence.

The textures and the trajectory's start come from the run's seed (a
``torch.Generator`` on the device), so every seed gives a new world of the
same size and the same work."""

from __future__ import annotations

import numpy as np
import torch

HALF_WIDTH, GROUND_Y, WALL_HEIGHT = 4.0, 1.5, 6.0
TEXTURE_SCALE = 0.05  # metres per texture pixel
SWAY, SWAY_PERIOD = 0.5, 120.0
FOCAL_PER_WIDTH = 0.67


def frame_index(n_frames: int, n_unique: int) -> np.ndarray:
    """Ping-pong order 0..U-1, U-2..1, 0..: consecutive virtual frames stay
    adjacent on the rendered trajectory."""
    if n_unique > 1:
        period = np.concatenate([np.arange(n_unique), np.arange(n_unique - 2, 0, -1)])
    else:
        period = np.zeros(1, np.int64)
    return np.tile(period, int(np.ceil(n_frames / len(period))))[:n_frames].astype(np.int32)


def rig_matrix(height: int, width: int) -> np.ndarray:
    """The ideal rig's (3, 3) intrinsics: f = 0.67 W, centre at the middle."""
    f = FOCAL_PER_WIDTH * width
    return np.array([[f, 0, width / 2 - 0.5], [0, f, height / 2 - 0.5], [0, 0, 1]], np.float32)


def _smooth(t: torch.Tensor, dim: int) -> torch.Tensor:
    """One pass of the [0.25, 0.5, 0.25] filter along ``dim``, zero padded."""
    p = torch.nn.functional.pad(t, (1, 1, 0, 0) if dim == -1 else (0, 0, 1, 1))
    n = t.shape[dim]
    return 0.25 * p.narrow(dim, 0, n) + 0.5 * p.narrow(dim, 1, n) + 0.25 * p.narrow(dim, 2, n)


def textures(gen: torch.Generator, texture_px: int, device) -> torch.Tensor:
    """(3, T, T) smoothed uniform noise in [0, 255]: ground, left and right
    wall."""
    u = torch.rand((3, texture_px, texture_px), generator=gen, device=device) * 255.0
    return _smooth(_smooth(u, -2), -1)


def trajectory(n_frames: int, speed: float, start: float, device) -> torch.Tensor:
    """(N, 4, 4) T_world_cam from step ``start`` on: z = i speed, x = sway
    sin(2 pi i / period), yaw along the path."""
    i = torch.arange(n_frames, dtype=torch.float32, device=device) + start
    z = i * speed
    x = SWAY * torch.sin(2 * torch.pi * i / SWAY_PERIOD)
    yaw = torch.arctan(SWAY * (2 * torch.pi / SWAY_PERIOD) * torch.cos(2 * torch.pi * i / SWAY_PERIOD))
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, zero, s], -1), torch.stack([zero, one, zero], -1),
                     torch.stack([-s, zero, c], -1)], -2)
    T = torch.zeros((n_frames, 4, 4), device=device)
    T[:, :3, :3] = R
    T[:, :3, 3] = torch.stack([x, torch.zeros_like(x), z], -1)
    T[:, 3, 3] = 1.0
    return T


def _sample(tex, u, v):
    TH, TW = tex.shape
    u, v = torch.remainder(u, TW), torch.remainder(v, TH)
    u0f, v0f = torch.floor(u), torch.floor(v)
    fu, fv = u - u0f, v - v0f
    u0, v0 = u0f.long(), v0f.long()
    u1, v1 = (u0 + 1) % TW, (v0 + 1) % TH
    flat = tex.reshape(-1)
    at = lambda vv, uu: flat[vv.clamp(0, TH - 1) * TW + uu.clamp(0, TW - 1)]
    return at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u1) * fu * (1 - fv) + at(v1, u0) * (1 - fu) * fv + at(v1, u1) * fu * fv


def render_view(tex: torch.Tensor, T: torch.Tensor, K: np.ndarray, height: int, width: int) -> torch.Tensor:
    """(B, H, W) float32 images in [0, 255] of poses (B, 4, 4)."""
    dev = T.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    dcx, dcy = (gx - float(K[0, 2])) / float(K[0, 0]), (gy - float(K[1, 2])) / float(K[1, 1])
    B = T.shape[0]
    R = T[:, :3, :3].reshape(B, 1, 1, 3, 3)
    o = T[:, :3, 3]
    dirs = [R[..., i, 0] * dcx + R[..., i, 1] * dcy + R[..., i, 2] for i in range(3)]
    best_d = torch.full((B, height, width), float("inf"), device=dev)
    best_v = torch.zeros((B, height, width), device=dev)
    planes = (((0.0, GROUND_Y, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
              ((-HALF_WIDTH, GROUND_Y - WALL_HEIGHT, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),
              ((HALF_WIDTH, GROUND_Y - WALL_HEIGHT, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)))
    for pi, (origin, e1, e2) in enumerate(planes):
        n = np.cross(e1, e2)
        denom = dirs[0] * n[0] + dirs[1] * n[1] + dirs[2] * n[2]
        tnum = ((torch.tensor(origin, device=dev) - o) * torch.tensor(n, dtype=torch.float32, device=dev)).sum(-1)
        t = tnum.reshape(B, 1, 1) / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        rel = [o[:, i].reshape(B, 1, 1) + t * dirs[i] - origin[i] for i in range(3)]
        u = (rel[0] * e1[0] + rel[1] * e1[1] + rel[2] * e1[2]) / TEXTURE_SCALE
        v = (rel[0] * e2[0] + rel[1] * e2[1] + rel[2] * e2[2]) / TEXTURE_SCALE
        closer = (t > 1e-3) & (t < best_d)
        best_d = torch.where(closer, t, best_d)
        best_v = torch.where(closer, _sample(tex[pi], u, v), best_v)
    return best_v


def render_stereo(tex, Ts, K, baseline: float, height: int, width: int, chunk: int = 8):
    """Left and right frames of poses (N, 4, 4); the right camera sits
    ``baseline`` metres along the left camera's x axis."""
    off = torch.eye(4, device=Ts.device)
    off[0, 3] = baseline
    left, right = [], []
    for s in range(0, Ts.shape[0], chunk):
        T = Ts[s:s + chunk]
        left.append(render_view(tex, T, K, height, width))
        right.append(render_view(tex, T @ off, K, height, width))
    return torch.cat(left).contiguous(), torch.cat(right).contiguous()
