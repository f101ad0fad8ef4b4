"""Synthetic scene renderer (port of io/synthetic.py).

Two worlds, ray-cast per pixel with each surface bilinearly sampling its own
wrapped noise texture: a textured corridor (ground plane + two walls), and a
forest (ground, canopy and far walls, plus vertical cylinder trunks with a
streaked bark texture that occlude each other and the ground). Ground-truth
poses are exact. Textures and trunks come from a numpy seed
(``draws="numpy"``), or from the seed as ``jax.random.PRNGKey(seed)`` draws
them in the JAX package (``draws="jax"``, by ``utils/threefry.py``: the
JAX package's own worlds), or are handed in. Renders on the device it is
given, so a run's frames are made on the card.
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


def _smooth_axis(t: np.ndarray, axis: int, reps: int = 1) -> np.ndarray:
    """``reps`` passes of the [0.25, 0.5, 0.25] 'same' convolution along
    ``axis``."""
    k = (0.25, 0.5, 0.25)
    n = t.shape[axis]
    for _ in range(reps):
        p = np.pad(t, [(1, 1) if a == axis else (0, 0) for a in range(2)])
        t = sum(np.float32(k[i]) * np.take(p, np.arange(i, i + n), axis=axis) for i in range(3))
    return t.astype(np.float32)


def _smooth(t: np.ndarray, reps_y: int = 1, reps_x: int = 1) -> np.ndarray:
    """Smoothing along rows, then columns."""
    return _smooth_axis(_smooth_axis(t, 0, reps_y), 1, reps_x)


def _uniforms(seed: int, draws: str, n: int):
    """``uniform(i, shape, lo, hi)`` float32 draws for the i-th of ``n``
    arrays of a world: from one numpy generator in call order, or from the
    i-th key of ``jax.random.split(PRNGKey(seed), n)``."""
    if draws == "numpy":
        rng = np.random.default_rng(seed)
        return lambda i, shape, lo=0.0, hi=1.0: rng.uniform(lo, hi, shape).astype(np.float32)
    if draws == "jax":
        from forest_slam_tpu_torch.utils import threefry

        keys = threefry.split(threefry.prng_key(seed), n)
        return lambda i, shape, lo=0.0, hi=1.0: threefry.uniform(keys[i], shape, lo, hi)
    raise ValueError(f"unknown draws {draws!r}")


def corridor_textures(seed: int = 0, texture_px: int = 1024, draws: str = "numpy") -> np.ndarray:
    """(3, TH, TW) smoothed uniform noise in [0, 255]: ground, left and right
    walls (io/synthetic.py:make_corridor_world)."""
    uniform = _uniforms(seed, draws, 3)
    return np.stack([_smooth(uniform(i, (texture_px, texture_px), 0.0, 255.0)) for i in range(3)])


def make_corridor_world(seed: int = 0, textures=None, half_width: float = 4.0, ground_y: float = 1.5,
                        wall_height: float = 6.0, texture_px: int = 1024, texture_scale: float = 0.05,
                        device="cuda", draws: str = "numpy") -> CorridorWorld:
    """Ground plane + left/right walls; textures from :func:`corridor_textures`,
    or the (3, TH, TW) arrays given."""
    if textures is None:
        textures = corridor_textures(seed, texture_px, draws)
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


class ForestWorld(NamedTuple):
    """Forest scene: textured ground, overhead canopy and far side walls,
    plus vertical cylinder trunks sharing a bark texture."""

    planes: tuple
    textures: torch.Tensor  # (4, TH, TW)
    texture_scale: float
    trunks: torch.Tensor  # (N, 5): cx, cz, radius, height, texture u offset
    trunk_texture: torch.Tensor  # (TH, TW) bark
    ground_y: float


class ForestArrays(NamedTuple):
    """The random content of a forest world (numpy float32)."""

    textures: np.ndarray  # (4, TH, TW): ground, canopy, left wall, right wall
    trunks: np.ndarray  # (N, 5)
    trunk_texture: np.ndarray  # (TH, TW)


def forest_arrays(seed: int = 0, n_trees: int = 150, extent_x: float = 14.0, z_range=(-5.0, 75.0),
                  clear_half_width: float = 1.6, canopy_height: float = 6.0, texture_px: int = 1024,
                  draws: str = "numpy") -> ForestArrays:
    """Textures and trunks of io/synthetic.py:make_forest_world:
    multi-octave ground clutter (a coarse grid upsampled bilinearly plus fine
    grain), a smoothed canopy, two walls, bark smoothed along v into
    vertical streaks; trunks uniform in |x| in [clear_half_width, extent_x]
    on either side, z in z_range, radii 0.12-0.45 m, reaching the canopy.
    The draws come in the JAX function's order: its keys 0-6 for the
    textures, the four of ``split(keys[7], 4)`` for the trunks' side, x, z
    and radius, key 8 for the bark offsets."""
    if draws == "jax":
        from forest_slam_tpu_torch.utils import threefry

        keys = threefry.split(threefry.prng_key(seed), 9)
        slots = [*keys[:7], *threefry.split(keys[7], 4), keys[8]]
        uniform = lambda i, shape, lo=0.0, hi=1.0: threefry.uniform(slots[i], shape, lo, hi)
    else:
        uniform = _uniforms(seed, draws, 12)
    px = (texture_px, texture_px)

    def noise(i, reps_y=1, reps_x=1):
        return _smooth(uniform(i, px, 0.0, 255.0), reps_y, reps_x)

    from forest_slam_tpu_torch.utils.filters import resize_bilinear

    coarse = resize_bilinear(torch.as_tensor(uniform(0, (texture_px // 8, texture_px // 8))), *px).numpy()
    ground = np.clip(0.55 * coarse * 255.0 + 0.45 * noise(1), 0.0, 255.0)
    canopy = np.clip(0.5 * noise(2, 3, 3) + 0.5 * noise(3), 0.0, 255.0)
    walls = [noise(4, 2, 2), noise(5, 2, 2)]
    bark = noise(6, 8, 1)
    side = np.where(uniform(7, (n_trees,)) < 0.5, -1.0, 1.0)
    cx = side * uniform(8, (n_trees,), clear_half_width, extent_x)
    cz = uniform(9, (n_trees,), z_range[0], z_range[1])
    radius = uniform(10, (n_trees,), 0.12, 0.45)
    u_off = uniform(11, (n_trees,), 0.0, float(texture_px))
    trunks = np.stack([cx, cz, radius, np.full(n_trees, canopy_height), u_off], axis=1)
    return ForestArrays(np.stack([ground, canopy, *walls]).astype(np.float32), trunks.astype(np.float32),
                        bark.astype(np.float32))


def make_forest_world(seed: int = 0, arrays: ForestArrays | None = None, n_trees: int = 150,
                      extent_x: float = 14.0, z_range=(-5.0, 75.0), clear_half_width: float = 1.6,
                      ground_y: float = 1.5, canopy_height: float = 6.0, texture_px: int = 1024,
                      texture_scale: float = 0.05, device="cuda", draws: str = "numpy") -> ForestWorld:
    """Scattered trunks, ground clutter, canopy and far walls; the random
    content from :func:`forest_arrays` (or ``arrays`` given)."""
    if arrays is None:
        arrays = forest_arrays(seed, n_trees, extent_x, z_range, clear_half_width, canopy_height, texture_px,
                               draws)
    v = lambda *a: torch.tensor(a, dtype=torch.float32, device=device)
    top = ground_y - canopy_height
    planes = (
        Plane(origin=v(0.0, ground_y, 0.0), e1=v(1.0, 0.0, 0.0), e2=v(0.0, 0.0, 1.0)),  # ground
        Plane(origin=v(0.0, top, 0.0), e1=v(1.0, 0.0, 0.0), e2=v(0.0, 0.0, 1.0)),  # canopy
        Plane(origin=v(-extent_x - 2.0, top, 0.0), e1=v(0.0, 0.0, 1.0), e2=v(0.0, 1.0, 0.0)),  # far left wall
        Plane(origin=v(extent_x + 2.0, top, 0.0), e1=v(0.0, 0.0, 1.0), e2=v(0.0, 1.0, 0.0)),  # far right wall
    )
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return ForestWorld(planes=planes, textures=t(arrays.textures), texture_scale=texture_scale,
                       trunks=t(arrays.trunks), trunk_texture=t(arrays.trunk_texture), ground_y=ground_y)


def _raycast_trunks(world: ForestWorld, o, dirs, best_val, best_depth):
    """Intersect every ray with every vertical cylinder, one trunk at a time
    with (..., H, W) accumulators (never an (..., H, W, N) volume). ``o``
    (..., 1, 1, 3) camera origins, ``dirs`` three (..., H, W) ray
    components whose z-depth is the ray parameter."""
    dx, dy, dz = dirs
    a = dx * dx + dz * dz
    two_a = 2.0 * torch.clamp(a, min=1e-12)
    ox_w, oy_w, oz_w = o[..., 0], o[..., 1], o[..., 2]
    top = world.ground_y
    for tcx, tcz, radius, h, u_off in world.trunks.tolist():
        ox = ox_w - tcx
        oz = oz_w - tcz
        b = 2.0 * (ox * dx + oz * dz)
        c = ox * ox + oz * oz - radius * radius
        disc = b * b - 4.0 * a * c
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / two_a  # near intersection
        y = oy_w + t * dy
        hit = (disc > 0.0) & (t > 1e-3) & (y <= top) & (y >= top - h)
        az = torch.atan2(oz_w + t * dz - tcz, ox_w + t * dx - tcx)
        val = _sample_texture(world.trunk_texture, az * radius / world.texture_scale + u_off,
                              y / world.texture_scale)
        closer = hit & (t < best_depth)
        best_val = torch.where(closer, val, best_val)
        best_depth = torch.where(closer, t, best_depth)
    return best_val, best_depth


def render_view(world, T_world_cam: torch.Tensor, K: torch.Tensor, height: int, width: int):
    """Render camera view(s) of a CorridorWorld or ForestWorld: T_world_cam
    (..., 4, 4) -> (image (..., H, W) float32 in [0, 255], z-depth
    (..., H, W), inf where nothing is hit)."""
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
    if isinstance(world, ForestWorld):
        best_val, best_depth = _raycast_trunks(world, o.reshape(batch + (1, 1, 3)), dirs, best_val, best_depth)
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


def out_and_back_trajectory(n_forward: int = 20, n_turn: int = 12, speed: float = 0.25, n_rejoin: int = 6,
                            device="cuda") -> torch.Tensor:
    """(N, 4, 4) loop: forward down the corridor, a 180 degree turn in
    place, back past the start, a turn to the first heading, then the first
    ``n_rejoin`` steps again (true revisits). N = 2 n_forward + 2 n_turn +
    2 n_rejoin."""
    yaw, z = [0.0] * n_forward, list(np.arange(n_forward) * speed)
    z_far = (n_forward - 1) * speed
    yaw += list(np.linspace(0.0, np.pi, n_turn, endpoint=False))
    z += [z_far] * n_turn
    n_back = n_forward + n_rejoin
    yaw += [np.pi] * n_back
    z += list(z_far - np.arange(1, n_back + 1) * speed)
    yaw += list(np.linspace(np.pi, 2 * np.pi, n_turn, endpoint=False))
    z += [z_far - n_back * speed] * n_turn
    yaw += [2 * np.pi] * n_rejoin
    z += list(z_far - n_back * speed + np.arange(1, n_rejoin + 1) * speed)
    yaw = np.asarray(yaw, np.float32)
    z = np.asarray(z, np.float32)
    cy, sy = np.cos(yaw), np.sin(yaw)
    zero, one = np.zeros_like(cy), np.ones_like(cy)
    R = np.stack([np.stack([cy, zero, sy], -1), np.stack([zero, one, zero], -1), np.stack([-sy, zero, cy], -1)], -2)
    t = np.stack([zero, zero, z], axis=-1)
    return se3_matrix(torch.as_tensor(R, device=device), torch.as_tensor(t, device=device))


class SyntheticSequence(NamedTuple):
    images_left: torch.Tensor  # (N, H, W) float32 [0, 255]
    images_right: torch.Tensor  # (N, H, W)
    depths_left: torch.Tensor  # (N, H, W)
    T_world_cam: torch.Tensor  # (N, 4, 4) left-camera poses
    timestamps: np.ndarray  # (N,) float64
    rig: StereoRig


def render_stereo(world, Ts: torch.Tensor, rig: StereoRig, height: int, width: int, chunk: int = 8):
    """Left and right images and the left z-depth of poses (N, 4, 4), rendered
    ``chunk`` frames at a time on the poses' device."""
    from forest_slam_tpu_torch.core.lie import se3_compose

    il, ir, dl = [], [], []
    for s in range(0, Ts.shape[0], chunk):
        T = Ts[s:s + chunk]
        img, dep = render_view(world, T, rig.left.K, height, width)
        il.append(img)
        dl.append(dep)
        ir.append(render_view(world, se3_compose(T, rig.T_left_right), rig.left.K, height, width)[0])
    return torch.cat(il), torch.cat(ir), torch.cat(dl)


def render_sequence(n_frames: int, height: int = 120, width: int = 160, seed: int = 0, speed: float = 0.15,
                    dt: float = 0.1, scene: str = "corridor", device="cuda") -> SyntheticSequence:
    """A stereo sequence along :func:`corridor_trajectory` through the
    corridor or the forest (its trunks spread to ``n_frames * speed + 20``
    m ahead), rendered on ``device``."""
    rig = default_rig(height, width, device=device)
    if scene == "forest":
        world = make_forest_world(seed, z_range=(-5.0, n_frames * speed + 20.0), device=device)
    elif scene == "corridor":
        world = make_corridor_world(seed, device=device)
    else:
        raise ValueError(f"unknown scene {scene!r}")
    Ts = corridor_trajectory(n_frames, speed=speed, device=device)
    il, ir, dl = render_stereo(world, Ts, rig, height, width)
    return SyntheticSequence(images_left=il, images_right=ir, depths_left=dl, T_world_cam=Ts,
                             timestamps=1.6e9 + np.arange(n_frames) * dt, rig=rig)
