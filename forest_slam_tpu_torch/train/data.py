"""Self-supervised training data for the learned front end (port of
train/data.py).

Synthetic geometric scenes with exact corner labels (MagicPoint-style) and
value-noise textures labelled by the Harris teacher, each warped by a random
homography into a correspondence-labelled pair; and 3D-supervised pairs
rendered from random corridor (or forest) worlds with a forward step,
labelled through true depth and pose, drawn from a pool rendered once per
run. Everything is batched and runs on the batch's device.

Every function takes its random numbers as a ``*Draws`` tuple, in the
distribution the reference draws them in; the ``*_draws`` functions make
them from a ``torch.Generator`` on the device, and a test hands both
packages the same numbers. :func:`make_training_batch` is the generator
entry point.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.core.camera import backproject_depth, project_points, remap_bilinear
from forest_slam_tpu_torch.core.lie import mm, mv, se3_matrix, so3_exp
from forest_slam_tpu_torch.frontend.fast import harris_response, interior_mask, nms_topk, top_k
from forest_slam_tpu_torch.utils.filters import resize_bilinear


class TrainingBatch(NamedTuple):
    image0: torch.Tensor  # (B, H, W) [0, 255]
    image1: torch.Tensor  # (B, H, W)
    corners0: torch.Tensor  # (B, M, 2) xy in image0
    corners1: torch.Tensor  # (B, M, 2) xy in image1
    valid0: torch.Tensor  # (B, M) corner visible in image0
    valid1: torch.Tensor  # (B, M) corner visible in image1
    # matchable = valid0 & valid1; valid0-only corners are dustbin ground truth


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _cat(parts):
    return TrainingBatch(*(torch.cat(xs) for xs in zip(*parts)))


# --- corner scenes -----------------------------------------------------------

class CornerDraws(NamedTuple):
    """Draws of B rectangle scenes of S shapes each."""

    bg: torch.Tensor  # (B, H, W) uniform [0, 1): the noise background
    centers: torch.Tensor  # (B, S, 2) pixels, in the central 80%
    sizes: torch.Tensor  # (B, S, 2) pixels
    angles: torch.Tensor  # (B, S) in [0, pi)
    intensities: torch.Tensor  # (B, S) in [0, 255)
    order: torch.Tensor  # (B, 4S) uniform [0, 1): which corners a full set keeps


def corner_draws(gen, batch: int, height: int, width: int, n_shapes: int = 12, device="cuda") -> CornerDraws:
    S = n_shapes
    lo = torch.tensor([width * 0.1, height * 0.1], device=device)
    hi = torch.tensor([width * 0.9, height * 0.9], device=device)
    m = min(height, width)
    return CornerDraws(
        bg=torch.rand((batch, height, width), generator=gen, device=device),
        centers=_uniform(gen, (batch, S, 2), lo, hi, device),
        sizes=_uniform(gen, (batch, S, 2), m * 0.08, m * 0.35, device),
        angles=_uniform(gen, (batch, S), 0.0, math.pi, device),
        intensities=_uniform(gen, (batch, S), 0.0, 255.0, device),
        order=torch.rand((batch, 4 * S), generator=gen, device=device),
    )


def corner_image(draws: CornerDraws, height: int, width: int) -> torch.Tensor:
    """(B, H, W) rotated rectangles painted on a noise background in [0,
    255]; later shapes paint over earlier ones."""
    dev = draws.bg.device
    img = draws.bg * 40.0 + 60.0
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ca, sa = torch.cos(draws.angles), torch.sin(draws.angles)  # (B, S)
    for s in range(draws.angles.shape[1]):  # in paint order
        col = lambda t: t[:, s, None, None]
        dx = xs - draws.centers[:, s, 0, None, None]
        dy = ys - draws.centers[:, s, 1, None, None]
        u = col(ca) * dx + col(sa) * dy
        v = -col(sa) * dx + col(ca) * dy
        inside = (u.abs() <= draws.sizes[:, s, 0, None, None] / 2) & (v.abs() <= draws.sizes[:, s, 1, None, None] / 2)
        img = torch.where(inside, col(draws.intensities), img)
    return img


def random_corner_image(draws: CornerDraws, height: int, width: int, max_corners: int = 48):
    """Rotated rectangles on a noise background (:func:`corner_image`) and
    their corners: (images (B, H, W) in [0, 255], corners (B, M, 2) xy,
    valid (B, M)). Occluded corners stay labelled (label noise, as in
    homographic adaptation). With 4S >= M a random subset is kept, in-bounds
    corners first."""
    dev = draws.bg.device
    B, S = draws.angles.shape
    img = corner_image(draws, height, width)
    ca, sa = torch.cos(draws.angles), torch.sin(draws.angles)
    # 4 corners a shape: centre + R (+-w/2, +-h/2), R mapping local -> image
    signs = torch.tensor([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=torch.float32, device=dev)
    local = signs[None, None] * (draws.sizes[:, :, None, :] / 2)  # (B, S, 4, 2)
    c4, s4 = ca[..., None], sa[..., None]
    corners = draws.centers[:, :, None, :] + torch.stack(
        [c4 * local[..., 0] - s4 * local[..., 1], s4 * local[..., 0] + c4 * local[..., 1]], dim=-1)
    corners = corners.reshape(B, 4 * S, 2)
    in_bounds = ((corners[..., 0] >= 4) & (corners[..., 0] < width - 4)
                 & (corners[..., 1] >= 4) & (corners[..., 1] < height - 4))
    n = 4 * S
    if n >= max_corners:
        _, keep = top_k(in_bounds.float() + draws.order, max_corners)
        corners = corners.gather(1, keep[..., None].expand(-1, -1, 2))
        in_bounds = in_bounds.gather(1, keep)
    else:
        pad = max_corners - n
        corners = torch.cat([corners, corners.new_zeros((B, pad, 2))], dim=1)
        in_bounds = torch.cat([in_bounds, in_bounds.new_zeros((B, pad))], dim=1)
    return img, corners, in_bounds


# --- homographies ------------------------------------------------------------

class HomographyDraws(NamedTuple):
    angle: torch.Tensor  # (B,) rotation, +-max_rotation
    log_scale: torch.Tensor  # (B,) +-max_scale
    shift: torch.Tensor  # (B, 2) +-max_translation, in image widths/heights
    perspective: torch.Tensor  # (B, 2) +-max_perspective


def homography_draws(gen, batch: int, max_rotation: float = 0.35, max_scale: float = 0.25,
                     max_translation: float = 0.12, max_perspective: float = 3e-4, device="cuda") -> HomographyDraws:
    return HomographyDraws(
        angle=_uniform(gen, (batch,), -max_rotation, max_rotation, device),
        log_scale=_uniform(gen, (batch,), -max_scale, max_scale, device),
        shift=_uniform(gen, (batch, 2), -max_translation, max_translation, device),
        perspective=_uniform(gen, (batch, 2), -max_perspective, max_perspective, device),
    )


def random_homography(draws: HomographyDraws, height: int, width: int) -> torch.Tensor:
    """(B, 3, 3) homographies image0 -> image1, composed about the image
    centre: Cinv @ P @ A @ C with A a similarity plus shift, P perspective."""
    dev = draws.angle.device
    s = torch.exp(draws.log_scale)
    t = draws.shift * torch.tensor([width, height], dtype=torch.float32, device=dev)
    ca, sa = torch.cos(draws.angle), torch.sin(draws.angle)
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    cx, cy = width / 2.0, height / 2.0
    C = torch.tensor([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], dtype=torch.float32, device=dev)
    Cinv = torch.tensor([[1, 0, cx], [0, 1, cy], [0, 0, 1]], dtype=torch.float32, device=dev)
    A = torch.stack([s * ca, -s * sa, t[:, 0], s * sa, s * ca, t[:, 1], zero, zero, one], -1).reshape(-1, 3, 3)
    p = draws.perspective
    P = torch.stack([one, zero, zero, zero, one, zero, p[:, 0], p[:, 1], one], -1).reshape(-1, 3, 3)
    return mm(mm(mm(Cinv, P), A), C)


def apply_homography(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., N, 2) -> (..., N, 2)."""
    q = mv(Hm[..., None, :, :], torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1))
    w = q[..., 2:3]
    return q[..., :2] / torch.clamp(w.abs(), min=1e-9) * torch.sign(w)


def _inverse3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by the adjugate: elementwise ops
    only, where ``torch.linalg.inv`` reads its error flags back to the host
    (a synchronisation every step on the card)."""
    a, b, c, d, e, f, g, h, i = m.reshape(m.shape[:-2] + (9,)).unbind(-1)
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], -1)
    det = a * adj[..., 0] + b * adj[..., 3] + c * adj[..., 6]
    return (adj / det[..., None]).reshape(m.shape)


def warp_image(images: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """(B, H, W) warped so that warped(H(p)) = image(p): each destination
    pixel mapped through H^-1 and sampled bilinearly (zeros outside)."""
    B, height, width = images.shape
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    dst = torch.stack([gx, gy], dim=-1).reshape(1, -1, 2)
    src = apply_homography(_inverse3(Hm), dst).reshape(B, height, width, 2)
    return remap_bilinear(images, src)


# --- teacher-labelled textures -----------------------------------------------

class TextureDraws(NamedTuple):
    coarse: torch.Tensor  # (B, H/8, W/8) uniform [0, 1)
    mid: torch.Tensor  # (B, H/2, W/2)
    fine: torch.Tensor  # (B, H, W)


def texture_draws(gen, batch: int, height: int, width: int, device="cuda") -> TextureDraws:
    r = lambda h, w: torch.rand((batch, h, w), generator=gen, device=device)
    return TextureDraws(coarse=r(height // 8, width // 8), mid=r(height // 2, width // 2), fine=r(height, width))


def teacher_points(images: torch.Tensor, max_corners: int):
    """Harris teacher (block 7) on (B, H, W) images, 8 px from the border,
    3x3 NMS and top-k: (xy (B, M, 2), valid (B, M))."""
    H, W = images.shape[-2:]
    score = harris_response(images, 7)
    score = torch.where(interior_mask(H, W, 8, images.device), score, torch.zeros_like(score))
    xy, _, valid = nms_topk(score, max_corners)
    return xy, valid


def texture_image(draws: TextureDraws, height: int, width: int) -> torch.Tensor:
    """(B, H, W) multi-octave value noise in [0, 255]: coarse blobs + fine
    grain, each octave upsampled bilinearly."""
    up = lambda t: resize_bilinear(t, height, width)
    return (0.55 * up(draws.coarse) + 0.3 * up(draws.mid) + 0.15 * draws.fine) * 255.0


def random_texture_image(draws: TextureDraws, height: int, width: int, max_corners: int = 48):
    """:func:`texture_image` labelled by the Harris teacher: (images,
    corners, valid)."""
    img = texture_image(draws, height, width)
    xy, valid = teacher_points(img, max_corners)
    return img, xy, valid


# --- 3D-supervised corridor pairs ----------------------------------------------

class CorridorDraws(NamedTuple):
    """One pair's viewpoint draws."""

    p0: torch.Tensor  # (3,) view-0 position
    w0: torch.Tensor  # (3,) view-0 attitude (axis-angle)
    forward: torch.Tensor  # () forward step along view 0's optical axis, metres
    lateral: torch.Tensor  # (2,) sideways and vertical jitter of view 1
    w1: torch.Tensor  # (3,) view-1 attitude jitter


def corridor_draws(gen, min_forward: float = 0.15, max_forward: float = 3.0, device="cuda") -> CorridorDraws:
    t = lambda *a: torch.tensor(a, dtype=torch.float32, device=device)
    return CorridorDraws(
        p0=_uniform(gen, (3,), t(-2.0, -0.4, 0.0), t(2.0, 0.4, 20.0), device),
        w0=_uniform(gen, (3,), t(-0.08, -0.3, -0.05), t(0.08, 0.3, 0.05), device),
        forward=_uniform(gen, (), min_forward, max_forward, device),
        lateral=_uniform(gen, (2,), -0.15, 0.15, device),
        w1=_uniform(gen, (3,), -0.06, 0.06, device),
    )


def corridor_pair(world, draws: CorridorDraws, height: int, width: int, max_corners: int = 48) -> TrainingBatch:
    """One noise-free pair (a batch of 1) of a CorridorWorld or ForestWorld:
    view 0 at a random station, view 1 a forward step ahead; Harris-teacher
    points of view 0 carried to view 1 through the rendered depth and the
    true relative pose, kept where they land inside view 1 and its rendered
    depth agrees (occlusion)."""
    from forest_slam_tpu_torch.io.synthetic import default_rig, render_view

    dev = draws.p0.device
    cam = default_rig(height, width, device=dev).left
    R0 = so3_exp(draws.w0)
    p1 = draws.p0 + mv(R0, torch.stack([draws.lateral[0], draws.lateral[1], draws.forward]))
    R1 = mm(R0, so3_exp(draws.w1))
    T = se3_matrix(torch.stack([R0, R1]), torch.stack([draws.p0, p1]))
    imgs, depths = render_view(world, T, cam.K, height, width)

    xy0, valid0 = teacher_points(imgs[:1], max_corners)
    xy0, valid0 = xy0[0], valid0[0]
    xi = xy0[:, 0].long().clamp(0, width - 1)
    yi = xy0[:, 1].long().clamp(0, height - 1)
    z0 = depths[0, yi, xi]
    valid0 = valid0 & torch.isfinite(z0) & (z0 > 0.1) & (z0 < 60.0)
    z0 = torch.where(valid0, z0, torch.ones_like(z0))
    pts_world = mv(R0[None], backproject_depth(xy0, z0, cam)) + draws.p0
    pts_cam1 = mv(R1.t()[None], pts_world - p1)
    xy1 = project_points(pts_cam1, cam, with_distortion=False)
    z1 = pts_cam1[:, 2]
    in1 = ((xy1[:, 0] >= 4) & (xy1[:, 0] < width - 4) & (xy1[:, 1] >= 4) & (xy1[:, 1] < height - 4) & (z1 > 0.05))
    x1i = torch.round(xy1[:, 0]).long().clamp(0, width - 1)
    y1i = torch.round(xy1[:, 1]).long().clamp(0, height - 1)
    visible = (depths[1, y1i, x1i] - z1).abs() < torch.clamp(0.03 * z1, min=0.05)
    return TrainingBatch(imgs[:1], imgs[1:], xy0[None], xy1[None], valid0[None], (valid0 & in1 & visible)[None])


def _smooth(t: torch.Tensor, axis: int, reps: int = 1) -> torch.Tensor:
    """``reps`` passes of the [0.25, 0.5, 0.25] 'same' convolution along
    ``axis`` of a 2D tensor (io/synthetic.py's texture smoothing)."""
    n = t.shape[axis]
    for _ in range(reps):
        p = F.pad(t, (1, 1, 0, 0) if axis == 1 else (0, 0, 1, 1))
        t = 0.25 * p.narrow(axis, 0, n) + 0.5 * p.narrow(axis, 1, n) + 0.25 * p.narrow(axis, 2, n)
    return t


def random_world(gen, scene: str, texture_px: int = 1024, device="cuda"):
    """A corridor with three smoothed-noise textures drawn on the device, or
    a forest of io/synthetic.py from a numpy seed drawn from ``gen``."""
    from forest_slam_tpu_torch.io.synthetic import make_corridor_world, make_forest_world

    if scene == "forest":
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=device).item())
        return make_forest_world(seed, device=device)
    if scene != "corridor":
        raise ValueError(f"unknown scene {scene!r}")
    tex = torch.stack([_smooth(_smooth(_uniform(gen, (texture_px, texture_px), 0.0, 255.0, device), 0), 1)
                       for _ in range(3)])
    return make_corridor_world(textures=tex, device=device)


def make_corridor_pool(gen, n_pairs: int, height: int, width: int, max_corners: int = 48, chunk: int = 32,
                       scene: str = "corridor", forest_share: float = 0.5, min_forward: float = 0.15,
                       max_forward: float = 3.0, device="cuda") -> TrainingBatch:
    """Noise-free 3D-supervised pairs, each its own world, viewpoint and
    forward gap, stacked on axis 0 (rounded up to whole ``chunk``s).
    ``scene`` "mix" interleaves forest and corridor chunks to
    ``forest_share`` of the pool."""
    if scene not in ("corridor", "forest", "mix"):
        raise ValueError(f"unknown scene {scene!r}")
    n_pairs = -(-n_pairs // chunk) * chunk
    pairs, forest_cum = [], 0
    for ci in range(n_pairs // chunk):
        sc = scene
        if scene == "mix":
            sc = "forest" if forest_cum < int(round((ci + 1) * forest_share)) else "corridor"
            forest_cum += sc == "forest"
        for _ in range(chunk):
            world = random_world(gen, sc, device=device)
            pairs.append(corridor_pair(world, corridor_draws(gen, min_forward, max_forward, device),
                                       height, width, max_corners))
    return _cat(pairs)


# --- batches -------------------------------------------------------------------

class BatchDraws(NamedTuple):
    """Draws of one batch: the pool entries and their noise, then the
    texture pairs and the corner pairs (scene, homography, pixel noise)."""

    pool_index: torch.Tensor  # (n_cor,) int64
    pool_noise0: torch.Tensor  # (n_cor, H, W) standard normal
    pool_noise1: torch.Tensor
    texture: TextureDraws
    texture_homography: HomographyDraws
    texture_noise: torch.Tensor  # (n_tex, H, W) standard normal
    corner: CornerDraws
    corner_homography: HomographyDraws
    corner_noise: torch.Tensor  # (n_rest, H, W)


def batch_split(batch: int, texture_fraction: float, corridor_fraction: float) -> tuple[int, int, int]:
    """(corridor, texture, corner) pairs of a batch, as the reference rounds."""
    n_cor = int(round(batch * corridor_fraction))
    n_tex = min(int(round(batch * texture_fraction)), batch - n_cor)
    return n_cor, n_tex, batch - n_cor - n_tex


def batch_draws(gen, batch: int, height: int, width: int, texture_fraction: float, corridor_fraction: float,
                pool_size: int, device="cuda") -> BatchDraws:
    n_cor, n_tex, n_rest = batch_split(batch, texture_fraction, corridor_fraction)
    if not pool_size:
        n_cor = 0
    normal = lambda n: torch.randn((n, height, width), generator=gen, device=device)
    return BatchDraws(
        pool_index=torch.randint(0, max(pool_size, 1), (n_cor,), generator=gen, device=device),
        pool_noise0=normal(n_cor), pool_noise1=normal(n_cor),
        texture=texture_draws(gen, n_tex, height, width, device),
        texture_homography=homography_draws(gen, n_tex, device=device), texture_noise=normal(n_tex),
        corner=corner_draws(gen, n_rest, height, width, device=device),
        corner_homography=homography_draws(gen, n_rest, device=device), corner_noise=normal(n_rest),
    )


def homography_pairs(img0, corners, cvalid, hdraws: HomographyDraws, noise) -> TrainingBatch:
    """Pairs of scenes and their warps: pixel noise (sigma 2) on both views,
    rows reversed on view 1; corners visible in view 1 within 4 px of its
    border."""
    _, height, width = img0.shape
    Hm = random_homography(hdraws, height, width)
    img1 = warp_image(img0, Hm)
    corners1 = apply_homography(Hm, corners)
    in1 = ((corners1[..., 0] >= 4) & (corners1[..., 0] < width - 4)
           & (corners1[..., 1] >= 4) & (corners1[..., 1] < height - 4))
    noise = noise * 2.0
    return TrainingBatch(image0=torch.clamp(img0 + noise, 0, 255), image1=torch.clamp(img1 + noise.flip(-2), 0, 255),
                         corners0=corners, corners1=corners1, valid0=cvalid, valid1=cvalid & in1)


def training_batch(draws: BatchDraws, height: int, width: int, max_corners: int = 48,
                   corridor_pool: TrainingBatch | None = None) -> TrainingBatch:
    """A batch from its draws: pool pairs with fresh noise, then texture
    pairs, then corner pairs."""
    parts = []
    if draws.pool_index.numel():
        drawn = TrainingBatch(*(t[draws.pool_index] for t in corridor_pool))
        parts.append(drawn._replace(image0=torch.clamp(drawn.image0 + draws.pool_noise0 * 2.0, 0, 255),
                                    image1=torch.clamp(drawn.image1 + draws.pool_noise1 * 2.0, 0, 255)))
    if draws.texture_noise.shape[0]:
        img, xy, valid = random_texture_image(draws.texture, height, width, max_corners)
        parts.append(homography_pairs(img, xy, valid, draws.texture_homography, draws.texture_noise))
    if draws.corner_noise.shape[0]:
        img, xy, valid = random_corner_image(draws.corner, height, width, max_corners)
        parts.append(homography_pairs(img, xy, valid, draws.corner_homography, draws.corner_noise))
    return _cat(parts)


def make_training_batch(gen, batch: int, height: int, width: int, max_corners: int = 48,
                        texture_fraction: float = 0.5, corridor_fraction: float = 0.0,
                        corridor_pool: TrainingBatch | None = None, device="cuda") -> TrainingBatch:
    """A batch of correspondence-labelled pairs drawn from ``gen``: a
    ``corridor_fraction`` share of 3D-supervised corridor pairs (from
    ``corridor_pool`` with fresh noise, rendered now where there is no
    pool), a ``texture_fraction`` share of teacher-labelled texture pairs,
    the rest corner scenes."""
    pool_size = 0 if corridor_pool is None else corridor_pool.image0.shape[0]
    draws = batch_draws(gen, batch, height, width, texture_fraction, corridor_fraction, pool_size, device)
    out = training_batch(draws, height, width, max_corners, corridor_pool)
    n_cor = batch_split(batch, texture_fraction, corridor_fraction)[0]
    if n_cor and corridor_pool is None:
        fresh = make_corridor_pool(gen, n_cor, height, width, max_corners, chunk=1, device=device)
        fresh = fresh._replace(
            image0=torch.clamp(fresh.image0 + torch.randn(fresh.image0.shape, generator=gen, device=device) * 2.0, 0, 255),
            image1=torch.clamp(fresh.image1 + torch.randn(fresh.image1.shape, generator=gen, device=device) * 2.0, 0, 255))
        out = _cat([fresh, out])
    return out
