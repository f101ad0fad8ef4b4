"""Stereo rectification (Bouguet; port of stereo/rectify.py).

The reference never rectifies: it undistorts both cameras and reads the
disparity map at raw keypoint pixels, which works only because its rig is
nearly fronto-parallel (quirk B3). This module splits the inter-camera
rotation evenly, turns both cameras so the baseline becomes +x, builds the
dst -> src remap grids on the host in numpy (per-calibration constants)
and remaps the frames on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig, remap_bilinear


class RectifiedStereo(NamedTuple):
    rig: StereoRig  # rectified rig: identity rotation, x-only baseline
    R_left: np.ndarray  # (3, 3) original-left -> rectified rotation
    R_right: np.ndarray  # (3, 3)
    map_left: torch.Tensor  # (H, W, 2) dst -> src sampling grid (x, y)
    map_right: torch.Tensor


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def _distort(pts: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Forward Brown-Conrady distortion of normalised (N, 2) points."""
    k1, k2, p1, p2, k3 = dist
    x, y = pts[:, 0], pts[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=1)


def _rotvec_to_rotmat(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _rotmat_to_rotvec(R: np.ndarray) -> np.ndarray:
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2 * np.sin(th)) * th


def _rect_map(cam: PinholeCamera, R: np.ndarray, K_new: np.ndarray) -> np.ndarray:
    """(H, W, 2) grid: rectified pixel -> original distorted pixel."""
    H, W = cam.height, cam.width
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)], axis=0)
    rays = R.T @ (np.linalg.inv(K_new) @ pts)  # back into the original camera frame
    dist = _distort(np.stack([rays[0] / rays[2], rays[1] / rays[2]], axis=1), _np(cam.dist))
    K = _np(cam.K)
    u = K[0, 0] * dist[:, 0] + K[0, 2]
    v = K[1, 1] * dist[:, 1] + K[1, 2]
    return np.stack([u, v], axis=1).reshape(H, W, 2)


def stereo_rectify(rig: StereoRig) -> RectifiedStereo:
    """Bouguet rectification of ``rig``; the rectified rig and the maps
    live on the rig's device."""
    dev = rig.left.K.device
    T = _np(rig.T_left_right)  # right -> left
    t = T[:3, 3]  # the right camera's origin in left coordinates
    # with R_rl = exp(w): left turned by exp(-w/2), right by exp(+w/2)
    R_half = _rotvec_to_rotmat(_rotmat_to_rotvec(T[:3, :3]) * 0.5)
    r_l, r_r = R_half.T, R_half
    # the common frame's +x along the baseline
    e1 = r_l @ t
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    R_align = np.stack([e1, e2, np.cross(e1, e2)], axis=0)
    R_left, R_right = R_align @ r_l, R_align @ r_r

    H, W = rig.left.height, rig.left.width
    K_new = np.array([[float(rig.left.fx), 0, W / 2.0 - 0.5], [0, float(rig.left.fy), H / 2.0 - 0.5], [0, 0, 1.0]])
    cam_new = PinholeCamera.create(K_new, None, W, H, device=dev)
    T_lr = np.eye(4)
    T_lr[0, 3] = np.linalg.norm(t)
    as_map = lambda m: torch.as_tensor(m, dtype=torch.float32, device=dev)
    return RectifiedStereo(
        rig=StereoRig(left=cam_new, right=cam_new, T_left_right=torch.as_tensor(T_lr, dtype=torch.float32, device=dev)),
        R_left=R_left, R_right=R_right,
        map_left=as_map(_rect_map(rig.left, R_left, K_new)), map_right=as_map(_rect_map(rig.right, R_right, K_new)),
    )


def rectify_images(rect: RectifiedStereo, images_l, images_r) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) raw stacks (arrays or tensors) remapped into the rectified
    frame on the maps' device."""
    dev = rect.map_left.device
    as_t = lambda x: torch.as_tensor(x if isinstance(x, torch.Tensor) else np.array(x), dtype=torch.float32,
                                     device=dev)
    return remap_bilinear(as_t(images_l), rect.map_left), remap_bilinear(as_t(images_r), rect.map_right)
