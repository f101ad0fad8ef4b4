"""Sliding-window bundle adjustment of a VO trajectory (port of
backend/window.py).

The sequence is cut into windows of M frames that share their boundary
frames; in each, feature tracks are built from the VO's frame-to-frame
matches (a landmark starts at every frame for each keypoint that does not
continue a track), and with a front end each window's anchor features are
also matched directly against every other frame of the window, so the
anchor's landmarks are seen in all M frames. Each window's poses and
landmarks are refined by LM (backend/ba.py) in the window's own VO
coordinates; all windows solve as one batch (the 240 windows of 4,096
landmark slots of a 963-frame run allocate 3.46 GiB above what is held on an
H100: scripts/torch_window_ba_peak.py), and the trajectory is rebuilt from
each window's refined relative motion, a short chain over the windows. Frames past the last
whole window ride rigidly on its corrected boundary pose.

Pose products go through ``core/lie.py:mm`` (float32, no TF32), and the
input poses are re-rigidified on entry: the JAX package measured 0.5 m of
phantom drift from rotations de-orthonormalised by bf16 matmul passes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.backend.ba import BAProblem, ba_solve
from forest_slam_tpu_torch.core.camera import PinholeCamera, backproject_depth, project_points
from forest_slam_tpu_torch.core.lie import mm, se3_chain, se3_inverse, se3_orthonormalize
from forest_slam_tpu_torch.pipelines.stereo import _map

class StereoArtifacts(NamedTuple):
    """Per-frame and per-pair intermediates of the VO runner that the back
    end consumes (K = keypoint slots)."""

    xy: torch.Tensor  # (N, K, 2) level-0 keypoint coordinates
    valid: torch.Tensor  # (N, K) keypoint validity
    z: torch.Tensor  # (N, K) per-keypoint stereo depth
    z_ok: torch.Tensor  # (N, K) depth validity
    matches: torch.Tensor  # (N-1, K) frame i keypoint -> frame i+1 keypoint, or -1
    feats: Any = None  # the front end's whole feature tuple, leading axis = frames


def artifacts_from_numpy(art, device="cpu") -> StereoArtifacts:
    """The port's artifacts from another runner's, given as numpy arrays
    with the same field names (the JAX package's ``StereoArtifacts``): ORB
    features get the port's int64 descriptor words, SuperPoint features
    float32 descriptors."""
    from forest_slam_tpu_torch.frontend.orb import OrbFeatures
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointFeatures

    def t(a):
        a = np.array(a)
        if a.dtype.kind == "u":
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device)

    feats = None
    if art.feats is not None:
        fields = tuple(type(art.feats)._fields)
        cls = OrbFeatures if fields == OrbFeatures._fields else SuperPointFeatures
        if fields != cls._fields:
            raise ValueError(f"unknown feature fields {fields}")
        feats = cls(*(t(getattr(art.feats, f)) for f in fields))
        if cls is SuperPointFeatures:
            feats = feats._replace(desc=feats.desc.float())
    return StereoArtifacts(xy=t(art.xy).float(), valid=t(art.valid).bool(), z=t(art.z).float(),
                           z_ok=t(art.z_ok).bool(), matches=t(art.matches).long(), feats=feats)


class WindowBAConfig(NamedTuple):
    window: int = 5  # keyframes per window, the shared anchor included
    iters: int = 8  # LM iterations per window
    gate_px: float = 4.0  # drop observations whose initial reprojection error is above
    gate_depth_rel: float = 0.25  # drop depth measurements off by more than this
    min_obs: int = 2  # a landmark must be seen in this many frames
    depth_weight: float = 25.0  # see BAProblem.depth_weight
    min_depth: float = 0.1
    max_depth: float = 1000.0
    pose_prior_weight: float = 0.0  # see BAProblem.pose_prior_weight
    huber_px: float = 1.0  # see BAProblem.huber_px


class Tracks(NamedTuple):
    obs: torch.Tensor  # (W, M, P, 2) observation of landmark p in window frame j
    mask: torch.Tensor  # (W, M, P)
    z_obs: torch.Tensor  # (W, M, P)
    z_mask: torch.Tensor  # (W, M, P)


def _take(a, idx):
    """a (W, K, ...) at idx (W, K') along axis 1."""
    return a.gather(1, idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(idx.shape + a.shape[2:]))


def compose_tracks(xy_w, valid_w, matches_w, z_w, z_ok_w, cfg: WindowBAConfig) -> Tracks:
    """Track tables of a batch of windows, landmark k = frame-0 keypoint k:
    xy_w (W, M, K, 2), valid_w, z_w, z_ok_w (W, M, K), matches_w (W, M-1, K).
    A track follows the matches frame to frame; once a match is missing or
    lands on an invalid keypoint it stays dead."""
    W, M, K = valid_w.shape
    in_range = lambda z: (z > cfg.min_depth) & (z < cfg.max_depth)
    idx = torch.arange(K, device=xy_w.device).expand(W, K)
    z0 = z_w[:, 0]
    alive = valid_w[:, 0] & z_ok_w[:, 0] & in_range(z0)
    obs, mask, z_obs, z_mask = [xy_w[:, 0]], [alive], [z0], [alive]
    for j in range(1, M):
        nxt = _take(matches_w[:, j - 1], idx)
        alive = alive & (nxt >= 0)
        idx = torch.where(alive, nxt, torch.zeros_like(nxt))
        alive = alive & _take(valid_w[:, j], idx)
        zk = _take(z_w[:, j], idx)
        obs.append(_take(xy_w[:, j], idx))
        mask.append(alive)
        z_obs.append(zk)
        z_mask.append(alive & _take(z_ok_w[:, j], idx) & in_range(zk))
    return Tracks(*(torch.stack(x, dim=1) for x in (obs, mask, z_obs, z_mask)))


def _targeted(m_row, src_valid):
    """(W, K) keypoints of a frame that a valid match from the frame before
    lands on (the continuations of tracks)."""
    ok = (m_row >= 0) & src_valid
    idx = torch.where(ok, m_row, torch.zeros_like(m_row)).long()
    hit = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    return hit.scatter_reduce(1, idx, ok.int(), reduce="amax") > 0


def compose_tracks_multi(xy_w, valid_w, matches_w, z_w, z_ok_w, cfg: WindowBAConfig, include_anchor_start=True):
    """All-starts track tables of a batch of windows: a landmark starts at
    every frame j < M-1 (from 1 without ``include_anchor_start``) for each
    keypoint that no match from frame j-1 lands on. Returns (Tracks with
    P = (M-1) K or (M-2) K landmarks, start frame (W, P), anchor xy (W, P, 2),
    anchor z (W, P))."""
    W, M, K = valid_w.shape
    dev = xy_w.device
    parts = []
    for j in range(0 if include_anchor_start else 1, M - 1):
        # roll the window so frame j is row 0, compose, roll back, mask rows < j
        roll = lambda a: torch.roll(a, -j, dims=1)
        val_j = roll(valid_w)
        if j > 0:
            val_j = val_j.clone()
            val_j[:, 0] &= ~_targeted(matches_w[:, j - 1], valid_w[:, j - 1])
        tr = compose_tracks(roll(xy_w), val_j, roll(matches_w), roll(z_w), roll(z_ok_w), cfg)
        back = lambda a: torch.roll(a, j, dims=1)
        row_ok = (torch.arange(M, device=dev) >= j)[None, :, None]
        parts.append((back(tr.obs), back(tr.mask) & row_ok, back(tr.z_obs), back(tr.z_mask) & row_ok,
                      torch.full((W, K), j, dtype=torch.long, device=dev), xy_w[:, j], z_w[:, j]))
    cat = lambda i, ax: torch.cat([p[i] for p in parts], dim=ax)
    return Tracks(cat(0, 2), cat(1, 2), cat(2, 2), cat(3, 2)), cat(4, 1), cat(5, 1), cat(6, 1)


def anchor_rematch_table(art: StereoArtifacts, widx: torch.Tensor, frontend, image_shape, cfg: WindowBAConfig,
                         pair_batch: int = 48) -> Tracks:
    """Each window's anchor features matched directly against each other
    frame of the window, ``pair_batch`` pairs to a ``frontend.match`` call:
    landmark k = anchor keypoint k, seen wherever its match lands on a valid
    keypoint. widx (W, M) frame indices."""
    W, M = widx.shape
    in_range = lambda z: (z > cfg.min_depth) & (z < cfg.max_depth)
    src = widx[:, :1].expand(W, M - 1).reshape(-1)
    dst = widx[:, 1:].reshape(-1)
    matches = torch.cat([
        frontend.match(_map(lambda a: a[src[s:s + pair_batch]], art.feats),
                       _map(lambda a: a[dst[s:s + pair_batch]], art.feats), image_shape)
        for s in range(0, src.shape[0], pair_batch)]).long()  # (W (M-1), K)
    idx = torch.where(matches >= 0, matches, torch.zeros_like(matches))
    ok = (matches >= 0) & _take(art.valid[dst], idx)
    zk = _take(art.z[dst], idx)
    obs_r = _take(art.xy[dst], idx)
    zm_r = ok & _take(art.z_ok[dst], idx) & in_range(zk)
    K = matches.shape[-1]
    a = widx[:, 0]
    alive0 = art.valid[a] & art.z_ok[a] & in_range(art.z[a])  # (W, K)
    rest = lambda x: x.reshape((W, M - 1) + x.shape[1:])
    return Tracks(
        obs=torch.cat([art.xy[a][:, None], rest(obs_r)], dim=1),
        mask=torch.cat([alive0[:, None], rest(ok) & alive0[:, None]], dim=1),
        z_obs=torch.cat([art.z[a][:, None], rest(zk)], dim=1),
        z_mask=torch.cat([alive0[:, None], rest(zm_r) & alive0[:, None]], dim=1),
    )


def solve_windows(T_win, start, anchor_xy, anchor_z, tracks: Tracks, cam: PinholeCamera, cfg: WindowBAConfig):
    """Refine a batch of windows, each in its own VO coordinates: T_win
    (B, M, 4, 4) camera-to-world VO poses -> refined (B, M, 4, 4), a
    window's VO poses kept where its solve went non-finite or did not lower
    its cost. Landmarks are back-projected from each track's start frame;
    observations whose initial reprojection error or depth is already wild
    are dropped (mutual-NN mismatches survive track composition)."""
    pts_c = backproject_depth(anchor_xy, anchor_z, cam)  # (B, P, 3)
    T_anchor = _take(T_win, start)  # (B, P, 4, 4)
    pts_w = (T_anchor[..., :3, :3] * pts_c[..., None, :]).sum(-1) + T_anchor[..., :3, 3]
    T_cw = se3_inverse(T_win)
    pc = (T_cw[:, :, None, :3, :3] * pts_w[:, None, :, None, :]).sum(-1) + T_cw[:, :, None, :3, 3]
    err0 = torch.linalg.vector_norm(project_points(pc, cam, with_distortion=True) - tracks.obs, dim=-1)
    mask_g = tracks.mask & (err0 < cfg.gate_px) & (pc[..., 2] > cfg.min_depth)
    rel_z = (pc[..., 2] - tracks.z_obs).abs() / torch.clamp(tracks.z_obs, min=1e-6)
    zmask_g = tracks.z_mask & mask_g & (rel_z < cfg.gate_depth_rel)
    res = ba_solve(BAProblem(poses=T_cw, points=pts_w, observations=tracks.obs, mask=mask_g, cam=cam,
                             depths=tracks.z_obs, depth_mask=zmask_g, depth_weight=cfg.depth_weight,
                             pose_prior_weight=cfg.pose_prior_weight, huber_px=cfg.huber_px),
                   iters=cfg.iters, fix_first=True)
    T_ref = se3_inverse(res.poses)
    ok = (torch.isfinite(T_ref).flatten(1).all(1) & torch.isfinite(res.final_cost)
          & (res.final_cost <= res.initial_cost))
    return torch.where(ok[:, None, None, None], T_ref, T_win)


def window_tables(art: StereoArtifacts, n_frames: int, cfg: WindowBAConfig, frontend=None, image_shape=None,
                  pair_batch: int = 48):
    """Frame indices (W, M) of the windows and their tables: (tracks, start,
    anchor xy, anchor z), with the anchor's re-matched landmarks first when
    ``frontend`` is given and the artifacts carry features."""
    M = cfg.window
    stride = M - 1
    n_win = (n_frames - 1) // stride
    dev = art.xy.device
    starts = torch.arange(n_win, device=dev) * stride
    widx = starts[:, None] + torch.arange(M, device=dev)[None, :]
    midx = starts[:, None] + torch.arange(M - 1, device=dev)[None, :]
    xy_w, valid_w, z_w, z_ok_w = art.xy[widx], art.valid[widx], art.z[widx], art.z_ok[widx]
    rematch = frontend is not None and art.feats is not None
    tracks, start, anchor_xy, anchor_z = compose_tracks_multi(xy_w, valid_w, art.matches[midx].long(), z_w, z_ok_w,
                                                              cfg, include_anchor_start=not rematch)
    if rematch:
        ta = anchor_rematch_table(art, widx, frontend, image_shape, cfg, pair_batch)
        tracks = Tracks(*(torch.cat([a, b], dim=2) for a, b in zip(ta, tracks)))
        start = torch.cat([torch.zeros_like(start[:, :ta.mask.shape[-1]]), start], dim=1)
        anchor_xy = torch.cat([xy_w[:, 0], anchor_xy], dim=1)
        anchor_z = torch.cat([z_w[:, 0], anchor_z], dim=1)
    long_enough = tracks.mask.sum(1) >= cfg.min_obs  # (W, P)
    tracks = tracks._replace(mask=tracks.mask & long_enough[:, None])
    return widx, tracks, start, anchor_xy, anchor_z


@torch.no_grad()
def refine_trajectory_ba(poses: torch.Tensor, artifacts: StereoArtifacts, cam: PinholeCamera,
                         cfg: WindowBAConfig = WindowBAConfig(), frontend=None, image_shape=None,
                         pair_batch: int = 48) -> torch.Tensor:
    """Refine VO poses (N-1, 4, 4) camera-to-world of frames 1..N-1 with
    windowed BA; returns the refined (N-1, 4, 4). With ``frontend`` (and the
    ``image_shape`` its matcher takes, by default the camera's), anchor
    keyframes are re-matched against every frame of their window; without
    it, tracks come from the VO's matches alone. All windows solve as one
    batch."""
    M = cfg.window
    N = artifacts.valid.shape[0]
    poses = se3_orthonormalize(poses)
    T_wc = torch.cat([torch.eye(4, dtype=poses.dtype, device=poses.device)[None], poses])
    stride = M - 1
    n_win = max((N - 1) // stride, 0)
    if n_win == 0:
        return poses
    if image_shape is None:
        image_shape = (cam.height, cam.width)
    widx, tracks, start, anchor_xy, anchor_z = window_tables(artifacts, N, cfg, frontend, image_shape, pair_batch)
    T_ref = solve_windows(T_wc[widx], start, anchor_xy, anchor_z, tracks, cam, cfg)

    # the trajectory from each window's refined relative motion:
    # T[s + j] = anchor_s @ inv(T_ref[0]) @ T_ref[j], anchor_{s+1} = T[s + M - 1]
    rel = mm(se3_inverse(T_ref[:, :1]), T_ref)  # (W, M, 4, 4)
    anchors = se3_chain(rel[:, -1], initial=T_wc[0])  # anchor of window w + 1
    anchors = torch.cat([T_wc[:1], anchors[:-1]])
    refined = mm(anchors[:, None], rel)[:, 1:].reshape(n_win * stride, 4, 4)
    covered = n_win * stride
    delta_tail = mm(refined[-1], se3_inverse(T_wc[covered]))
    tail = mm(delta_tail, T_wc[covered + 1:])
    return torch.cat([refined, tail])
