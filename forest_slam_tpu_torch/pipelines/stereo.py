"""Stereo visual odometry, frame-parallel (port of pipelines/stereo.py's
batched and device runners).

Three phases over a stereo sequence (N, H, W):

1. per frame, in batches: features + per-keypoint depth, from sparse
   stereo at the keypoints or, with ``dense_depth``, from a dense SGM map
   read at them (the reference's parity path);
2. per pair, in batches: temporal match, SAD refinement of the
   observations, PnP-RANSAC and the acceptance gate;
3. chaining of the gated relative poses and world-frame map points.

The sequential runner (:func:`run_stereo_vo_scan`, the reference's loop)
carries a :class:`StereoState` from frame to frame, one frame a step, in
chunks (:func:`run_stereo_vo_chunk`) so a long sequence streams
(:func:`run_stereo_vo_streaming` writes each chunk's poses to a TUM file as
it lands). Its dense route keeps the previous frame's whole depth map and
reads it at the keypoints. As in the JAX package, it neither refines the
matches nor normalises the exposure. Each of its steps draws its PnP noise
in turn from the state's generator, so streaming in chunks gives the scan's
poses exactly; the batched runner draws a pair batch at a time, so the two
runners draw differently.

:func:`run_stereo_vo` is the host entry point (ORB by default; ``ba=`` adds
sliding-window bundle adjustment, backend/window.py);
:func:`run_stereo_vo_batched` (the chunked runner, which can gather a
virtual sequence one chunk at a time) and :func:`run_stereo_vo_device` (the
same loop over the stacks as given) take any front end and return, when
asked, the artifacts the back end consumes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import StereoRig, backproject_depth
from forest_slam_tpu_torch.core.lie import mm, se3_chain, se3_inverse, se3_matrix
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches_quality
from forest_slam_tpu_torch.geometry.pnp import solve_pnp_ransac
from forest_slam_tpu_torch.geometry.ransac import require_draws
from forest_slam_tpu_torch.io.tum import Trajectory
from forest_slam_tpu_torch.stereo.depth import backproject_keypoints, depth_at_keypoints, disparity_to_depth
from forest_slam_tpu_torch.stereo.disparity import SgmConfig, sgm_disparity
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig, sparse_depth_at_keypoints
from forest_slam_tpu_torch.utils import trace

# frames a dense-depth SGM call takes at once (the reference's
# ``lax.map(batch_size=2)``): about 1.1 GB of volumes a frame at 600x960, D=96
SGM_FRAME_BATCH = 2


class StereoConfig(NamedTuple):
    sparse: SparseStereoConfig = SparseStereoConfig()
    reproj_threshold_px: float = 1.0
    n_hypotheses: int = 1024
    min_points: int = 6
    # pose acceptance: inliers >= ratio * valid inputs (-1: 0.0 under
    # "parity", 0.15 under "odometry"), or >= min_inliers_absolute when a
    # ratio gate is in force
    min_inlier_ratio: float = -1.0
    min_inliers_absolute: int = 12
    refine_iters: int = 8
    compose_mode: str = "parity"
    min_depth: float = 0.1
    max_depth: float = 1000.0
    # SAD refinement of the observations (0 = off)
    match_refine_radius: int = 0
    match_refine_cost_path: str = "auto"
    # the default front end of run_stereo_vo: ORB and its Hamming gate
    orb: OrbConfig = OrbConfig()
    max_match_distance: int = 64
    # when refining: drop matches that fail the refinement's uniqueness gate
    # from the PnP input set (match_refine_filter), and bias the RANSAC
    # draws by the refinement's quality (pnp_quality_sampling)
    match_refine_filter: bool = True
    pnp_quality_sampling: bool = True
    # scale ratios the refinement searches (RefineConfig.scales)
    match_refine_scales: tuple = (1.0,)
    # per-frame exposure compensation at ingest (photo_normalize_stack)
    photo_norm: bool = False
    # PnP minimal solver: "dlt6" or "p3p"
    pnp_minimal: str = "dlt6"
    # dense SGM depth read at the keypoints (the reference's parity path)
    # in place of sparse stereo
    sgm: SgmConfig = SgmConfig()
    dense_depth: bool = False


class StereoStepOut(NamedTuple):
    pose: torch.Tensor  # (N-1, 4, 4) cumulative
    map_points: torch.Tensor  # (N-1, K, 3) world-frame points
    map_valid: torch.Tensor  # (N-1, K) bool
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


class PairVO(NamedTuple):
    """Frame-to-frame VO of a batch of pairs (no chaining)."""

    rel: torch.Tensor  # (P, 4, 4) gated relative transforms
    ok: torch.Tensor  # (P,)
    n_matches: torch.Tensor  # (P,)
    n_inliers: torch.Tensor  # (P,)
    pts3d: torch.Tensor  # (P, K, 3) previous-frame camera points
    valid: torch.Tensor  # (P, K) PnP input validity
    matches: torch.Tensor  # (P, K) previous -> current keypoint or -1
    obs: torch.Tensor  # (P, K, 2) current-frame observations fed to PnP


class FrameSlab(NamedTuple):
    feats: Any  # features, leading axis = frames
    z: torch.Tensor  # (N, K) per-keypoint depth
    z_ok: torch.Tensor  # (N, K) validity


def _map(fn, tup):
    return type(tup)(*(fn(a) for a in tup))


def _cat(parts):
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


def photo_normalize_stack(images: torch.Tensor) -> torch.Tensor:
    """Per-frame exposure compensation: each (H, W) frame remapped to mean
    127 and standard deviation 48, clipped to [0, 255]
    (pipelines/stereo.py:photo_normalize_stack)."""
    mean = images.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(images.std(dim=(-2, -1), correction=0, keepdim=True), min=1e-3)
    return torch.clamp((images - mean) / std * 48.0 + 127.0, 0.0, 255.0)


def dense_depth_at_keypoints(images_l, images_r, xy, rig: StereoRig, sgm: SgmConfig) -> torch.Tensor:
    """(B, K) depths of (B, K, 2) keypoints read from the SGM depth maps of
    (B, H, W) frames, ``SGM_FRAME_BATCH`` frames at a time."""
    zs = []
    for s in range(0, images_l.shape[0], SGM_FRAME_BATCH):
        part = slice(s, s + SGM_FRAME_BATCH)
        disp = sgm_disparity(images_l[part], images_r[part], sgm)
        zs.append(depth_at_keypoints(disparity_to_depth(disp, rig.left.fx, rig.baseline), xy[part]))
    return torch.cat(zs)


def frame_features(images_l, images_r, rig: StereoRig, cfg: StereoConfig, frontend: FrontendFns):
    """Features + per-keypoint depth for a batch of frames (B, H, W). Dense
    depths are all marked valid: the pair phase's depth gate drops the
    clamped ones, as the reference does."""
    with trace.span("fs.frontend.extract"):
        feats = frontend.extract(images_l)
    with trace.span("fs.stereo.depth"):
        if cfg.dense_depth:
            z = dense_depth_at_keypoints(images_l, images_r, feats.xy, rig, cfg.sgm)
            return feats, z, torch.ones_like(z, dtype=torch.bool)
        z, z_ok = sparse_depth_at_keypoints(images_l, images_r, feats.xy, rig.left.fx, rig.baseline, cfg.sparse)
    return feats, z, z_ok


def match_and_pnp(prev_feats, pts3d, depth_ok, cur_feats, rig: StereoRig, cfg: StereoConfig,
                  frontend: FrontendFns, image_shape, img_prev=None, img_cur=None,
                  generator: torch.Generator | None = None, gumbel=None, uniform=None) -> PairVO:
    """Temporal match -> (refinement) -> PnP-RANSAC -> gated relative pose,
    for a batch of pairs."""
    with trace.span("fs.frontend.match"):
        matches = frontend.match(prev_feats, cur_feats, image_shape)
        mask = matches >= 0
        idx = torch.where(mask, matches, torch.zeros_like(matches)).long()
        valid = mask & depth_ok & prev_feats.valid
        obs = cur_feats.xy.gather(1, idx[..., None].expand(-1, -1, 2))
    weights = None
    if cfg.match_refine_radius > 0 and img_prev is not None:
        with trace.span("fs.frontend.refine"):
            obs, ok_r, quality = refine_matches_quality(
                img_prev, img_cur, prev_feats.xy, obs, valid,
                RefineConfig(radius=cfg.match_refine_radius, cost_path=cfg.match_refine_cost_path,
                             scales=tuple(cfg.match_refine_scales)),
            )
            if cfg.match_refine_filter:
                valid = valid & ok_r
            if cfg.pnp_quality_sampling:
                # floor so no valid point is unsampleable on a flat valley
                weights = torch.clamp(quality, min=0.05)
    with trace.span("fs.pnp"):
        pnp = solve_pnp_ransac(
            pts3d, obs, valid, rig.left, generator=generator,
            reproj_threshold=cfg.reproj_threshold_px, n_hypotheses=cfg.n_hypotheses,
            min_inliers=cfg.min_points, refine_iters=cfg.refine_iters, weights=weights,
            gumbel=gumbel, uniform=uniform, minimal=cfg.pnp_minimal,
        )
    with trace.span("fs.stereo.gate"):
        n_valid = valid.sum(-1)
        ratio = cfg.min_inlier_ratio
        if ratio < 0:
            ratio = 0.0 if cfg.compose_mode == "parity" else 0.15
        ratio_ok = pnp.n_inliers >= ratio * torch.clamp(n_valid, min=1)
        if cfg.min_inliers_absolute > 0 and ratio > 0:
            ratio_ok = ratio_ok | (pnp.n_inliers >= cfg.min_inliers_absolute)
        ok = pnp.ok & (n_valid >= cfg.min_points) & ratio_ok
        rel = se3_matrix(pnp.R, pnp.t)
        if cfg.compose_mode == "odometry":
            rel = se3_inverse(rel)
        rel = torch.where(ok[:, None, None], rel, torch.eye(4, device=rel.device).expand_as(rel))
    return PairVO(rel=rel, ok=ok, n_matches=mask.sum(-1), n_inliers=pnp.n_inliers, pts3d=pts3d,
                  valid=valid, matches=matches, obs=obs)


def pair_from_slab(pf, pz, pok, cf, rig, cfg, frontend, image_shape, img_prev=None, img_cur=None,
                   generator=None, gumbel=None, uniform=None) -> PairVO:
    """VO of a batch of pairs from per-keypoint slab entries."""
    pts3d = backproject_depth(pf.xy, pz, rig.left)
    depth_ok = pok & (pz > cfg.min_depth) & (pz < cfg.max_depth)
    return match_and_pnp(pf, pts3d, depth_ok, cf, rig, cfg, frontend, image_shape, img_prev, img_cur,
                         generator, gumbel, uniform)


def chain_and_map(pairs: PairVO, initial: torch.Tensor) -> StereoStepOut:
    """Pose chaining + world-frame map points."""
    cums = se3_chain(pairs.rel, initial=initial)
    world = mm(pairs.pts3d, cums[:, :3, :3].transpose(1, 2)) + cums[:, None, :3, 3]
    return StereoStepOut(
        pose=cums,
        map_points=world,
        map_valid=pairs.valid & pairs.ok[:, None],
        n_matches=pairs.n_matches,
        n_inliers=pairs.n_inliers,
        ok=pairs.ok,
    )


@torch.no_grad()
def run_stereo_vo_batched(images_l, images_r, rig: StereoRig, cfg: StereoConfig, generator: torch.Generator | None,
                          frontend: FrontendFns, frame_chunk: int = 32, pair_chunk: int = 64, frame_indices=None,
                          return_artifacts: bool = False, gumbel=None, uniform=None):
    """Whole-sequence VO of (N, H, W) stereo stacks in [0, 255] as a host
    loop over chunks (pipelines/stereo.py:run_stereo_vo_batched): features
    and depths a frame chunk at a time, then VO a pair chunk at a time, then
    the chain; frames 1..N-1 relative to frame 0. With ``frame_indices``
    ((M,) ints) it runs the virtual sequence ``images[frame_indices]``
    without building it: each chunk gathers its own frames. The PnP draws
    come from ``generator``, a pair chunk at a time, or, when it is None,
    from ``gumbel`` (M-1, n_hypotheses, K) and ``uniform`` (M-1, K). With
    ``cfg.photo_norm`` every frame is exposure-compensated first. With
    ``return_artifacts``: (outputs, backend.window.StereoArtifacts). The
    sequence, each chunk, the slab and the chain are spans
    (utils/trace.py); the chunks call ``frame_features`` and
    ``pair_from_slab`` through the module, where callers may wrap them."""
    require_draws(generator, gumbel, uniform)
    if cfg.photo_norm:
        images_l, images_r = photo_normalize_stack(images_l), photo_normalize_stack(images_r)
    idx = None if frame_indices is None else torch.as_tensor(frame_indices, dtype=torch.long, device=images_l.device)
    n = images_l.shape[0] if idx is None else idx.shape[0]

    def frames(stack, s, e):
        return stack[s:e] if idx is None else stack[idx[s:e]]
    image_shape = tuple(images_l.shape[1:])
    with trace.sequence(images_l.device, frames=n, pairs=n - 1):
        parts = []
        for s in range(0, n, frame_chunk):
            with trace.span("fs.stereo.frame_chunk", frames=min(frame_chunk, n - s)):
                parts.append(frame_features(frames(images_l, s, s + frame_chunk), frames(images_r, s, s + frame_chunk),
                                            rig, cfg, frontend))
        with trace.span("fs.stereo.slab"):
            feats = _cat([p[0] for p in parts])
            slab = FrameSlab(feats, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))
        refine = cfg.match_refine_radius > 0
        outs = []
        for s in range(0, n - 1, pair_chunk):
            e = min(s + pair_chunk, n - 1)
            with trace.span("fs.stereo.pair_chunk", pairs=e - s):
                prev = FrameSlab(_map(lambda a: a[s:e], feats), slab.z[s:e], slab.z_ok[s:e])
                cur = _map(lambda a: a[s + 1:e + 1], feats)
                outs.append(pair_from_slab(
                    prev.feats, prev.z, prev.z_ok, cur, rig, cfg, frontend, image_shape,
                    frames(images_l, s, e) if refine else None, frames(images_l, s + 1, e + 1) if refine else None,
                    generator=generator, gumbel=None if gumbel is None else gumbel[s:e],
                    uniform=None if uniform is None else uniform[s:e],
                ))
        with trace.span("fs.stereo.chain"):
            pairs = _cat(outs)
            out = chain_and_map(pairs, torch.eye(4, device=images_l.device))
    if not return_artifacts:
        return out
    from forest_slam_tpu_torch.backend.window import StereoArtifacts

    return out, StereoArtifacts(xy=feats.xy, valid=feats.valid, z=slab.z, z_ok=slab.z_ok, matches=pairs.matches,
                                feats=feats)


def run_stereo_vo_device(images_l, images_r, rig: StereoRig, cfg: StereoConfig, generator: torch.Generator | None,
                         frontend: FrontendFns, frame_batch: int = 8, pair_batch: int = 8,
                         return_artifacts: bool = False, gumbel=None, uniform=None):
    """Whole-sequence VO of (N, H, W) stereo stacks (the JAX runner of one
    program, ``lax.map`` over batches): :func:`run_stereo_vo_batched` over
    the stacks as given, with frame and pair batches of ``frame_batch`` and
    ``pair_batch``. Equal batches and draws give the chunked runner's poses
    and flags bit for bit."""
    return run_stereo_vo_batched(images_l, images_r, rig, cfg, generator, frontend, frame_chunk=frame_batch,
                                 pair_chunk=pair_batch, return_artifacts=return_artifacts, gumbel=gumbel,
                                 uniform=uniform)


class StereoState(NamedTuple):
    """What the sequential runner carries from one frame to the next."""

    prev: Any  # previous frame's features (batch of one)
    prev_depth: torch.Tensor  # sparse: (1, K) per keypoint; dense: (1, H, W) depth map
    prev_depth_ok: torch.Tensor  # sparse: (1, K) validity; dense: (1, 1) unused
    cumulative: torch.Tensor  # (4, 4)
    generator: torch.Generator | None  # the PnP draws


def _depth_state(feats, img_l, img_r, rig: StereoRig, cfg: StereoConfig):
    """A frame's depth record for the state: (1, H, W) dense depth or the
    (1, K) sparse depths at its keypoints, with their validity."""
    if cfg.dense_depth:
        depth = disparity_to_depth(sgm_disparity(img_l, img_r, cfg.sgm), rig.left.fx, rig.baseline)
        return depth, torch.ones((1, 1), dtype=torch.bool, device=depth.device)
    return sparse_depth_at_keypoints(img_l, img_r, feats.xy, rig.left.fx, rig.baseline, cfg.sparse)


def _backproject_prev(state: StereoState, rig: StereoRig, cfg: StereoConfig):
    """The previous keypoints as camera-frame points, with their depth gate."""
    if cfg.dense_depth:
        return backproject_keypoints(state.prev.xy, state.prev_depth, rig.left, cfg.min_depth, cfg.max_depth)
    z = state.prev_depth
    ok = state.prev_depth_ok & (z > cfg.min_depth) & (z < cfg.max_depth)
    return backproject_depth(state.prev.xy, z, rig.left), ok


def stereo_vo_init(img_l, img_r, rig: StereoRig, cfg: StereoConfig, frontend: FrontendFns,
                   generator: torch.Generator | None) -> StereoState:
    """The state seeded from the first stereo frame (H, W) x2."""
    img_l, img_r = img_l[None], img_r[None]
    feats = frontend.extract(img_l)
    depth, depth_ok = _depth_state(feats, img_l, img_r, rig, cfg)
    return StereoState(prev=feats, prev_depth=depth, prev_depth_ok=depth_ok,
                       cumulative=torch.eye(4, device=img_l.device), generator=generator)


def stereo_step(state: StereoState, img_l, img_r, rig: StereoRig, cfg: StereoConfig, frontend: FrontendFns,
                gumbel=None, uniform=None) -> tuple[StereoState, StereoStepOut]:
    """One frame (H, W) x2 of the sequential runner: its features and depth
    record, the previous frame's keypoints back-projected through the
    previous depth, match and PnP, and the chained pose and map points
    (stereo_slam.py:210-314). ``gumbel`` (1, n_hypotheses, K) and ``uniform``
    (1, K) replace the draws of the state's generator, which is then None."""
    require_draws(state.generator, gumbel, uniform)
    img_l, img_r = img_l[None], img_r[None]
    feats = frontend.extract(img_l)
    depth, depth_ok = _depth_state(feats, img_l, img_r, rig, cfg)
    pts3d, prev_ok = _backproject_prev(state, rig, cfg)
    pair = match_and_pnp(state.prev, pts3d, prev_ok, feats, rig, cfg, frontend, tuple(img_l.shape[1:]),
                         generator=state.generator, gumbel=gumbel, uniform=uniform)
    cumulative = mm(state.cumulative, pair.rel[0])
    world = mm(pts3d, cumulative[:3, :3].transpose(0, 1)) + cumulative[:3, 3]
    out = StereoStepOut(pose=cumulative[None], map_points=world, map_valid=pair.valid & pair.ok[:, None],
                        n_matches=pair.n_matches, n_inliers=pair.n_inliers, ok=pair.ok)
    return state._replace(prev=feats, prev_depth=depth, prev_depth_ok=depth_ok, cumulative=cumulative), out


@torch.no_grad()
def run_stereo_vo_chunk(state: StereoState, images_l, images_r, rig: StereoRig, cfg: StereoConfig,
                        frontend: FrontendFns, gumbel=None, uniform=None) -> tuple[StereoState, StereoStepOut]:
    """Advance the sequential runner over a chunk of (C, H, W) frames,
    carrying the state across chunks; ``gumbel`` (C, n_hypotheses, K) and
    ``uniform`` (C, K) replace the draws."""
    outs = []
    for i in range(images_l.shape[0]):
        state, out = stereo_step(state, images_l[i], images_r[i], rig, cfg, frontend,
                                 None if gumbel is None else gumbel[i:i + 1],
                                 None if uniform is None else uniform[i:i + 1])
        outs.append(out)
    return state, _cat(outs)


def run_stereo_vo_scan(images_l, images_r, rig: StereoRig, cfg: StereoConfig, generator: torch.Generator | None,
                       frontend: FrontendFns, gumbel=None, uniform=None) -> StereoStepOut:
    """Sequential stereo VO over (N, H, W) stacks: the per-pair outputs of
    frames 1..N-1, one frame at a time."""
    state = stereo_vo_init(images_l[0], images_r[0], rig, cfg, frontend, generator)
    return run_stereo_vo_chunk(state, images_l[1:], images_r[1:], rig, cfg, frontend, gumbel, uniform)[1]


def _on_device(images_l, images_r, device):
    """The stacks as float32 tensors on ``device``, else on the images'
    device when they are tensors, else on the card (which must exist)."""
    if device is None:
        device = images_l.device if isinstance(images_l, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("stereo VO runs on a CUDA card, and none is available; pass device='cpu' to run on the "
                           "CPU")
    return tuple(torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), dtype=torch.float32,
                                 device=device) for x in (images_l, images_r))


def run_stereo_vo_streaming(images_l, images_r, timestamps, rig: StereoRig, cfg: StereoConfig, out_path: str,
                            seed: int = 0, frontend: FrontendFns | None = None, chunk: int = 64, on_chunk=None,
                            device=None) -> tuple[Trajectory, StereoStepOut]:
    """Crash-safe streaming VO: the sequential runner advances ``chunk``
    frames at a time, and each chunk's trajectory rows land in ``out_path``
    (flushed and synced) before the next starts, so a crash loses at most
    one chunk (the reference saves at the end, stereo_slam.py:352-360).
    ``on_chunk(timestamps so far, poses so far)`` fires after each chunk.
    The per-pair outputs come back on the CPU."""
    from forest_slam_tpu_torch.io.tum import StreamingTumWriter

    images_l, images_r = _on_device(images_l, images_r, device)
    if frontend is None:
        frontend = orb_frontend(cfg.orb, cfg.max_match_distance)
    generator = torch.Generator(device=images_l.device)
    generator.manual_seed(seed)
    n = images_l.shape[0]
    ts = np.asarray(timestamps)
    state = stereo_vo_init(images_l[0], images_r[0], rig, cfg, frontend, generator)
    parts = []
    with StreamingTumWriter(out_path) as writer:
        for s in range(1, n, chunk):
            state, outs = run_stereo_vo_chunk(state, images_l[s:s + chunk], images_r[s:s + chunk], rig, cfg,
                                              frontend)
            outs = _map(lambda a: a.cpu(), outs)
            writer.append(ts[s:s + outs.pose.shape[0]], outs.pose.double().numpy())
            parts.append(outs)
            if on_chunk is not None:
                done = s + outs.pose.shape[0]
                on_chunk(ts[1:done], torch.cat([o.pose for o in parts]).double().numpy())
    outs = _cat(parts)
    return Trajectory.from_matrices(ts[1:], outs.pose.double().numpy()), outs


def run_stereo_vo(images_l, images_r, timestamps, rig: StereoRig, cfg: StereoConfig = StereoConfig(), seed: int = 0,
                  frontend: FrontendFns | None = None, mode: str = "batched", ba=None, device=None,
                  frame_batch: int = 8, pair_batch: int = 8) -> tuple[Trajectory, StereoStepOut]:
    """Host entry point: the trajectory of frames 1..N-1 and the per-pair
    outputs of (N, H, W) stereo stacks in [0, 255] (arrays or tensors).
    The default front end is ORB (``cfg.orb``, ``cfg.max_match_distance``);
    pass ``frontend=learned_frontend(fe)`` for SuperPoint + SuperGlue.
    ``mode``: "batched" (frame-parallel) or "scan" (sequential). ``ba``: a
    backend.window.WindowBAConfig refines the trajectory with sliding-window
    bundle adjustment, the anchors re-matched by the front end (it takes the
    batched runner). Runs on ``device``, else on the images' device when
    they are tensors, else on the card. The PnP draws come from a generator
    seeded with ``seed``."""
    if mode not in ("batched", "scan"):
        raise ValueError(f"unknown mode {mode!r}")
    images_l, images_r = _on_device(images_l, images_r, device)
    if frontend is None:
        frontend = orb_frontend(cfg.orb, cfg.max_match_distance)
    generator = torch.Generator(device=images_l.device)
    generator.manual_seed(seed)
    if ba is not None:
        from forest_slam_tpu_torch.backend.window import refine_trajectory_ba

        outs, art = run_stereo_vo_device(images_l, images_r, rig, cfg, generator, frontend, frame_batch, pair_batch,
                                         return_artifacts=True)
        outs = outs._replace(pose=refine_trajectory_ba(outs.pose, art, rig.left, ba, frontend=frontend,
                                                       image_shape=tuple(images_l.shape[1:]), pair_batch=pair_batch))
    elif mode == "batched":
        outs = run_stereo_vo_device(images_l, images_r, rig, cfg, generator, frontend, frame_batch, pair_batch)
    else:
        outs = run_stereo_vo_scan(images_l, images_r, rig, cfg, generator, frontend)
    traj = Trajectory.from_matrices(np.asarray(timestamps)[1:], outs.pose.double().cpu().numpy())
    return traj, outs
