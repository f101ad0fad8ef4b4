"""Stereo VO of a cell's inputs by the plain reference.

A virtual sequence of M frames shows unique rendered frames ``index[i]``.
Per-frame answers depend on the frame alone and per-pair matches and
refinement on the ordered pair of frames alone, so the reference computes
them once per unique frame and per unique ordered pair; PnP takes each
virtual pair's own draws. The chain composes the gated relative poses."""

from __future__ import annotations

import torch

from bench_port.reference import pnp, stereo
from bench_port.reference.common import SOUND, Camera, Precision, backproject, mm, se3_inverse, se3_matrix


FRAME_BATCH, PAIR_BATCH = 16, 16  # unique frames and unique pairs a batch


def _batches(n, size):
    return [(s, min(s + size, n)) for s in range(0, n, size)]


@torch.no_grad()
def run(inputs: dict, cfg: dict, frontend, prec: Precision = SOUND, pnp_batch: int = 48) -> dict:
    """The reference's answers for ``inputs`` (unique frames ``left`` and
    ``right`` (U, H, W), ``index`` (M,), draws ``gumbel`` (M-1, n, K) and
    ``uniform`` (M-1, K), the camera ``K`` and ``baseline``, and what the
    front end loads from: ``weights`` drawn from the seed or a file under
    ``root``) under the configuration ``cfg``, the front end's own part by
    ``frontend``'s reference functions (``frontends/<frontend>.py``): per
    unique frame xy, valid, desc, z, z_ok; per virtual pair matches, obs,
    rel, ok; and the chained poses of frames 1..M-1. PnP runs ``pnp_batch``
    virtual pairs at a time."""
    left, right, index = inputs["left"], inputs["right"], inputs["index"].long()
    dev = left.device
    U, H, W = left.shape
    cam = Camera(inputs["K"], None, dev)
    fx_b = cam.fx * torch.tensor(float(inputs["baseline"]), dtype=torch.float32, device=dev)
    net = frontend.reference_load(cfg, inputs, dev)
    feats = []
    for s, e in _batches(U, FRAME_BATCH):
        f = frontend.reference_extract(left[s:e], net, cfg, prec)
        f["z"], f["z_ok"] = stereo.sparse_depth(left[s:e], right[s:e], f["xy"], fx_b, 1.0, cfg["sparse"], prec)
        feats.append(f)
    fr = {k: torch.cat([f[k] for f in feats]) for k in feats[0]}
    # unique ordered pairs of the virtual sequence
    codes = index[:-1] * U + index[1:]
    uniq, inv = torch.unique(codes, return_inverse=True)
    u0, u1 = torch.div(uniq, U, rounding_mode="floor"), uniq % U
    take = lambda f, u: {k: v[u] for k, v in f.items()}
    m_u, obs_u, val_u, w_u = [], [], [], []
    for s, e in _batches(uniq.shape[0], PAIR_BATCH):
        a, b = take(fr, u0[s:e]), take(fr, u1[s:e])
        m = frontend.reference_match(a, b, net, cfg, (H, W), prec)
        mask = m >= 0
        idx = torch.where(mask, m, torch.zeros_like(m))
        valid = mask & a["z_ok"] & (a["z"] > cfg["min_depth"]) & (a["z"] < cfg["max_depth"]) & a["valid"]
        obs = b["xy"].gather(1, idx[..., None].expand(-1, -1, 2))
        weights = None
        if cfg["refine_radius"] > 0:
            obs, ok_r, quality = stereo.refine(left[u0[s:e]], left[u1[s:e]], a["xy"], obs, valid,
                                               cfg["refine_radius"], cfg["refine_template"],
                                               cfg["refine_max_cost_ratio"], prec)
            valid = valid & ok_r
            weights = torch.clamp(quality, min=0.05)
        m_u.append(m)
        obs_u.append(obs)
        val_u.append(valid)
        w_u.append(weights)
    m_u, obs_u, val_u = torch.cat(m_u), torch.cat(obs_u), torch.cat(val_u)
    w_u = None if w_u[0] is None else torch.cat(w_u)
    # PnP a virtual pair at a time, in batches, with its own draws
    M = index.shape[0]
    rels, oks = [], []
    for s, e in _batches(M - 1, pnp_batch):
        j = inv[s:e]
        prev = index[s:e]
        pts3d = prec.f32(backproject(fr["xy"][prev], fr["z"][prev], cam))
        obs, valid = prec.f32(obs_u[j]), val_u[j]
        R, t, n_inl, ok = pnp.solve(pts3d, obs, valid, cam, inputs["gumbel"][s:e], inputs["uniform"][s:e],
                                    None if w_u is None else w_u[j], threshold=cfg["reproj_threshold_px"],
                                    min_inliers=cfg["min_points"], refine_iters=cfg["refine_iters"])
        n_valid = valid.sum(-1)
        ratio = cfg["min_inlier_ratio"]
        ok = (ok & (n_valid >= cfg["min_points"])
              & ((n_inl >= ratio * torch.clamp(n_valid, min=1)) | (n_inl >= cfg["min_inliers_absolute"])))
        rel = se3_inverse(se3_matrix(R, t))
        rels.append(prec.f32(torch.where(ok[:, None, None], rel, torch.eye(4, device=dev).expand_as(rel))))
        oks.append(ok)
    rel, ok = torch.cat(rels), torch.cat(oks)
    cur, poses = torch.eye(4, device=dev), []
    for i in range(rel.shape[0]):
        cur = mm(cur, rel[i])
        poses.append(cur)
    return dict(frames=fr, matches=m_u[inv], obs=obs_u[inv], rel=rel, ok=ok, poses=torch.stack(poses))
