"""The output check: the numbers that compare what the timed path produced
with the plain reference's answers for the same inputs, each held to the
cell's limit.

Keypoints are paired between the two sides by frame, pixel position
(quantised to 1/8 px) and the front end's slot group (ORB's pyramid level);
a match is common where both its ends are paired and the other side makes
the same match.

- ``kp_miss``: keypoints on one side only, over all keypoints of both sides,
  every virtual frame.
- ``desc_gap``: on keypoints both sides found, the front end's descriptor
  gap: the mean L2 distance of the unit descriptors (learned) or the mean
  share of differing BRIEF bits (ORB).
- ``depth_gap``: on keypoints both sides found, the mean of min(1, relative
  depth gap) where both call the depth valid, 1 where one side alone does.
- ``match_miss``: matches on one side only, over all matches of both sides,
  every virtual pair.
- ``obs_gap``: on matches both sides made, the mean gap in pixels of the
  refined observation fed to PnP (where the front end compares them).
- ``pose_gap_mean``: the mean over the pairs of the Frobenius norm of the
  difference of a pair's gated relative pose (identity where the pose is not
  accepted, so an accept flag that differs adds about 1 or more over the
  pair count). The widest such gap is printed, not compared: a few pairs
  whose match sets differ by the GNN kernel's rounding set it, and the
  control reaches barely more.
- ``traj_gap``: the largest gap in metres between a chained position and the
  reference's, over every frame of every sequence of the window.
"""

from __future__ import annotations

import math

import torch

QUANT = 8  # keys quantise pixel positions to 1/QUANT px


def _pos_key(xy, H: int, W: int):
    bx = max(int(W * QUANT), 1).bit_length()
    kx = torch.round(xy[..., 0] * QUANT).long().clamp(0, (1 << bx) - 1)
    ky = torch.round(xy[..., 1] * QUANT).long().clamp(0, int(H * QUANT) + 1)
    return ky * (1 << bx) + kx, bx + max(int(H * QUANT) + 2, 1).bit_length()


def _share(a_common, b_common, n_a, n_b):
    """Elements on one side only, over the elements of both sides."""
    total = n_a + n_b
    return float(((n_a - a_common) + (n_b - b_common)) / total) if total else 0.0


def _slot_map(key_a, valid_a, key_b, valid_b):
    """(M, K) slot in b of the keypoint in a's slot with the same key in the
    same frame, or -1; keys are unique within a frame and side."""
    M, K = key_a.shape
    fa = (key_a + torch.arange(M, device=key_a.device)[:, None] * (1 << 44)).reshape(-1)
    fb = (key_b + torch.arange(M, device=key_b.device)[:, None] * (1 << 44)).reshape(-1)
    fb = torch.where(valid_b.reshape(-1), fb, torch.full_like(fb, -1))
    bs, order = torch.sort(fb)
    pos = torch.searchsorted(bs, fa).clamp(max=fb.numel() - 1)
    hit = (bs[pos] == fa) & valid_a.reshape(-1)
    return torch.where(hit, order[pos] % K, torch.full_like(pos, -1)).reshape(M, K)


def _common_matches(m_a, map_ab, m_b):
    """(matches of a whose two ends map to b's slots and that b makes too,
    (M-1, K) bool)."""
    ok = m_a >= 0
    ka = map_ab[:-1]
    ma = map_ab[1:].gather(1, torch.where(ok, m_a, torch.zeros_like(m_a)).long())
    mb = m_b.long().gather(1, ka.clamp(min=0))
    return ok & (ka >= 0) & (ma >= 0) & (mb == ma)


def relative_from_chain(poses):
    """Gated relative poses from the chained poses of frames 1..M-1."""
    from bench_port.reference.common import mm, se3_inverse

    prev = torch.cat([torch.eye(4, device=poses.device)[None], poses[:-1]])
    return mm(se3_inverse(prev), poses)


def numbers(prog: dict, ref: dict, index, image_shape, cfg: dict, frontend, look: dict | None = None) -> dict:
    """The check's numbers, the front end's part by ``frontend``
    (``frontends/<frontend>.py``: ``slot_groups``, ``desc_gap``,
    ``compares_obs``). ``prog``: the program's per virtual frame xy,
    valid, desc, z, z_ok (M, K, ...); per pair matches (M-1, K), obs (or
    None), poses (M-1, 4, 4) of the checked sequence; ``window_poses`` a
    list of every window sequence's poses. ``ref``: the reference's run.
    ``look``, where given, receives the widest pose gap and the pairs that
    set it, with how many matches each side alone made there."""
    H, W = image_shape
    M, K = prog["valid"].shape
    rf = {k: v[index] for k, v in ref["frames"].items()}
    group = frontend.slot_groups(cfg, K).to(prog["xy"].device)
    key_p, bits = _pos_key(prog["xy"], H, W)
    key_r, _ = _pos_key(rf["xy"], H, W)
    key_p, key_r = key_p + group * (1 << bits), key_r + group * (1 << bits)
    vp, vr = prog["valid"], rf["valid"]
    p2r, r2p = _slot_map(key_p, vp, key_r, vr), _slot_map(key_r, vr, key_p, vp)
    n_p, n_r = int(vp.sum()), int(vr.sum())
    out = dict(kp_miss=_share(int((p2r >= 0).sum()), int((r2p >= 0).sum()), n_p, n_r))
    common = p2r >= 0
    rs = p2r.clamp(min=0)
    take = lambda t: t.gather(1, rs) if t.dim() == 2 else t.gather(1, rs[..., None].expand(-1, -1, t.shape[-1]))
    out["desc_gap"] = frontend.desc_gap(prog["desc"][common], take(rf["desc"])[common])
    zp, zr = prog["z"][common], take(rf["z"])[common]
    op, orr = prog["z_ok"][common], take(rf["z_ok"])[common]
    g = torch.where(op & orr, torch.clamp((zp - zr).abs() / torch.clamp(zr.abs(), min=1e-6), max=1.0),
                    (op != orr).float())
    out["depth_gap"] = float(g.mean()) if g.numel() else 0.0
    same_p = _common_matches(prog["matches"], p2r, ref["matches"])
    same_r = _common_matches(ref["matches"], r2p, prog["matches"])
    out["match_miss"] = _share(int(same_p.sum()), int(same_r.sum()), int((prog["matches"] >= 0).sum()),
                               int((ref["matches"] >= 0).sum()))
    if frontend.compares_obs and prog.get("obs") is not None:
        ro = ref["obs"].gather(1, p2r[:-1].clamp(min=0)[..., None].expand(-1, -1, 2))
        gap = torch.linalg.vector_norm(prog["obs"] - ro, dim=-1)[same_p]
        out["obs_gap"] = float(gap.mean()) if gap.numel() else 0.0
    gaps = torch.linalg.matrix_norm(relative_from_chain(prog["poses"]) - ref["rel"])
    out["pose_gap_mean"] = float(gaps.mean())
    if look is not None:
        only_p = ((prog["matches"] >= 0) & ~same_p).sum(-1)
        only_r = ((ref["matches"] >= 0) & ~same_r).sum(-1)
        top = torch.topk(gaps, min(5, gaps.numel())).indices.tolist()
        look.update(pose_gap_max=float(gaps.max()), pairs_with_differing_matches=int(((only_p + only_r) > 0).sum()),
                    widest=[dict(pair=i, gap=float(gaps[i]), program_only=int(only_p[i]), reference_only=int(only_r[i]),
                                 matches=int((prog["matches"][i] >= 0).sum()), program_ok=bool(prog["ok"][i]))
                            for i in top])
    t_r = ref["poses"][:, :3, 3]
    out["traj_gap"] = max(float(torch.linalg.vector_norm(p[:, :3, 3] - t_r, dim=-1).max())
                          for p in prog["window_poses"])
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """(every number within its limit and every limit read, the lines that
    print each number beside its limit)."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        lines.append(f"check {name} {v!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    return ok, lines
