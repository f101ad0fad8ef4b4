"""ORB with cross-checked Hamming matching: no weights; the port's
``orb_frontend`` and the reference's ``orb.py``."""

from __future__ import annotations

import torch

from bench_port import roofline
from bench_port.reference import orb

compares_obs = False  # no refinement: the observations are the matched keypoints

BLUR_FLOPS = 2 * 7 * 2
BRIEF_BITS = 256
SLOT_BYTES = 8 + 4 + 4 + 4 + 8 * 8 + 1


def keypoints(cfg: dict) -> int:
    return cfg["orb"]["n_features"]


def weights(cfg: dict, root: str, seed: int, device):
    return None


def program(cfg: dict, stereo_cfg, inputs: dict, root: str, device):
    from forest_slam_tpu_torch.frontend.base import orb_frontend

    return orb_frontend(stereo_cfg.orb, stereo_cfg.max_match_distance)


def reference_load(cfg: dict, inputs: dict, device):
    return None


def reference_extract(images, net, cfg: dict, prec):
    return orb.extract(images, cfg["orb"], prec)


def reference_match(a: dict, b: dict, net, cfg: dict, image_shape, prec):
    return orb.match(a, b, cfg["max_match_distance"])


def slot_groups(cfg: dict, K: int):
    """Each slot's pyramid level: a level's keypoints can sit on another
    level's positions."""
    _, budgets = orb.level_geometry(64, 64, cfg["orb"])
    return torch.repeat_interleave(torch.arange(len(budgets)), torch.tensor(budgets))


def desc_gap(prog, ref) -> float:
    """Mean share of differing BRIEF bits of the keypoints both sides
    found."""
    x = prog ^ ref
    bitsum = ((x[..., None] >> torch.arange(32, device=x.device)) & 1).sum(dim=(-1, -2))
    return float(bitsum.float().mean() / 256.0) if x.numel() else 0.0


# ------------------------------------------------------------- roofline


def level_shapes(H: int, W: int, cfg: dict) -> list:
    sf = cfg["scale_factor"]
    return [(max(int(round(H / sf ** l)), 32), max(int(round(W / sf ** l)), 32)) for l in range(cfg["n_levels"])]


def _interior(h, w, m):
    m = max(m, 3)
    return max(h - 2 * m, 0) * max(w - 2 * m, 0)


def costs(H: int, W: int, cfg: dict):
    """(frame FLOPs, pair FLOPs, bytes of a keypoint slot, extract weight
    bytes, pair weight bytes): detection's floor, smoothing and BRIEF tests
    a frame, Hamming matching a pair, no weights."""
    o = cfg["orb"]
    K = o["n_features"]
    levels = level_shapes(H, W, o)
    frame_flops = sum(roofline.DETECT_OPS_PER_PIXEL * h * w
                      + roofline.DETECT_OPS_PER_INTERIOR_PIXEL * _interior(h, w, o["edge_margin"]) for h, w in levels)
    frame_flops += sum(BLUR_FLOPS * h * w for h, w in levels) + BRIEF_BITS * K
    return frame_flops, K * K * BRIEF_BITS, SLOT_BYTES, 0, 0
