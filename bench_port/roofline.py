"""The benchmark's roofline arithmetic: operations and bytes of the stereo
VO path and of its CUDA kernels, counted by formula from the shapes, and the
card's published peaks.

Both counts are floors. FLOPs count the algorithm's own work whatever runs
it: the front end's (``costs`` in ``frontends/<frontend>.py``: SuperPoint's
convolutions, selection, SuperGlue's encoder, GNN layers, projection,
scores and Sinkhorn; ORB's detection floor, smoothing and BRIEF tests,
Hamming matching), the sparse-stereo SAD, refinement's SAD, and PnP's
minimal solves and scoring. Bytes count the traffic
every implementation must move: frames read, network weights read once a
chunk, features, depths, matches and poses written once and read once, and
refinement's windows. So a share of a peak can never honestly exceed 1.
"""

from __future__ import annotations

from typing import NamedTuple

# by the name torch.cuda gives a card: dense bf16 tensor FLOP/s, float32
# FLOP/s outside the tensor cores, HBM bytes/s (NVIDIA's data sheets, dense
# rates at the full power limit)
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16=989e12, f32=67e12, hbm=3.35e12),  # H100 SXM
    "NVIDIA H100 PCIe": dict(bf16=756e12, f32=51e12, hbm=2.0e12),
    "NVIDIA H100 NVL": dict(bf16=835e12, f32=60e12, hbm=3.9e12),
}


class StageCost(NamedTuple):
    flops: float
    bytes: float


def device_peaks(name: str):
    """The peaks of a card by its name, or None where it is not listed."""
    return DEVICE_PEAKS.get(name)


def bound_seconds(cost: StageCost, peak_ops: float, peak_bw: float) -> float:
    """The least time: operations over their peak or bytes over HBM's rate,
    whichever is longer."""
    return max(cost.flops / peak_ops, cost.bytes / peak_bw)


# ----------------------------------------------------------------- kernels


def gnn_layer_weight_bytes(D: int) -> int:
    """One GNN layer's weights in the kernel's layout: bf16 q, k, v, merge
    and MLP kernels and biases, float32 LayerNorm scale and bias."""
    return 2 * (3 * D * D + 3 * D) + 2 * (D * D + D) + 2 * (2 * 2 * D * D + 2 * D) + 2 * 4 * 2 * D \
        + 2 * (2 * D * D + D)


def gnn_layer_cost(N: int, K: int, S: int, D: int, weight_bytes: int) -> StageCost:
    """csrc/gnn_layer.cu on N sequences: q and the merge over K tokens, k
    and v over S, both attention products, the two-layer MLP over [x,
    message]; each input and the weights read once, the output written once."""
    ops = 2 * N * D * D * (2 * K + 2 * S) + 4 * N * K * S * D + 2 * N * K * (2 * D) * (2 * D) + 2 * N * K * 2 * D * D
    return StageCost(ops, 2 * (2 * N * K * D + N * S * D) + N * S + weight_bytes)


# float32 operations of the detection kernel (csrc/detect.cu), as its data
# gates them: every pixel the cell reduction; inside the edge margin the
# early reject (4 differences, 8 compares); past it the other 12
# differences, 24 compares and two run-of-9 tests; every pixel of a row that
# holds a FAST corner Sobel, scaling, products and row box sums; every
# corner the column box sums, the Harris response and 3x3 NMS
DETECT_OPS_PER_PIXEL = 1
DETECT_OPS_PER_INTERIOR_PIXEL = 12
DETECT_OPS_PER_CANDIDATE = 52
DETECT_OPS_PER_CORNER_ROW_PIXEL = 31
DETECT_OPS_PER_CORNER = 34


def detect_ops(img, threshold: float, margin: int) -> int:
    """The detection kernel's operations on (B, h, w) level images."""
    import torch.nn.functional as F

    from bench_port.reference.orb import fast_score, interior

    B, h, w = img.shape
    t = max(threshold, 0.0)
    p = F.pad(img, (3, 3, 3, 3))
    d = [p[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    bright = sum((x > t).int() for x in d)
    dark = sum((x < -t).int() for x in d)
    inside = interior(h, w, max(margin, 3), img.device)
    candidates = int((((bright >= 2) | (dark >= 2)) & inside).sum())
    corners = (fast_score(img, threshold) > 0) & inside
    return (DETECT_OPS_PER_PIXEL * B * h * w + DETECT_OPS_PER_INTERIOR_PIXEL * B * int(inside.sum())
            + DETECT_OPS_PER_CANDIDATE * candidates + DETECT_OPS_PER_CORNER_ROW_PIXEL * w * int(corners.any(-1).sum())
            + DETECT_OPS_PER_CORNER * int(corners.sum()))


def detect_cost(level_shapes, ops: int) -> StageCost:
    """csrc/detect.cu over levels of shapes (B, h, w): each level read once,
    one (value, index) a cell written."""
    return StageCost(ops, sum(4 * B * h * w + 8 * B * (-(-h // 8)) * (-(-w // 8)) for B, h, w in level_shapes))


# ---------------------------------------------------------- the whole path

DLT6_SOLVE_FLOPS = 2 * 12 ** 3
P3P_SOLVE_FLOPS, P3P_CANDIDATES = 200, 4
PNP_SCORE_FLOPS = 30
PNP_PREEMPTIVE_SUBSET, PNP_PREEMPTIVE_KEEP = 128, 64
DEPTH_SLOT_BYTES = 4 + 1
POSE_BYTES = 16 * 4
REFINE_TEMPLATE = 8


def pnp_flops(n_hypotheses: int, K: int, minimal: str) -> int:
    solve, cands = ((P3P_SOLVE_FLOPS, P3P_CANDIDATES * n_hypotheses) if minimal == "p3p"
                    else (DLT6_SOLVE_FLOPS, n_hypotheses))
    if K >= 2 * PNP_PREEMPTIVE_SUBSET:
        scored = cands * PNP_PREEMPTIVE_SUBSET + min(PNP_PREEMPTIVE_KEEP, cands) * K
    else:
        scored = cands * K
    return n_hypotheses * solve + scored * PNP_SCORE_FLOPS


def frame_pair_costs(H: int, W: int, cfg: dict):
    """(frame FLOPs, frame bytes, pair FLOPs, pair bytes, extract weight
    bytes, pair weight bytes) of one frame and one pair: the front end's
    part from ``costs`` of the configuration's ``frontends/<frontend>.py``,
    then sparse stereo, PnP and refinement."""
    from bench_port import manifest

    fe = manifest.frontend(cfg["frontend"])
    K = fe.keypoints(cfg)
    frame_flops, pair_flops, slot, ex_w, pr_w = fe.costs(H, W, cfg)
    sp = cfg["sparse"]
    frame_flops += K * sp["num_disparities"] * sp["window"] ** 2 * 2
    pair_flops += pnp_flops(cfg["n_hypotheses"], K, cfg["pnp_minimal"])
    frame_bytes = 2 * H * W * 4 + K * (slot + DEPTH_SLOT_BYTES)
    pair_bytes = K * (slot + DEPTH_SLOT_BYTES) + 2 * 4 * K + 2 * POSE_BYTES
    R = cfg["refine_radius"]
    if R > 0:
        t, n, S = REFINE_TEMPLATE, 2 * R + 1, 2 * R + REFINE_TEMPLATE
        scales = cfg["refine_scales"]
        pair_flops += len(scales) * K * t * t * n * n * 2
        pair_bytes += sum(4 * (min(int(round(H * s)) * int(round(W * s)), K * t * t) + min(H * W, K * S * S))
                          for s in scales)
    return frame_flops, frame_bytes, pair_flops, pair_bytes, ex_w, pr_w


def sequence_costs(H: int, W: int, cfg: dict, n_frames: int, frame_chunk: int, pair_chunk: int) -> StageCost:
    """FLOPs and bytes of one whole sequence of ``n_frames`` frames run in
    frame chunks and pair chunks (each chunk reads the weights once)."""
    ff, fb, pf, pb, ew, pw = frame_pair_costs(H, W, cfg)
    n_fc, n_pc = -(-n_frames // frame_chunk), -(-(n_frames - 1) // pair_chunk)
    return StageCost(n_frames * ff + (n_frames - 1) * pf, n_frames * fb + n_fc * ew + (n_frames - 1) * pb + n_pc * pw)
