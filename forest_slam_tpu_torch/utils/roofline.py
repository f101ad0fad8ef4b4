"""Roofline accounting of the stereo VO path: how much of the card's peak a
run uses (counterpart of the JAX package's utils/roofline.py).

The JAX module asks XLA's cost analysis for the compiled phases' FLOPs and
bytes and hand-counts its Pallas kernels. PyTorch compiles no module that
could be asked, so this one counts the work by formula from the
configuration's shapes alone, and launches nothing:

- **FLOPs** count the algorithm's own work: SuperPoint's convolutions at
  every octave, selection, the sparse-stereo SAD, SuperGlue's keypoint
  encoder, GNN layers, final projection and score matrix, the Sinkhorn
  iterations, refinement's SAD, ORB's detection, smoothing and BRIEF tests,
  Hamming matching, and PnP's hypotheses (the minimal solve and the scoring
  of the points). The count is the same whichever implementation runs: a
  CUDA kernel, its plain version, or the dense or unfused layer.
- **Bytes** count the traffic every implementation must move: the frames
  read, each network's weights read once a chunk, the features, depths,
  matches and poses written once and read once, and refinement's windows
  around each match. Intermediates (feature maps inside a network, the
  score matrix, the SAD volumes) are left out.

Both totals are floors, so ``mfu`` (FLOP/s over the card's dense bf16 peak)
and ``hbm_frac`` (bytes/s over its HBM rate) can never honestly exceed 1, and
``roofline_frac``, the larger of the two, is a share of the binding resource
that a faster kernel or a fusion cannot push past 100% or make stale.

:func:`kernel_costs` gives the operations and bytes of each CUDA kernel at
its shapes, the counts behind ``chip_smoke.py``'s bounds. Nothing here
imports torch at module level: the shape formulas are plain arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

# (peak dense bf16 FLOP/s, peak HBM bytes/s) by the name torch.cuda gives a
# card; NVIDIA's data sheets, the dense rates (half the sparse ones)
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),  # H100 SXM
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


class StageCost(NamedTuple):
    flops: float
    bytes: float


def device_peaks(device=None):
    """(peak FLOP/s, peak HBM bytes/s) of a CUDA device by its name, or None
    for the CPU and for a card not in :data:`DEVICE_PEAKS` (no default)."""
    import torch

    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type != "cuda":
        return None
    return DEVICE_PEAKS.get(torch.cuda.get_device_name(device))


def roofline_summary(costs: dict, n_frames: int, frame_chunk: int, pair_chunk: int, elapsed_s: float,
                     peaks) -> dict:
    """Chunk costs folded into whole-run totals and shares of ``peaks``
    (the JAX module's arithmetic: ceil chunk counts, shares rounded to 4
    places). With ``peaks`` None the shares and peaks are None."""
    n_fc = -(-n_frames // frame_chunk)
    n_pc = -(-(n_frames - 1) // pair_chunk)
    total_flops = costs["extract_chunk"].flops * n_fc + costs["pair_chunk"].flops * n_pc
    total_bytes = costs["extract_chunk"].bytes * n_fc + costs["pair_chunk"].bytes * n_pc
    if peaks is None:
        return {"total_flops": total_flops, "total_bytes": total_bytes, "mfu": None, "hbm_frac": None,
                "roofline_frac": None, "peak_flops": None, "peak_bw": None}
    peak_flops, peak_bw = peaks
    mfu = total_flops / elapsed_s / peak_flops
    hbm = total_bytes / elapsed_s / peak_bw
    return {
        "total_flops": total_flops,
        "total_bytes": total_bytes,
        "mfu": round(mfu, 4),
        "hbm_frac": round(hbm, 4),
        "roofline_frac": round(max(mfu, hbm), 4),
        "peak_flops": peak_flops,
        "peak_bw": peak_bw,
    }


# --------------------------------------------------------------------------
# The CUDA kernels at their shapes: operations and bytes (each input read
# once, each output written once) behind chip_smoke.py's bounds
# --------------------------------------------------------------------------


def sparse_cost_cost(B: int, H: int, W: int, K: int, D: int, w: int) -> StageCost:
    """csrc/sparse_cost.cu on B frames: per keypoint the w x w left patch and
    the w x (D + w - 1) right strip (at most the whole image each), the
    keypoint coordinates and the (K, D) cost rows; a tap is a subtraction,
    an absolute value and an add."""
    S = D + w - 1
    nbytes = B * 4 * (min(H * W, K * w * w) + min(H * W, K * w * S) + 2 * K + K * D)
    return StageCost(B * K * D * w * w * 3, nbytes)


def gnn_layer_weight_bytes(D: int) -> int:
    """Bytes of one layer's weights in the kernel's layout
    (gnn_kernel.split_layer_params): bf16 q, k, v, merge and MLP kernels and
    biases, float32 LayerNorm scale and bias."""
    return 2 * (3 * D * D + 3 * D) + 2 * (D * D + D) + 2 * (2 * 2 * D * D + 2 * D) + 2 * 4 * 2 * D \
        + 2 * (2 * D * D + D)


def gnn_layer_cost(N: int, K: int, S: int, D: int, weight_bytes: int) -> StageCost:
    """csrc/gnn_layer.cu: q and the merge over K tokens, k and v over S,
    both attention products, the two-layer MLP over [x, message]; each input
    and the weights read once, the output written once."""
    ops = 2 * N * D * D * (2 * K + 2 * S) + 4 * N * K * S * D + 2 * N * K * (2 * D) * (2 * D) + 2 * N * K * 2 * D * D
    nbytes = 2 * (2 * N * K * D + N * S * D) + N * S + weight_bytes
    return StageCost(ops, nbytes)


def sinkhorn_cost(B: int, K0: int, K1: int, iters: int) -> StageCost:
    """csrc/sinkhorn.cu. Per table entry: the row max's compare, s - r and
    its exp, two multiply-adds an iteration (row and column sums), and a
    multiply and a compare for each decode; a multiply-add counts as 2."""
    ops = B * K0 * K1 * (4 * iters + 7)
    nbytes = B * (K0 * K1 * 4 + (K0 + K1) * 4 + 2 * (K0 + K1) * 4)
    return StageCost(ops, nbytes)


def refine_cost_cost(B: int, H0: int, W0: int, H1: int, W1: int, K: int, R: int, t: int, nvalid) -> StageCost:
    """csrc/refine_cost.cu on B pairs with ``nvalid`` live keypoints each:
    each live keypoint's t x t template and (2R + t)^2 window (at most the
    frame each), the coordinates and counts, the (K, n, n) volumes; a tap
    is a subtraction, an absolute value and an add."""
    n, S = 2 * R + 1, 2 * R + t
    nv = sum(int(v) for v in nvalid)
    nbytes = 4 * (sum(min(H0 * W0, int(v) * t * t) + min(H1 * W1, int(v) * S * S) for v in nvalid)
                  + 4 * B * K + B + B * K * n * n)
    return StageCost(nv * n * n * t * t * 3, nbytes)


# float32 operations of the detection kernel (csrc/detect.cu), as its data
# gates them. Every pixel of a level: the cell reduction (1). Every pixel
# inside the edge margin: the exact early reject, ring points 0, 4, 8 and 12
# (4 differences, 8 compares). Every pixel past it: the other 12
# differences, their 24 compares into the bright and dark masks and two
# run-of-9 tests of 8 shifts and ands (52). Every pixel of a row that holds a
# FAST corner: Sobel, scaling and the three products (13) and the box sums
# over rows (18). Every FAST corner: the box sums over columns (18), the
# Harris response (7) and 3x3 NMS (9).
DETECT_OPS_PER_PIXEL = 1
DETECT_OPS_PER_INTERIOR_PIXEL = 12
DETECT_OPS_PER_CANDIDATE = 52
DETECT_OPS_PER_CORNER_ROW_PIXEL = 31
DETECT_OPS_PER_CORNER = 34


def detect_ops(img, threshold: float, margin: int) -> int:
    """The detection kernel's operations on (B, h, w) images, as above (the
    candidates and corners are counted on the images given)."""
    import torch.nn.functional as F

    from forest_slam_tpu_torch.frontend.fast import fast_score_map, interior_mask

    B, h, w = img.shape
    t = max(threshold, 0.0)
    p = F.pad(img, (3, 3, 3, 3))
    d = [p[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    bright = sum((x > t).int() for x in d)
    dark = sum((x < -t).int() for x in d)
    inside = interior_mask(h, w, max(margin, 3), img.device)
    candidates = int((((bright >= 2) | (dark >= 2)) & inside).sum())
    corners = (fast_score_map(img, threshold) > 0) & inside
    return (DETECT_OPS_PER_PIXEL * B * h * w + DETECT_OPS_PER_INTERIOR_PIXEL * B * int(inside.sum())
            + DETECT_OPS_PER_CANDIDATE * candidates + DETECT_OPS_PER_CORNER_ROW_PIXEL * w * int(corners.any(-1).sum())
            + DETECT_OPS_PER_CORNER * int(corners.sum()))


def interior_pixels(h: int, w: int, margin: int) -> int:
    """Pixels of an h x w level at least max(margin, 3) from every border."""
    m = max(margin, 3)
    return max(h - 2 * m, 0) * max(w - 2 * m, 0)


def detect_cost(level_shapes, ops: int) -> StageCost:
    """csrc/detect.cu over levels of shapes (B, h, w): each level read once,
    one (value, index) a cell written; ``ops`` from :func:`detect_ops`."""
    nbytes = sum(4 * B * h * w + 8 * B * (-(-h // 8)) * (-(-w // 8)) for B, h, w in level_shapes)
    return StageCost(ops, nbytes)


def select_ops_per_pixel(radius: int) -> int:
    """Comparisons a pixel of the select function: a separable (2r+1)^2
    window maximum done plainly (2 * 2r; csrc/select.cu shares partial
    maxima between neighbouring windows and does fewer), the three tests and
    the block reduction."""
    return 4 * radius + 4


def select_cost(B: int, H: int, W: int, radius: int = 4) -> StageCost:
    """csrc/select.cu on B heat maps: the heat read once, one (value, index)
    a 4 x 4 block written."""
    return StageCost(select_ops_per_pixel(radius) * B * H * W, 4 * B * H * W + 8 * B * (H // 4) * (W // 4))


def attention_cost(B: int, h: int, K: int, S: int, dh: int) -> StageCost:
    """csrc/attention.cu: both products of (B, h) heads; q, k, v and the
    output in bf16 (K = S counted for all four) and the (B, S) mask."""
    return StageCost(4 * B * h * K * S * dh, 4 * (B * h * K * dh) * 2 + B * S)


# A point's Gauss-Newton step in csrc/pnp_refine.cu, in float32: R p + t
# (18), the projection (6), the residual and its gate (6), the 2 x 3 pixel
# Jacobian (12) and its product with [I | -hat(p)] (36); in float64: J^T J's
# upper triangle over two rows (84) and J^T r (24)
PNP_GN_POINT_FLOPS_F32 = 78
PNP_GN_POINT_FLOPS_F64 = 108


def pnp_refine_cost(P: int, N: int, k: int, identity: bool, iters: int) -> StageCost:
    """csrc/pnp_refine.cu on P pairs of N points: ``iters`` Gauss-Newton
    steps over every point for each of the k starts (and the identity), then
    each candidate scored on every point (PNP_SCORE_FLOPS); the points, the
    starts and their indices read once, the pose, count and mask written.
    The operations of both precisions; :func:`pnp_refine_f64_flops` gives
    the float64 part."""
    starts = k + int(identity)
    gn = PNP_GN_POINT_FLOPS_F32 + PNP_GN_POINT_FLOPS_F64
    ops = P * N * (starts * iters * gn + (starts + 1) * PNP_SCORE_FLOPS)
    nbytes = P * (N * (12 + 8 + 1) + k * (48 + 8) + 36 + 12 + N + 8 + 1) + 4 * (9 + 5)
    return StageCost(ops, nbytes)


def pnp_refine_f64_flops(P: int, N: int, k: int, identity: bool, iters: int) -> int:
    """The float64 part of :func:`pnp_refine_cost`'s operations: the normal
    equations' sums, which run at the card's float64 rate."""
    return P * N * (k + int(identity)) * iters * PNP_GN_POINT_FLOPS_F64


_KERNELS = {
    "sparse_cost": sparse_cost_cost,
    "gnn_layer": gnn_layer_cost,
    "sinkhorn_decode": sinkhorn_cost,
    "refine_cost": refine_cost_cost,
    "detect": detect_cost,
    "select": select_cost,
    "attention": attention_cost,
    "pnp_refine": pnp_refine_cost,
}


def kernel_costs(name: str, *shape) -> StageCost:
    """Operations and bytes of the CUDA kernel ``name`` (the launch-count
    names of chip_smoke.py) at ``shape``, the arguments of its cost function
    above."""
    return _KERNELS[name](*shape)


# --------------------------------------------------------------------------
# The bench path from the configuration's shapes
# --------------------------------------------------------------------------

# PnP-RANSAC (geometry/pnp.py) a hypothesis: DLT-6 forms the 12 x 12 normal
# matrix of its six points' rows (2 * 12^3, a floor for the null vector it
# solves for); P3P solves Grunert's quartic and fits up to four poses
# (counted as 200, a floor), and each of its four candidates is scored. A
# point's score: R p + t (18), the projection (6), the residual and its test
# (6). Every candidate is scored on a preemptive subset of 128 points where
# there are at least 256, the best 64 of them on all points.
DLT6_SOLVE_FLOPS = 2 * 12 ** 3
P3P_SOLVE_FLOPS = 200
P3P_CANDIDATES = 4
PNP_SCORE_FLOPS = 30
PNP_PREEMPTIVE_SUBSET, PNP_PREEMPTIVE_KEEP = 128, 64
# ORB a pixel of each level: the sigma-2 7 x 7 smoothing before BRIEF, as two
# 7-tap passes of multiply-adds; a keypoint: 256 BRIEF tests
ORB_BLUR_FLOPS = 2 * 7 * 2
BRIEF_BITS = 256
# bytes of a keypoint slot: xy, response, angle, octave, 8 int64 words and
# valid for ORB (the learned front end's: learned_slot_bytes); a depth and
# its flag; a pose
ORB_SLOT_BYTES = 8 + 4 + 4 + 4 + 8 * 8 + 1
DEPTH_SLOT_BYTES = 4 + 1
POSE_BYTES = 16 * 4


def learned_slot_bytes(D: int) -> int:
    """A learned keypoint slot: xy, score, float32 descriptor, valid."""
    return 8 + 4 + 4 * D + 1


def superpoint_convs(sp, H: int, W: int) -> list:
    """(c_in, c_out, k, h, w) of each of SuperPoint's convolutions on one
    H x W image (frontend/superpoint.py: the space-to-depth stem, VGG
    blocks with 2 x 2 pools, detector and descriptor heads)."""
    s = sp.stem_stride
    c1, c2, c3, c4 = sp.channels
    h, w = H // s, W // s
    n_pools = 3 - {1: 0, 2: 1, 4: 2, 8: 3}[s]
    io = ((s * s, c1), (c1, c1), (c1, c2), (c2, c2), (c2, c3), (c3, c3), (c3, c4), (c4, c4))
    out = []
    for blk in range(4):
        out += [(ci, co, 3, h, w) for ci, co in io[2 * blk:2 * blk + 2]]
        if blk < n_pools:
            h, w = h // 2, w // 2
    return out + [(c4, 256, 3, h, w), (256, 65, 1, h, w), (c4, 256, 3, h, w), (256, sp.descriptor_dim, 1, h, w)]


def superpoint_flops(sp, H: int, W: int) -> int:
    """Multiply-adds (as 2) of SuperPoint's convolutions on one H x W image."""
    return sum(2 * ci * co * k * k * h * w for ci, co, k, h, w in superpoint_convs(sp, H, W))


def superpoint_weight_bytes(sp) -> int:
    """SuperPoint's kernels and biases in bf16."""
    return sum(2 * (ci * co * k * k + co) for ci, co, k, _, _ in superpoint_convs(sp, 8 * sp.stem_stride,
                                                                                  8 * sp.stem_stride))


def octave_shapes(H: int, W: int, scales, s8: int) -> list:
    """(Hs, Ws) of each extraction octave (frontend/learned.py: the image
    itself at 1.0, else rounded down to a multiple of the total stride)."""
    def shape(s):
        if s == 1.0:
            return H, W
        return max(int(round(H * s)) // s8 * s8, s8), max(int(round(W * s)) // s8 * s8, s8)

    return [shape(s) for s in scales]


def _kenc_dims(sg) -> tuple:
    return (3,) + tuple(sg.keypoint_encoder_dims) + (sg.descriptor_dim,)


def gnn_apply_matrix_flops(K: int, S: int, D: int) -> int:
    """The products of one GNN layer-apply on one sequence: q over K rows, k
    and v over S (2 (K + 2S) D^2), the merge (2 K D^2), the MLP (12 K D^2),
    the attention logits and probabilities times values (4 K S D)."""
    return 2 * (K + 2 * S) * D * D + 2 * K * D * D + 12 * K * D * D + 4 * K * S * D


def gnn_apply_flops(K: int, S: int, D: int, heads: int) -> int:
    """One layer-apply: its products and the softmax and LayerNorm
    (12 K S h + 20 K D; the JAX module's per_apply)."""
    return gnn_apply_matrix_flops(K, S, D) + 12 * K * S * heads + 20 * K * D


def superglue_matrix_flops(sg, K: int) -> int:
    """The products SuperGlue computes for one pair of K-slot sets: the
    keypoint encoder and final projection on both sets, 4 layer-applies a
    layer index (self and cross, both images), and the score matrix."""
    D = sg.descriptor_dim
    dims = _kenc_dims(sg)
    kenc = 2 * K * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * kenc + 4 * sg.gnn_layers * gnn_apply_matrix_flops(K, K, D) + 2 * 2 * K * D * D + 2 * K * K * D


def sinkhorn_flops(K0: int, K1: int, iters: int) -> int:
    """A pair's Sinkhorn: a row and a column log-sum-exp an iteration, about
    6 operations an entry each (the JAX module's count)."""
    return iters * 2 * K0 * K1 * 6


def superglue_flops(sg, K: int) -> int:
    """One pair through SuperGlue: its products, the GNN's softmax and
    LayerNorm work, and the Sinkhorn iterations."""
    elementwise = 4 * sg.gnn_layers * (12 * K * K * sg.num_heads + 20 * K * sg.descriptor_dim)
    return superglue_matrix_flops(sg, K) + elementwise + sinkhorn_flops(K, K, sg.sinkhorn_iterations)


def superglue_weight_bytes(sg) -> int:
    """SuperGlue's weights as the matcher reads them: the encoder and final
    projection in bf16, each layer in the kernel's layout, the dustbin score."""
    D = sg.descriptor_dim
    dims = _kenc_dims(sg)
    dense = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + D * D + D
    return 2 * dense + 2 * sg.gnn_layers * gnn_layer_weight_bytes(D) + 4


def sparse_sad_flops(K: int, D: int, w: int) -> int:
    """A frame's sparse-stereo SAD: D candidates of w^2 taps a keypoint, a
    tap |a - b| and an add."""
    return K * D * w * w * 2


def refine_flops(K: int, R: int, t: int, n_scales: int) -> int:
    """A pair's refinement SAD: (2R + 1)^2 offsets of t^2 taps a keypoint
    and scale, a tap |a - b| and an add (no lane padding)."""
    n = 2 * R + 1
    return n_scales * K * t * t * n * n * 2


def refine_window_bytes(H: int, W: int, K: int, R: int, t: int, scales) -> int:
    """A pair's refinement reads: each keypoint's template in frame 0 (at
    each scale) and its window in frame 1, at most the frame each."""
    S = 2 * R + t
    return sum(4 * (min(int(round(H * s)) * int(round(W * s)), K * t * t) + min(H * W, K * S * S)) for s in scales)


def pnp_flops(n_hypotheses: int, K: int, minimal: str) -> int:
    """A pair's PnP-RANSAC: the minimal solves and the scoring of the
    candidates (preemptively, as geometry/pnp.py does)."""
    if minimal == "p3p":
        solve, cands = P3P_SOLVE_FLOPS, P3P_CANDIDATES * n_hypotheses
    else:
        solve, cands = DLT6_SOLVE_FLOPS, n_hypotheses
    if K >= 2 * PNP_PREEMPTIVE_SUBSET:
        scored = cands * PNP_PREEMPTIVE_SUBSET + min(PNP_PREEMPTIVE_KEEP, cands) * K
    else:
        scored = cands * K
    return n_hypotheses * solve + scored * PNP_SCORE_FLOPS


def orb_level_shapes(H: int, W: int, orb) -> list:
    """(h, w) of ORB's pyramid levels (frontend/orb.py:_level_geometry)."""
    return [(max(int(round(H / orb.scale_factor ** lvl)), 32), max(int(round(W / orb.scale_factor ** lvl)), 32))
            for lvl in range(orb.n_levels)]


def orb_extract_flops(H: int, W: int, orb) -> int:
    """A frame's ORB work that no data can skip: every level's cell
    reduction and early FAST reject inside the margin (detect.cu's floor),
    its smoothing, and the BRIEF tests of each keypoint slot."""
    levels = orb_level_shapes(H, W, orb)
    detect = sum(DETECT_OPS_PER_PIXEL * h * w + DETECT_OPS_PER_INTERIOR_PIXEL * interior_pixels(h, w, orb.edge_margin)
                 for h, w in levels)
    return detect + sum(ORB_BLUR_FLOPS * h * w for h, w in levels) + BRIEF_BITS * orb.n_features


def stereo_pipeline_costs(image_shape, cfg, frontend, frame_chunk, pair_chunk) -> dict:
    """FLOPs and bytes of one frame chunk (``extract_chunk``: features and
    sparse-stereo depth of ``frame_chunk`` frames) and one pair chunk
    (``pair_chunk``: matching, refinement and PnP of ``pair_chunk`` pairs)
    of the stereo VO path, from the shapes alone. ``cfg`` is the
    StereoConfig; ``frontend`` the LearnedFrontendConfig of the learned
    front end, or None for ORB (``cfg.orb``). The chunk sizes may be
    means (a run's frames over its chunk count): each chunk reads the
    network weights once, the rest scales with its frames or pairs."""
    if cfg.dense_depth:
        raise ValueError("the roofline counts the sparse-stereo path; dense_depth is not counted")
    H, W = image_shape
    sparse = cfg.sparse
    if frontend is not None:
        sp, sg = frontend.superpoint, frontend.superglue
        K = sp.max_keypoints
        octaves = octave_shapes(H, W, frontend.scales, 8 * sp.stem_stride)
        frame_flops = sum(superpoint_flops(sp, h, w) + select_ops_per_pixel(sp.nms_radius) * h * w
                          for h, w in octaves)
        pair_flops = superglue_flops(sg, K)
        slot_bytes = learned_slot_bytes(sp.descriptor_dim)
        ex_weights, pr_weights = superpoint_weight_bytes(sp), superglue_weight_bytes(sg)
    else:
        K = cfg.orb.n_features
        frame_flops = orb_extract_flops(H, W, cfg.orb)
        pair_flops = K * K * BRIEF_BITS
        slot_bytes = ORB_SLOT_BYTES
        ex_weights = pr_weights = 0
    frame_flops += sparse_sad_flops(K, sparse.num_disparities, sparse.window)
    pair_flops += pnp_flops(cfg.n_hypotheses, K, cfg.pnp_minimal)
    # a frame: both views read, its features and depths written; a pair: one
    # frame's features and depths read, the matches and the pose written and
    # read once
    frame_bytes = 2 * H * W * 4 + K * (slot_bytes + DEPTH_SLOT_BYTES)
    pair_bytes = K * (slot_bytes + DEPTH_SLOT_BYTES) + 2 * 4 * K + 2 * POSE_BYTES
    if cfg.match_refine_radius > 0:
        t = 8  # RefineConfig.template
        scales = tuple(cfg.match_refine_scales)
        pair_flops += refine_flops(K, cfg.match_refine_radius, t, len(scales))
        pair_bytes += refine_window_bytes(H, W, K, cfg.match_refine_radius, t, scales)
    return {
        "extract_chunk": StageCost(frame_chunk * frame_flops, frame_chunk * frame_bytes + ex_weights),
        "pair_chunk": StageCost(pair_chunk * pair_flops, pair_chunk * pair_bytes + pr_weights),
    }
