#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (forest_slam_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device: fails at once without CUDA; prints the card's name and power
   limit and the TF32 settings it pins;
2. build: compiles the CUDA kernels from ``forest_slam_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, with its stated tolerance, its time, the plain version's
   time and its bound (the sparse-cost kernel at the ORB path's 8 frames of
   K=512 and the learned paths' 8 of K=1024 at 960x600 and the lowres gate's
   24 of K=512 at 224x160; the detection kernel over all eight pyramid levels of
   a batch of 8 960x600 frames in one launch, and each level alone; the
   refine kernel at the learned paths' 8 pairs of K=1024 at 960x600 and the
   lowres gate's 23 pairs of K=512 at 224x160; the select kernel at a batch of
   8 960x600 heat maps and at the lowres gate's three octaves of 24 frames;
   the Sinkhorn kernel at the learned paths' (8, 1024, 1024), the lowres
   gate's (23, 512, 512) and a ragged (3, 200, 170) with a pair whose
   keypoints are all invalid, with the launch configuration it chose;
   the attention kernel at 16 sequences of 4 heads, K=S=1024, beside
   ``scaled_dot_product_attention`` as a yardstick, and at a ragged K=150,
   S=130; the GNN layer kernel at 16 sequences of 1024 x 256, at the lowres
   gate's 48 of 512 x 256 and at a ragged K=150, S=130; the ragged shapes
   with one sequence whose sources are all masked);
4. ORB path: renders a 960x600 corridor clip on the card and runs stereo VO
   through ``run_stereo_vo`` with its default ORB front end (512 features,
   8 levels, Hamming distance <= 64, 1024 DLT-6 hypotheses, no refinement),
   counting the kernels' launches; then the same frames through the plain
   versions, which must track the same pairs;
5. learned path: loads the flagship checkpoint and runs stereo VO (K=1024,
   refine radius 12, 1024 DLT-6 hypotheses) on the same clip through the
   kernels, counting their launches; then the same frames through the plain
   versions for comparison;
6. learned path with the unfused GNN (``bench.py --sg-gnn xla``): the same
   run with every GNN layer op by op around the attention kernel, which
   must launch while the fused layer kernel does not; then the plain
   versions;
7. lowres gate (``bench.py:626-682``, run through
   ``forest_slam_tpu_torch.bench.lowres_setup``): 24 corridor frames at
   224x160, extracted at octaves (1.0, 1.7, 2.89), K=512, 512 hypotheses,
   refine radius 12, frame and pair batches of 24, held to 21/23 tracked and
   ATE below 0.05 m;
8. the 962-pair workload of ``bench.py`` through
   ``forest_slam_tpu_torch.bench``: 64 unique 960x600 frames ping-ponged to
   963, frame and pair batches of 32 and 48; the learned front end (a
   fall-back to ORB fails the run) with a warm-up and three timed runs
   (three more when they spread by over 10%), then ORB with a warm-up and
   one timed run; each held to 90% of its pairs tracked and ATE below
   0.25 m, with pairs/s, ATE and RPE printed;
9. the gate suite of ``bench.py`` (``forest_slam_tpu_torch.bench.run_gates``):
   each vo gate's clip rendered on the card, worst of seeds 0 and 1; the
   gates that pass in the JAX package's record (``BENCH_r05.json``) are held
   to ``bench.py``'s bounds, ``blur_wb_k10`` and ``plain_k20`` (which fail
   there too) are printed only; the plain gates print that they did not run
   where their checkpoint is absent.

The kernel checks also run the shapes the workload and the gates give the
kernels: the sparse cost at 32 frames of K=1024 and of 512, the GNN layer at
96 sequences, Sinkhorn at 48, 15 and 7 pairs, refine at 48 pairs and at
radius 24 with frame 0 upscaled by 1.0, 1.2, 1.44 and 1.7 against frame 1
at 960x600, select at 32 960x600 frames and at the wide-baseline octaves
(416x672 and 288x480) of 16 frames, detect over the levels of 32 frames.

Each path starts with every launch count at 0 and reads them when it ends.

The last line is a JSON object {"ok": true, "device": {...}}; any failure
exits non-zero before it is printed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 CUDA-core
# and bf16 tensor-core operations/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12

UNIQUE_FRAMES = 16
N_FRAMES = 32
H, W = 600, 960
K = 1024
ORB_FEATURES = 512
ORB_LEVELS = 8
FRAME_BATCH = 8
PAIR_BATCH = 8
MIN_TRACKED = 0.9
MAX_ATE_M = 0.25
# the lowres gate (bench.py:626-682) and the reference's record of it
# (BENCH_r05.json, parsed.lowres_*)
LOWRES_H, LOWRES_W, LOWRES_FRAMES = 160, 224, 24
LOWRES_SCALES = (1.0, 1.7, 2.89)
LOWRES_K = 512
LOWRES_MAX_ATE_M = 0.05
LOWRES_REFERENCE = "23/23 tracked at ATE 0.0221 m"
HEADS, HEAD_DIM = 4, 64
# forest_slam_tpu_torch/bench.py's batches (FRAME_CHUNK, PAIR_CHUNK) and its
# gates' clips: 16 frames at K=10 (15 pairs), 8 at K=20 (7 pairs), 24 for
# blur50, all in one batch; the wide-baseline octaves and refine scales
BENCH_FRAMES, BENCH_PAIRS = 32, 48
GATE_PAIRS = (15, 7)
WB_OCTAVES = (0.707, 0.5)
WB_REFINE_SCALES = (1.0, 1.2, 1.44, 1.7)
WB_RADIUS = 24
BENCH_MAX_ATE_M = 0.25


def log(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f} s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, launches: int = 1) -> float:
    """Median over reps CUDA-event timings of fn(), after one warm-up call;
    each timing holds `launches` calls back to back and is divided by it."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return sorted(times)[len(times) // 2]


def device_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one fn() call: the sum of the device activity
    torch.profiler records over `calls` calls, divided by `calls` (host
    enqueue and the gaps between kernels left out); the median over `reps`
    profiled windows after one warm-up call, since a window now and then
    records only part of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_window = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        per_window.append(us / 1e3 / calls)
    return sorted(per_window)[len(per_window) // 2]


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# the sparse-cost kernel's shapes (frames, H, W, K), D = 96, w = 7: the ORB
# path's 512 features and the learned paths' 1024 keypoints in batches of 8
# 960x600 frames, the lowres gate's 24 frames of 512 at 224x160, and the
# 962-pair workload's batches of 32 frames (learned, then ORB)
SPARSE_SHAPES = ((FRAME_BATCH, H, W, ORB_FEATURES), (FRAME_BATCH, H, W, K),
                 (LOWRES_FRAMES, LOWRES_H, LOWRES_W, LOWRES_K), (BENCH_FRAMES, H, W, K),
                 (BENCH_FRAMES, H, W, ORB_FEATURES))
SPARSE_D, SPARSE_W = 96, 7


def sparse_case(dev, gen, shape):
    """The sparse-cost kernel against its plain version at (frames, H, W,
    K): (max error, ok, bound (ms, by), inputs)."""
    from forest_slam_tpu_torch.stereo.sparse import prefilter
    from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows, sparse_cost_rows_plain

    B, H_, W_, K_ = shape
    D, w = SPARSE_D, SPARSE_W
    # integer-valued images: quarter-integer prefiltered values make every
    # SAD sum exact, so kernel and plain version must agree bit for bit
    imgs = torch.randint(0, 256, (2, B, H_, W_), generator=gen, device=dev).float()
    pl, pr = prefilter(imgs[0], 31.0).contiguous(), prefilter(imgs[1], 31.0).contiguous()
    xi = torch.randint(0, W_, (B, K_), generator=gen, device=dev, dtype=torch.int32)
    yi = torch.randint(0, H_, (B, K_), generator=gen, device=dev, dtype=torch.int32)
    args = (pl, pr, xi, yi, D, w)
    err = (sparse_cost_rows(*args) - sparse_cost_rows_plain(*args)).abs().max().item()
    S = D + w - 1
    nbytes = B * 4 * (min(H_ * W_, K_ * w * w) + min(H_ * W_, K_ * w * S) + 2 * K_ + K_ * D)
    return err, err == 0.0, bound(nbytes, B * K_ * D * w * w * 3, F32_OPS), args


def check_sparse(dev, gen):
    from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows, sparse_cost_rows_plain

    per_shape, ok = [], True
    for shape in SPARSE_SHAPES:
        err, o, (b_ms, b_by), args = sparse_case(dev, gen, shape)
        ok &= o
        per_shape.append(dict(shape=list(shape), max_abs_err=err, ok=o,
                              ms=time_ms(lambda: sparse_cost_rows(*args)),
                              plain_ms=time_ms(lambda: sparse_cost_rows_plain(*args)),
                              bound_ms=b_ms, bound_by=b_by))
    main = per_shape[1]  # the learned paths' 8 x 1024
    return dict(
        name="sparse_cost", source="forest_slam_tpu_torch/csrc/sparse_cost.cu",
        replaces="forest_slam_tpu/stereo/pallas_sparse.py:149", tolerance="exact (0)",
        max_abs_err=max(p["max_abs_err"] for p in per_shape), ok=ok,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, per_shape=per_shape,
    )


# the fused layer's other shapes: the lowres gate's (48 sequences of
# K = S = 512, 18 launches there), a ragged K != S with one sequence whose
# sources are all masked, the 962-pair workload's 48 pairs and a K=10 gate's
# 15; (N, K, S, all_masked)
GNN_EXTRA_SHAPES = ((2 * LOWRES_FRAMES, LOWRES_K, LOWRES_K, False), (4, 150, 130, True),
                    (2 * BENCH_PAIRS, K, K, False), (2 * GATE_PAIRS[0], K, K, False))
ATTENTION_RAGGED = (3, HEADS, 150, 130)  # (B, h, K, S), the last sequence fully masked


def gnn_case(dev, gen, ws, heads, N, K_, S, all_masked):
    """The fused layer against its plain version at one shape: (max error,
    mean error, largest |ref|, ok, inputs)."""
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain

    D = 256
    x = torch.randn((N, K_, D), generator=gen, device=dev).to(torch.bfloat16)
    src = torch.randn((N, S, D), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.rand((N, S), generator=gen, device=dev) < 0.7
    if all_masked:
        mask[-1] = False
    got = gnn_layer(x, src, mask, ws, heads).float()
    ref = gnn_layer_plain(x, src, mask, ws, heads).float()
    scale = max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item()
    mean_err = (got - ref).abs().mean().item()
    # bf16 outputs: sums in another order may flip a rounding, a bf16 ulp
    # (2^-8 relative) carried through the layer's later products
    ok = bool(torch.isfinite(got).all().item()) and err <= 0.05 * scale and mean_err <= 2e-3 * scale
    return err, mean_err, scale, ok, (x, src, mask)


def gnn_bound(ws, N, K_, S, D=256):
    """The layer's least time: q and the merge over K tokens, k and v over S,
    both attention products, the two-layer MLP over [x, message]; each input
    and the weights read once, the output written once."""
    ops = 2 * N * D * D * (2 * K_ + 2 * S) + 4 * N * K_ * S * D + 2 * N * K_ * (2 * D) * (2 * D) + 2 * N * K_ * 2 * D * D
    nbytes = 2 * (2 * N * K_ * D + N * S * D) + N * S + sum(t.numel() * t.element_size() for t in ws)
    return bound(nbytes, ops, BF16_OPS)


def check_gnn(dev, gen, fe):
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain

    layer = fe.superglue.layers["cross_0"]
    ws, heads = layer.weights(), layer.num_heads
    N, D = 2 * PAIR_BATCH, 256
    err, mean_err, _, ok, (x, src, mask) = gnn_case(dev, gen, ws, heads, N, K, K, False)
    extra = []
    for n_, k_, s_, masked in GNN_EXTRA_SHAPES:
        e, me, top, o, (xe, se, me_) = gnn_case(dev, gen, ws, heads, n_, k_, s_, masked)
        extra.append(dict(shape=[n_, k_, s_, D], all_masked_sequence=masked, max_abs_err=e, mean_abs_err=me,
                          max_abs_ref=top, ok=o, ms=time_ms(lambda: gnn_layer(xe, se, me_, ws, heads)),
                          bound_ms=gnn_bound(ws, n_, k_, s_)[0]))
        ok &= o
    b_ms, b_by = gnn_bound(ws, N, K, K)
    return dict(
        name="gnn_layer", source="forest_slam_tpu_torch/csrc/gnn_layer.cu",
        replaces="forest_slam_tpu/frontend/pallas_gnn.py:214",
        tolerance="max <= 0.05 * max|ref|, mean <= 2e-3 * max|ref|",
        max_abs_err=err, mean_abs_err=mean_err, ok=ok, other_shapes=extra,
        ms=time_ms(lambda: gnn_layer(x, src, mask, ws, heads)),
        plain_ms=time_ms(lambda: gnn_layer_plain(x, src, mask, ws, heads)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


# the Sinkhorn kernel's shapes (B, K0, K1, one pair all invalid): the
# learned paths' pair batch, the lowres gate's 23 pairs of K = 512, and a
# ragged K0 != K1, not a multiple of 4, with a pair whose valid0 is all False
# and the 962-pair workload's 48 pairs and the gates' 15 and 7 (cluster plans
# at new batch sizes)
SINKHORN_SHAPES = ((PAIR_BATCH, K, K, False), (LOWRES_FRAMES - 1, LOWRES_K, LOWRES_K, False), (3, 200, 170, True),
                   (BENCH_PAIRS, K, K, False), (GATE_PAIRS[0], K, K, False), (GATE_PAIRS[1], K, K, False))


def sinkhorn_case(dev, gen, shape, alpha, iters):
    """The Sinkhorn kernel against its plain version at (B, K0, K1,
    dead_pair): (max score error, argmax agreement, ok, inputs)."""
    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import sinkhorn_decode, sinkhorn_decode_plain

    B, K0, K1, dead_pair = shape
    scores = torch.randn((B, K0, K1), generator=gen, device=dev) * 1.5
    scores = (scores + 6.0 * torch.eye(K0, K1, device=dev)).contiguous()
    valid0 = torch.rand((B, K0), generator=gen, device=dev) < 0.8
    valid1 = torch.rand((B, K1), generator=gen, device=dev) < 0.8
    if dead_pair:
        valid0[min(1, B - 1)] = False
    got = sinkhorn_decode(scores, valid0, valid1, alpha, iters)
    ref = sinkhorn_decode_plain(scores, valid0, valid1, alpha, iters)
    err = max((got[1] - ref[1]).abs().max().item(), (got[3] - ref[3]).abs().max().item())
    agree = min((got[0] == ref[0]).float().mean().item(), (got[2] == ref[2]).float().mean().item())
    # coupling probabilities from sums in another order: float32 rounding;
    # argmax indices may differ only on near-ties
    ok = err <= 1e-4 and agree >= 0.999
    return err, agree, ok, (scores, valid0, valid1, alpha, iters)


def sinkhorn_bound(B, K0, K1, iters):
    # per table entry: the row max's compare, s - r and its exp, two
    # multiply-adds an iteration (row and column sums), and a multiply and a
    # compare for each decode; a multiply-add counts as 2
    ops = B * K0 * K1 * (4 * iters + 7)
    nbytes = B * (K0 * K1 * 4 + (K0 + K1) * 4 + 2 * (K0 + K1) * 4)
    return bound(nbytes, ops, F32_OPS)


def check_sinkhorn(dev, gen, fe):
    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import launch_plan, sinkhorn_decode, sinkhorn_decode_plain

    iters = fe.cfg.superglue.sinkhorn_iterations
    per_shape, ok = [], True
    for shape in SINKHORN_SHAPES:
        err, agree, o, args = sinkhorn_case(dev, gen, shape, fe.superglue.bin_score, iters)
        ok &= o
        B, K0, K1, dead = shape
        b_ms, b_by = sinkhorn_bound(B, K0, K1, iters)
        per_shape.append(dict(shape=[B, K0, K1], dead_pair=dead, max_abs_err=err, argmax_agreement=agree, ok=o,
                              ms=time_ms(lambda: sinkhorn_decode(*args)),
                              plain_ms=time_ms(lambda: sinkhorn_decode_plain(*args)),
                              bound_ms=b_ms, bound_by=b_by, plan=launch_plan(B, K0, K1, dev)))
    main = per_shape[0]  # the 960x600 learned paths' shape
    return dict(
        name="sinkhorn_decode", source="forest_slam_tpu_torch/csrc/sinkhorn.cu",
        replaces="forest_slam_tpu/frontend/pallas_sinkhorn.py:143",
        tolerance="scores <= 1e-4 abs, argmax agreement >= 0.999",
        max_abs_err=max(p["max_abs_err"] for p in per_shape),
        argmax_agreement=min(p["argmax_agreement"] for p in per_shape), ok=ok,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, per_shape=per_shape,
    )


# the refine kernel's shapes (pairs, H0, W0, H1, W1, K, R), template 8: the
# learned paths' pair batch at 960x600, the lowres gate's 23 pairs at
# 224x160 and the 962-pair workload's 48 pairs at radius 12; the
# wide-baseline gates' 15 pairs at radius 24 with frame 0 upscaled by each
# refine scale against frame 1 at 960x600
REFINE_SHAPES = ((PAIR_BATCH, H, W, H, W, K, 12), (LOWRES_FRAMES - 1, LOWRES_H, LOWRES_W, LOWRES_H, LOWRES_W,
                                                   LOWRES_K, 12), (BENCH_PAIRS, H, W, H, W, K, 12)) + tuple(
    (GATE_PAIRS[0], int(round(H * s)), int(round(W * s)), H, W, K, WB_RADIUS) for s in WB_REFINE_SCALES)
REFINE_TEMPLATE = 8


def refine_case(dev, gen, shape):
    """The refine kernel against its plain version at (pairs, H0, W0, H1, W1,
    K, R), with template 8 and from a quarter to all keypoints valid a pair,
    frame-0 keypoints at the frame-1 keypoints' place scaled to frame 0:
    (max error, ok, bound (ms, by), inputs)."""
    from forest_slam_tpu_torch.frontend.refine_kernel import refine_cost_volume, refine_cost_volume_plain

    B, H0, W0, H1, W1, K_, R = shape
    t = REFINE_TEMPLATE
    n, S = 2 * R + 1, 2 * R + t
    # integer-valued images: every SAD sum is exact, so agreement is bit for bit
    img0 = torch.randint(0, 256, (B, H0, W0), generator=gen, device=dev).float()
    img1 = torch.randint(0, 256, (B, H1, W1), generator=gen, device=dev).float()
    ri = lambda lo, hi: torch.randint(lo, hi, (B, K_), generator=gen, device=dev, dtype=torch.int32)
    xi1, yi1 = ri(0, W1), ri(0, H1)
    xi0 = (xi1.float() * W0 / W1 + ri(-20, 21)).round().clamp(0, W0 - 1).int().contiguous()
    yi0 = (yi1.float() * H0 / H1 + ri(-20, 21)).round().clamp(0, H0 - 1).int().contiguous()
    nvalid = torch.randint(K_ // 4, K_ + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    args = (img0, img1, xi0, yi0, xi1, yi1, t, R, nvalid)
    err = (refine_cost_volume(*args) - refine_cost_volume_plain(*args)).abs().max().item()
    nv = int(nvalid.sum().item())
    nbytes = 4 * (sum(min(H0 * W0, int(v) * t * t) + min(H1 * W1, int(v) * S * S) for v in nvalid.tolist())
                  + 4 * B * K_ + B + B * K_ * n * n)
    return err, err == 0.0, bound(nbytes, nv * n * n * t * t * 3, F32_OPS), args


def check_refine(dev, gen):
    from forest_slam_tpu_torch.frontend.refine_kernel import refine_cost_volume, refine_cost_volume_plain

    per_shape, ok = [], True
    for shape in REFINE_SHAPES:
        err, o, (b_ms, b_by), args = refine_case(dev, gen, shape)
        ok &= o
        per_shape.append(dict(shape=list(shape), max_abs_err=err, ok=o,
                              ms=time_ms(lambda: refine_cost_volume(*args)),
                              plain_ms=time_ms(lambda: refine_cost_volume_plain(*args)),
                              bound_ms=b_ms, bound_by=b_by))
    main = per_shape[0]  # the 960x600 learned paths' shape
    return dict(
        name="refine_cost", source="forest_slam_tpu_torch/csrc/refine_cost.cu",
        replaces="forest_slam_tpu/frontend/pallas_refine.py:312", tolerance="exact (0)",
        max_abs_err=max(p["max_abs_err"] for p in per_shape), ok=ok,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, per_shape=per_shape,
    )


# float32 operations of the detection kernel (csrc/detect.cu), as its data
# gates them. Every pixel of a level: the cell reduction (1). Every pixel
# inside the edge margin: the exact early reject, ring points 0, 4, 8 and 12
# (4 differences, 8 compares). Every pixel past it: the other 12
# differences, their 24 compares into the bright and dark masks and two
# run-of-9 tests of 8 shifts and ands (52). Every pixel of a row that holds a
# FAST corner: Sobel, scaling and the three products (13) and the box sums
# over rows (18). Every FAST corner: the box sums over columns (18), the
# Harris response (7) and 3x3 NMS (9). (The earlier one-level kernel spent
# 180 operations on FAST at every pixel inside the margin: 64 minima and 64
# maxima over circular windows and 32 to pick the best arcs; the mask test
# needs only whether an arc exists.)
DETECT_OPS_PER_PIXEL = 1
DETECT_OPS_PER_INTERIOR_PIXEL = 12
DETECT_OPS_PER_CANDIDATE = 52
DETECT_OPS_PER_CORNER_ROW_PIXEL = 31
DETECT_OPS_PER_CORNER = 34


def detect_ops(img, threshold, margin):
    """The detection kernel's operations on (B, h, w) images, as above."""
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


def detect_case(dev, gen, batch=FRAME_BATCH):
    """Random 0-255 levels at the eight pyramid shapes of a batch of
    ``batch`` 960x600 frames: (levels, (threshold, harris_block, margin))."""
    from forest_slam_tpu_torch.frontend.orb import OrbConfig, _level_geometry

    cfg = OrbConfig(n_features=ORB_FEATURES, n_levels=ORB_LEVELS)
    sizes, _ = _level_geometry(H, W, cfg)
    levels = [(torch.rand((batch, h, w), generator=gen, device=dev) * 255.0).contiguous() for h, w, _ in sizes]
    return levels, (cfg.fast_threshold, cfg.harris_block, cfg.edge_margin)


def detect_agreement(got, ref):
    """Per-level (vals, idx) of the kernel against the plain version's:
    (max error, finite masks equal, indices equal, values within rtol 1e-5,
    finite cells)."""
    err, mask_eq, idx_eq, close, n_finite = 0.0, True, True, True, 0
    for (v, i), (rv, ri) in zip(got, ref):
        fin = torch.isfinite(rv)
        n_finite += int(fin.sum().item())
        mask_eq &= torch.equal(torch.isfinite(v), fin)
        idx_eq &= torch.equal(i[fin], ri[fin])
        if mask_eq and fin.any():
            err = max(err, (v[fin] - rv[fin]).abs().max().item())
            close &= torch.allclose(v[fin], rv[fin], rtol=1e-5, atol=0.0)
    return err, mask_eq, idx_eq, close, n_finite


def check_detect(dev, gen):
    from forest_slam_tpu_torch.frontend.detect_kernel import (
        detect_pooled, detect_pooled_levels, detect_pooled_plain, n_cells)

    levels, args = detect_case(dev, gen)
    plain = lambda: [detect_pooled_plain(lv, *args) for lv in levels]
    err, mask_eq, idx_eq, close, n_finite = detect_agreement(detect_pooled_levels(levels, *args), plain())
    # the 962-pair ORB run's batches of 32 frames, all levels in one launch
    big, _ = detect_case(dev, gen, BENCH_FRAMES)
    b_err, b_mask, b_idx, b_close, b_fin = detect_agreement(detect_pooled_levels(big, *args),
                                                           [detect_pooled_plain(lv, *args) for lv in big])
    err, mask_eq, idx_eq, close, n_finite = (max(err, b_err), mask_eq and b_mask, idx_eq and b_idx,
                                             close and b_close, n_finite + b_fin)

    def detect_bound(lvs):
        nbytes = sum(4 * lv.numel() + 8 * lv.shape[0] * n_cells(*lv.shape[1:])[0] * n_cells(*lv.shape[1:])[1]
                     for lv in lvs)
        return bound(nbytes, sum(detect_ops(lv, args[0], args[2]) for lv in lvs), F32_OPS)

    b_ms, b_by = detect_bound(levels)
    return dict(
        name="detect", source="forest_slam_tpu_torch/csrc/detect.cu",
        replaces="forest_slam_tpu/frontend/pallas_detect.py:277",
        tolerance="same finite mask, values rtol 1e-5, indices equal",
        max_abs_err=err, mask_equal=mask_eq, indices_equal=idx_eq, finite_cells=n_finite,
        ok=mask_eq and idx_eq and close and n_finite > 0,
        # per launch, one launch over the eight levels of a batch of frames:
        # launches x ms is the kernel's time in a run
        ms=time_ms(lambda: detect_pooled_levels(levels, *args)), plain_ms=time_ms(plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        # each level alone, one launch of detect_pooled each
        level_ms=[time_ms(lambda: detect_pooled(lv, *args)) for lv in levels],
        bench_batch_ms=time_ms(lambda: detect_pooled_levels(big, *args)), bench_batch_bound_ms=detect_bound(big)[0],
    )


def peaky_heat(dev, gen, shape):
    """Heat maps of SuperPoint's kind: most pixels tiny, 1% clear peaks."""
    heat = torch.rand(shape, generator=gen, device=dev) * 0.004
    peaks = torch.rand(shape, generator=gen, device=dev)
    return torch.where(peaks > 0.99, peaks, heat).contiguous()


# comparisons per pixel of the select function: a separable (2r+1)^2 window
# maximum done plainly (2 * 2r; csrc/select.cu shares partial maxima between
# neighbouring windows and does fewer), the three tests and the block
# reduction. The bytes bound it at every radius the paths use.
def select_ops_per_pixel(radius):
    return 4 * radius + 4


# the select kernel's shapes: a batch of 8 960x600 heat maps, the lowres
# gate's three octaves of 24 frames, the 962-pair workload's 32 frames and
# the wide-baseline octaves of a K=10 gate's 16 frames
def select_shapes():
    from forest_slam_tpu_torch.frontend.learned import octave_shape

    s8 = 32  # the flagship's stem 4 x 8
    return ([(FRAME_BATCH, H, W)] + [(LOWRES_FRAMES, *octave_shape(LOWRES_H, LOWRES_W, s, s8)) for s in LOWRES_SCALES]
            + [(BENCH_FRAMES, H, W)] + [(GATE_PAIRS[0] + 1, *octave_shape(H, W, s, s8)) for s in WB_OCTAVES])


def select_case(dev, gen, shape):
    """The select kernel against its plain version on peaky heat of (B, H,
    W): (bit-exact, kept blocks, bound (ms, by), heat)."""
    from forest_slam_tpu_torch.frontend.select_kernel import nms_block_max, nms_block_max_plain

    heat = peaky_heat(dev, gen, shape)
    v, i = nms_block_max(heat)
    rv, ri = nms_block_max_plain(heat)
    B_, H_, W_ = shape
    b = bound(4 * B_ * H_ * W_ + 8 * B_ * (H_ // 4) * (W_ // 4), select_ops_per_pixel(4) * B_ * H_ * W_, F32_OPS)
    return torch.equal(v, rv) and torch.equal(i, ri), int((rv > 0).sum().item()), b, heat


def check_select(dev, gen):
    from forest_slam_tpu_torch.frontend.select_kernel import nms_block_max, nms_block_max_plain

    exact, per_shape, n_kept = True, [], 0
    for shape in select_shapes():
        ex, kept, (b_ms, b_by), heat = select_case(dev, gen, shape)
        exact &= ex
        n_kept += kept
        per_shape.append(dict(shape=list(shape), ms=time_ms(lambda: nms_block_max(heat)),
                              plain_ms=time_ms(lambda: nms_block_max_plain(heat)), bound_ms=b_ms, bound_by=b_by))
    main = per_shape[0]  # the 960x600 paths' shape
    return dict(
        name="select", source="forest_slam_tpu_torch/csrc/select.cu",
        replaces="forest_slam_tpu/frontend/pallas_select.py:167", tolerance="exact (values and indices equal)",
        max_abs_err=0.0 if exact else float("inf"), kept_blocks=n_kept, ok=exact and n_kept > 0,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None, per_shape=per_shape,
    )


def attention_case(dev, gen, shape):
    """The attention kernel against its plain version on q, k, v of
    (B, h, K, S) with the last sequence's sources all masked: (max error,
    mean error, largest |ref|, ok, error of the masked sequence against the
    mean of its v, inputs)."""
    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward, masked_attention_plain

    B, h, K_, S = shape
    q = (torch.randn((B, h, K_, HEAD_DIM), generator=gen, device=dev) * 2).to(torch.bfloat16)
    k = (torch.randn((B, h, S, HEAD_DIM), generator=gen, device=dev) * 2).to(torch.bfloat16)
    v = torch.randn((B, h, S, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.rand((B, S), generator=gen, device=dev) < 0.7
    mask[-1] = False  # a sequence whose sources are all masked: its queries average v
    scale = 1.0 / HEAD_DIM ** 0.5
    got = attention_forward(q, k, v, mask, scale).float()
    ref = masked_attention_plain(q, k, v, mask, scale).float()
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    mean_err = (got - ref).abs().mean().item()
    # bf16 probabilities and output: sums in another order may flip a rounding
    ok = bool(torch.isfinite(got).all().item()) and err <= 2.0 ** -7 * top and mean_err <= 1e-3 * max(top, 1.0)
    masked_row_err = (got[-1] - v[-1].float().mean(dim=1, keepdim=True)).abs().max().item()
    return err, mean_err, top, ok, masked_row_err, (q, k, v, mask, scale)


def check_attention(dev, gen):
    import torch.nn.functional as F

    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward, masked_attention_plain

    B = 2 * PAIR_BATCH  # both images of a pair batch in one launch
    err, mean_err, _, ok, masked_row_err, (q, k, v, mask, scale) = attention_case(dev, gen, (B, HEADS, K, K))
    r_err, r_mean, r_top, r_ok, r_masked, _ = attention_case(dev, gen, ATTENTION_RAGGED)
    amask = mask[:, None, None, :]
    sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale)
    b_ms, b_by = bound(4 * q.numel() * 2 + mask.numel(), 4 * B * HEADS * K * K * HEAD_DIM, BF16_OPS)
    return dict(
        name="attention", source="forest_slam_tpu_torch/csrc/attention.cu",
        replaces="forest_slam_tpu/frontend/pallas_attention.py:149",
        tolerance="max <= 2^-7 * max|ref|, mean <= 1e-3 * max|ref|",
        max_abs_err=err, mean_abs_err=mean_err, masked_row_err=masked_row_err, ok=ok and r_ok,
        ragged=dict(shape=list(ATTENTION_RAGGED), max_abs_err=r_err, mean_abs_err=r_mean, max_abs_ref=r_top,
                    masked_row_err=r_masked, ok=r_ok),
        sdpa_nan_rows=bool(torch.isnan(sdpa[-1]).any().item()),
        ms=time_ms(lambda: attention_forward(q, k, v, mask, scale)),
        plain_ms=time_ms(lambda: masked_attention_plain(q, k, v, mask, scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale)),
    )


def render_frames(dev, h, w, n):
    """n consecutive corridor frames at w x h rendered on the card: (left,
    right, ground-truth poses, rig)."""
    from forest_slam_tpu_torch.core.lie import se3_compose
    from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, default_rig, make_corridor_world, render_view

    world = make_corridor_world(seed=0, device=dev)
    rig = default_rig(h, w, baseline=0.25, device=dev)
    Ts = corridor_trajectory(n, speed=0.15, device=dev)
    il, ir = [], []
    for s in range(0, n, 8):
        T = Ts[s:s + 8]
        il.append(render_view(world, T, rig.left.K, h, w)[0])
        ir.append(render_view(world, se3_compose(T, rig.T_left_right), rig.left.K, h, w)[0])
    return torch.cat(il), torch.cat(ir), Ts, rig


def render_clip(dev):
    il, ir, Ts, rig = render_frames(dev, H, W, UNIQUE_FRAMES)
    # ping-pong 0..U-1, U-2..1, ... so consecutive frames stay adjacent
    period = np.concatenate([np.arange(UNIQUE_FRAMES), np.arange(UNIQUE_FRAMES - 2, 0, -1)])
    idx = np.tile(period, -(-N_FRAMES // len(period)))[:N_FRAMES]
    sel = torch.as_tensor(idx, device=dev)
    return il[sel].contiguous(), ir[sel].contiguous(), Ts[sel], rig


def ate(poses, gt):
    from forest_slam_tpu_torch.eval.metrics import ape_translation
    from forest_slam_tpu_torch.io.tum import Trajectory

    ts = np.arange(gt.shape[0]) * 0.1
    est = Trajectory.from_matrices(ts[1:], poses.double().cpu().numpy())
    ref = Trajectory.from_matrices(ts, gt.double().cpu().numpy())
    return ape_translation(est, ref, align=True, with_scale=False).rmse


def drive_path(wrappers, run):
    """Run one main path with every launch count set to 0 just before it:
    (its result, its launch counts, its wall time)."""
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    out = run()
    torch.cuda.synchronize()
    elapsed = time.time() - t
    return out, {name: fn.launches for name, fn in wrappers.items()}, elapsed


def path_failures(name, out, tracked, err, launches, path_kernels, n_pairs=N_FRAMES - 1, max_ate=MAX_ATE_M,
                  idle_kernels=()):
    failures = []
    if not (bool(torch.isfinite(out.pose).all().item()) and tuple(out.pose.shape) == (n_pairs, 4, 4)):
        failures.append(f"{name}: poses not finite or of the wrong shape")
    if tracked < MIN_TRACKED * n_pairs:
        failures.append(f"{name}: only {tracked}/{n_pairs} pairs tracked")
    if not err < max_ate:
        failures.append(f"{name}: ATE {err} m >= {max_ate} m")
    zero = [k for k in path_kernels if launches[k] == 0]
    if zero:
        failures.append(f"{name}: kernels never launched on the path: {zero}")
    busy = [k for k in idle_kernels if launches[k] != 0]
    if busy:
        failures.append(f"{name}: kernels launched that the path must not run: {busy}")
    return failures


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "forest_slam_tpu_torch")):
        print("FAIL: run from a checkout of the repository (forest_slam_tpu_torch/ is missing)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from forest_slam_tpu_torch import _build

    t0 = time.time()
    path = _build.build()
    log(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s (cached={_build.last_build['cached']})")
    for line in _build.last_build["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)

    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.detect_kernel import detect_pooled
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.frontend.refine_kernel import refine_cost_volume
    from forest_slam_tpu_torch.frontend.select_kernel import nms_block_max
    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import sinkhorn_decode
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo, run_stereo_vo_device
    from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows

    fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev)
    log(f"loaded {os.path.relpath(FLAGSHIP_PATH, ROOT)}: stem {fe.cfg.superpoint.stem_stride}, "
        f"{fe.cfg.superglue.gnn_layers} GNN layers, {fe.cfg.superglue.sinkhorn_iterations} Sinkhorn iterations")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = []
    with torch.no_grad():
        for check in (lambda: check_sparse(dev, gen), lambda: check_gnn(dev, gen, fe),
                      lambda: check_sinkhorn(dev, gen, fe), lambda: check_refine(dev, gen),
                      lambda: check_detect(dev, gen), lambda: check_select(dev, gen),
                      lambda: check_attention(dev, gen)):
            r = check()
            results.append(r)
            log(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.6g} (tolerance {r['tolerance']}) "
                f"{'PASS' if r['ok'] else 'FAIL'}; {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
                + (f"; scaled_dot_product_attention {r['library_ms']:.4f} ms" if r["library_ms"] is not None else ""))
    by_name = {r["name"]: r for r in results}
    det = by_name["detect"]
    log(f"  detect over the eight levels (B={FRAME_BATCH} and {BENCH_FRAMES}) in one launch: mask equal "
        f"{det['mask_equal']}, indices equal {det['indices_equal']}, {det['finite_cells']} finite cells; one level a "
        f"launch, ms {[round(t, 4) for t in det['level_ms']]}; B={BENCH_FRAMES} {det['bench_batch_ms']:.4f} ms, bound "
        f"{det['bench_batch_bound_ms']:.4f} ms")
    ref = by_name["refine_cost"]
    log("  refine_cost per shape (pairs, H0, W0, H1, W1, K, R): "
        + "; ".join(f"{tuple(p['shape'])} max error {p['max_abs_err']:.3g}, {p['ms']:.4f} ms vs plain "
                    f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms by {p['bound_by']}"
                    for p in ref["per_shape"]))
    spc = by_name["sparse_cost"]
    log("  sparse_cost per shape (frames, H, W, K), D=96, w=7: "
        + "; ".join(f"{tuple(p['shape'])} max error {p['max_abs_err']:.3g}, {p['ms']:.4f} ms vs plain "
                    f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms by {p['bound_by']}"
                    for p in spc["per_shape"]))
    sel = by_name["select"]
    log(f"  select: {sel['kept_blocks']} kept blocks, bit-exact at every shape; per shape (B, H, W): "
        + "; ".join(f"{tuple(p['shape'])} {p['ms']:.4f} ms vs plain {p['plain_ms']:.4f} ms, bound "
                    f"{p['bound_ms']:.4f} ms by {p['bound_by']}" for p in sel["per_shape"]))
    att = by_name["attention"]
    log(f"  attention at ({2 * PAIR_BATCH}, {HEADS}, {K}, {HEAD_DIM}): mean error {att['mean_abs_err']:.3g}; the "
        f"fully masked sequence averages v to {att['masked_row_err']:.3g}; scaled_dot_product_attention gives "
        f"NaN there: {att['sdpa_nan_rows']}; {att['ms'] / att['library_ms']:.2f}x its time")
    rag = att["ragged"]
    log(f"  attention at (B, h, K, S) = {tuple(rag['shape'])}: max error {rag['max_abs_err']:.6g} of "
        f"{rag['max_abs_ref']:.4g}, mean {rag['mean_abs_err']:.3g}, fully masked sequence to "
        f"{rag['masked_row_err']:.3g}: {'PASS' if rag['ok'] else 'FAIL'}")
    skh = by_name["sinkhorn_decode"]
    for p in skh["per_shape"]:
        pl = p["plan"]
        log(f"  sinkhorn_decode at (B, K0, K1) = {tuple(p['shape'])}{', one pair all invalid' if p['dead_pair'] else ''}: "
            f"max error {p['max_abs_err']:.3g}, argmax agreement {p['argmax_agreement']:.4f}, "
            f"{'PASS' if p['ok'] else 'FAIL'}; {p['ms']:.4f} ms vs plain {p['plain_ms']:.4f} ms, bound "
            f"{p['bound_ms']:.4f} ms by {p['bound_by']}; launch: cluster of {pl['cluster']} CTAs per pair, "
            f"{pl['rows_per_cta']} rows per CTA ({pl['smem_rows']} in shared memory, {pl['l2_rows']} in L2), "
            f"{pl['smem_bytes']} bytes of shared memory per CTA, {pl['threads']} threads, "
            f"{pl['active_clusters']} clusters active at once, {pl['waves']} wave(s)")
    gnn = by_name["gnn_layer"]
    for o in gnn["other_shapes"]:
        log(f"  gnn_layer at (N, K, S, D) = {tuple(o['shape'])}{', one sequence fully masked' if o['all_masked_sequence'] else ''}: "
            f"max error {o['max_abs_err']:.6g} of {o['max_abs_ref']:.4g}, mean {o['mean_abs_err']:.3g}: "
            f"{'PASS' if o['ok'] else 'FAIL'}; {o['ms']:.4f} ms, bound {o['bound_ms']:.4f} ms")
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        print(f"FAIL: kernels disagree with their plain versions: {bad}", file=sys.stderr)
        return 1

    il, ir, gt, rig = render_clip(dev)
    torch.cuda.synchronize()
    log(f"rendered {UNIQUE_FRAMES} corridor frames at {W}x{H} on the card, ping-pong to {N_FRAMES} frames")
    n_pairs = N_FRAMES - 1
    wrappers = {"sparse_cost": sparse_cost_rows, "gnn_layer": gnn_layer, "sinkhorn_decode": sinkhorn_decode,
                "refine_cost": refine_cost_volume, "detect": detect_pooled, "select": nms_block_max,
                "attention": attention_forward}
    ms_of = {r["name"]: r["ms"] for r in results}
    failures, launches_by_path = [], {}

    def report(name, out, t_run, launches, truth=None, shares=True):
        truth = gt if truth is None else truth
        pairs = truth.shape[0] - 1
        tracked = int(out.ok.sum().item())
        err = ate(out.pose, truth)
        log(f"{name} path: {tracked}/{pairs} pairs tracked, ATE {err:.4f} m, {pairs / t_run:.2f} pairs/s "
            f"({t_run:.3f} s) on {torch.cuda.get_device_name(0)} ({smi}); launches {launches}")
        for k, n in launches.items():
            if n and shares:
                est = n * ms_of[k] / 1e3
                log(f"  {k}: {n} launches x {ms_of[k]:.4f} ms (kernel phase's shapes) = {est:.4f} s, "
                    f"{100 * est / t_run:.1f}% of the run")
        return tracked, err

    def compare(name, out, plain_out, t_plain):
        ok_agree = (plain_out.ok == out.ok).float().mean().item()
        dpose = (plain_out.pose[:, :3, 3] - out.pose[:, :3, 3]).norm(dim=-1).max().item()
        log(f"{name} plain path: {int(plain_out.ok.sum().item())}/{n_pairs} tracked, "
            f"ATE {ate(plain_out.pose, gt):.4f} m, {t_plain:.3f} s; ok agreement {ok_agree:.3f}, "
            f"largest position difference {dpose:.4f} m")
        return ok_agree

    # ORB path: the JAX package's default front end, bench.py --frontend orb
    orb_cfg = StereoConfig(orb=OrbConfig(n_features=ORB_FEATURES, n_levels=ORB_LEVELS), max_match_distance=64,
                           n_hypotheses=1024, compose_mode="odometry", match_refine_radius=0)
    ts = np.arange(N_FRAMES) * 0.1

    def run_orb(c):
        return lambda: run_stereo_vo(il, ir, ts, rig, c, seed=0, frame_batch=FRAME_BATCH,
                                     pair_batch=PAIR_BATCH)[1]

    _, _, t_cold = drive_path(wrappers, run_orb(orb_cfg))
    log(f"ORB path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_orb(orb_cfg))
    launches_by_path["orb"] = launches
    tracked, err = report("ORB", out, t_run, launches)
    failures += path_failures("ORB", out, tracked, err, launches, ("detect", "sparse_cost"))
    if launches["detect"] != N_FRAMES // FRAME_BATCH:  # one launch per frame batch, all levels in it
        failures.append(f"ORB: {launches['detect']} detect launches, not one per frame batch")
    plain_orb = orb_cfg._replace(orb=orb_cfg.orb._replace(detect_path="plain"),
                                 sparse=orb_cfg.sparse._replace(cost_path="plain"))
    plain_out, _, t_plain = drive_path(wrappers, run_orb(plain_orb))
    if compare("ORB", out, plain_out, t_plain) < 1.0:
        failures.append("ORB: the kernels and the plain versions track different pairs")

    # learned path: SuperPoint + SuperGlue, the bench's default
    cfg = StereoConfig(n_hypotheses=1024, compose_mode="odometry", match_refine_radius=12)
    frontend = learned_frontend(fe)

    def run_learned(c, f):
        def run():
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            return run_stereo_vo_device(il, ir, rig, c, g, f, frame_batch=FRAME_BATCH, pair_batch=PAIR_BATCH)
        return run

    _, _, t_cold = drive_path(wrappers, run_learned(cfg, frontend))
    log(f"learned path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_learned(cfg, frontend))
    launches_by_path["learned"] = launches
    tracked, err = report("learned", out, t_run, launches)
    failures += path_failures("learned", out, tracked, err, launches,
                              ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost"))
    plain_sp = {"nms_backend": "plain"}
    plain_fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev, superpoint_overrides=plain_sp,
                                     superglue_overrides={"gnn_impl": "plain", "sinkhorn_impl": "plain"})
    plain_cfg = cfg._replace(sparse=cfg.sparse._replace(cost_path="plain"), match_refine_cost_path="plain")
    plain_out, _, t_plain = drive_path(wrappers, run_learned(plain_cfg, learned_frontend(plain_fe)))
    compare("learned", out, plain_out, t_plain)
    del plain_fe

    # learned path with the unfused GNN: bench.py --sg-gnn xla
    fe_x = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev,
                                 superglue_overrides={"gnn_impl": "xla", "attention_impl": "auto"})
    _, _, t_cold = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_x)))
    log(f"unfused-GNN path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_x)))
    launches_by_path["unfused"] = launches
    tracked, err = report("unfused-GNN", out, t_run, launches)
    failures += path_failures("unfused-GNN", out, tracked, err, launches,
                              ("attention", "select", "sparse_cost", "sinkhorn_decode", "refine_cost"),
                              idle_kernels=("gnn_layer",))
    del fe_x
    plain_fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev, superpoint_overrides=plain_sp,
                                     superglue_overrides={"gnn_impl": "xla", "attention_impl": "plain",
                                                          "sinkhorn_impl": "plain"})
    plain_out, _, t_plain = drive_path(wrappers, run_learned(plain_cfg, learned_frontend(plain_fe)))
    compare("unfused-GNN", out, plain_out, t_plain)
    del plain_fe

    # lowres gate: bench.py:626-682 at its default flags
    from forest_slam_tpu_torch import bench

    run_lowres, gt_g, scales = bench.lowres_setup(dev)
    _, _, t_cold = drive_path(wrappers, run_lowres)
    log(f"lowres gate warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_lowres)
    launches_by_path["lowres"] = launches
    tracked, err = report("lowres gate", out, t_run, launches, truth=gt_g, shares=False)
    log(f"  lowres gate at {LOWRES_W}x{LOWRES_H}, octaves {scales}: {tracked}/{LOWRES_FRAMES - 1} tracked, "
        f"ATE {err:.4f} m; the reference's record: {LOWRES_REFERENCE}")
    failures += path_failures("lowres gate", out, tracked, err, launches,
                              ("select", "gnn_layer", "sparse_cost", "sinkhorn_decode", "refine_cost"),
                              n_pairs=LOWRES_FRAMES - 1, max_ate=LOWRES_MAX_ATE_M)
    del plain_out, out
    torch.cuda.empty_cache()

    # bench.py's 962-pair workload, learned then ORB
    records = {}
    for kind, n_timed, path_kernels in (("sp", 3, ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode",
                                                   "refine_cost")),
                                        ("orb", 1, ("detect", "sparse_cost"))):
        wl = bench.prepare_workload(kind, dev, fe=fe if kind == "sp" else None)
        name = f"bench_{'learned' if kind == 'sp' else 'orb'}"
        if kind == "sp" and wl.frontend != "superpoint_superglue":
            failures.append(f"{name}: the learned front end fell back to ORB ({wl.sanity_matches} matches on "
                            "adjacent frames)")
        _, _, t_cold = drive_path(wrappers, wl.run)
        log(f"{name}: {wl.truth.shape[0] - 1} pairs at {W}x{H} ({bench.N_UNIQUE} unique frames ping-ponged), "
            f"frontend {wl.frontend}; warm-up run {t_cold:.2f} s")
        (times, out), launches, _ = drive_path(wrappers, lambda: bench.timed_runs(wl.run, n_timed))
        launches_by_path[name] = launches
        rec = bench.workload_record(out, wl.truth, times, wl.frontend)
        records[name] = rec
        log(f"{name}: {rec['value']} pairs/s (median of {len(times)} runs {rec['runs_s']} s, spread "
            f"{rec['run_spread']}), {rec['ok_frames']}/{rec['n_frames']} pairs tracked, ATE {rec['ate_rmse']} m, "
            f"RPE {rec['rpe']['rmse_pct']} % over {rec['rpe']['delta_m']} m ({rec['rpe']['n']} pairs), on "
            f"{torch.cuda.get_device_name(0)} ({smi}); launches {launches}")
        failures += path_failures(name, out, rec["ok_frames"], rec["ate_rmse"], launches, path_kernels,
                                  n_pairs=rec["n_frames"], max_ate=BENCH_MAX_ATE_M)
        del wl, out
        torch.cuda.empty_cache()
    print(json.dumps({"bench": records}), flush=True)

    # the gate suite: bench.py's vo gates, worst of seeds 0 and 1
    t0 = time.time()
    (gates, gate_failures, not_run), launches, _ = drive_path(
        wrappers, lambda: bench.run_gates(dev, fe=fe, lowres=False))
    launches_by_path["gates"] = launches
    log(f"gate suite in {time.time() - t0:.1f} s on {torch.cuda.get_device_name(0)} ({smi}); launches {launches}")
    for gate in bench.GATES:
        if gate.tag in not_run:
            print(f"gate {gate.tag}: not run: checkpoint not on the card", flush=True)
            continue
        print(f"gate {gate.tag}: {gates[gate.tag + '_ok']}/{gates[gate.tag + '_n']} tracked, ATE "
              f"{gates[gate.tag + '_ate']} m (worst of seeds {list(bench.GATE_SEEDS)}: {gates[gate.tag + '_seeds']}); "
              f"bounds >= {gate.min_ok}, <= {gate.max_ate} m; {'held' if gate.held else 'printed, not held'}",
              flush=True)
    held = {g.tag for g in bench.GATES if g.held}
    failures += [f"gate {f}" for f in gate_failures if f.split(":")[0] in held]
    zero = [k for k in ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost") if launches[k] == 0]
    if zero:
        failures.append(f"gates: kernels never launched: {zero}")
    print(json.dumps({"gates": gates, "gate_failures": gate_failures or None, "not_run": not_run}), flush=True)

    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1

    kernels = []
    for r in results:
        by_path = {p: counts[r["name"]] for p, counts in launches_by_path.items()}
        kernels.append({k: r[k] for k in ("name", "source", "replaces")}
                       | {"route": "cuda", "launches": sum(by_path.values()), "launches_by_path": by_path}
                       | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(f"done: {time.time() - T_START:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
