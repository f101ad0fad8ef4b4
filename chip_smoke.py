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
   with one sequence whose sources are all masked; and LightGlue's self
   block (rotary q/k, GELU) and cross block (q and k from one projection,
   GELU), LayerNorm eps 1e-5, at the ``sp_lightglue.seq962`` cell's 96
   sequences of 2048 with full-strength weights, each beside an fp8 control
   that must miss its tolerance, its bound from the front end's
   ``layer_cost``; PnP-RANSAC's
   refine-and-select kernel at each shape of ``PNP_SHAPES`` (the learned
   chunk's 48 pairs of K=1024, the ORB cell's 192 and the clip's 8 of 512,
   the wide-baseline gate's 15 with P3P, loop verification's 16, the
   streaming step's one, a bag batch and 256 hypotheses under BotanicGarden's
   distortion), held by ``pnp_refine_agreement``, one launch a call, each
   shape's time one launch alone and back to back);
4. ORB path: renders a 960x600 corridor clip on the card and runs stereo VO
   through ``run_stereo_vo`` with its default ORB front end (512 features,
   8 levels, Hamming distance <= 64, 1024 DLT-6 hypotheses, no refinement),
   counting the kernels' launches (``pnp_refine`` once a pair batch); then
   the same frames through the plain versions, which must track the same
   pairs;
5. learned path: loads the flagship checkpoint and runs stereo VO (K=1024,
   refine radius 12, 1024 DLT-6 hypotheses) on the same clip through the
   kernels, counting their launches (``pnp_refine`` once a pair batch);
   then the same frames through the plain versions for comparison; then
   SuperPoint at K=2048 + LightGlue (9 layers, the ``sp_lightglue``
   configuration's weight draw) on the same clip, held as the learned path,
   ``gnn_layer`` launched 18 times a pair batch and ``sinkhorn_decode``
   never;
6. learned path with the unfused GNN (``bench.py --sg-gnn xla``): the same
   run with every GNN layer op by op around the attention kernel, which
   must launch while the fused layer kernel does not; then the plain
   versions; then the same with ``--sg-attention flash`` (the library's
   ``scaled_dot_product_attention``): held to 90% tracked, ATE printed,
   neither ``attention`` nor ``gnn_layer`` launched;
7. lowres gate (``bench.py:626-682``, run through
   ``forest_slam_tpu_torch.bench.lowres_setup``): 24 corridor frames at
   224x160, extracted at octaves (1.0, 1.7, 2.89), K=512, 512 hypotheses,
   refine radius 12, frame and pair batches of 24, held to 21/23 tracked and
   ATE below 0.05 m;
8. dense stereo (``StereoConfig(dense_depth=True)``, the reference's
   SGBM parity path, ``SgmConfig()``: D=96, block 7): the flagship learned
   front end on the 31-pair clip with depth read from SGM maps, held to
   90% tracked and ATE below 0.25 m, ``select``, ``gnn_layer``,
   ``sinkhorn_decode`` and ``refine_cost`` launched and ``sparse_cost``
   not; SGM ms a frame and pairs/s printed; then SGM on the card over the
   OpenCV fixture ``tests/fixtures/sgm_cv2.npz`` (600x960, D=96) within
   ``tests/test_stereo_disparity.py``'s bounds against cv2 and the rendered
   ground truth, and equal to the port's CPU result on every pixel;
9. monocular VO (``forest-slam mono``, ``run_mono_vo`` with 1024
   hypotheses) on the clip's 32 left frames with ``rig.left``, four runs,
   each with its launch counts reset: (a) ORB at ``forest-slam mono``'s
   defaults (parity, 5-point), held to 80% tracked (tests/test_pipeline_mono.py's
   rule for parity), launching ``detect`` and nothing else, the same frames
   through the plain versions tracking the same pairs; (b) ORB in odometry
   mode (8-point), held to 90% tracked and a Sim(3)-aligned ATE below 5%
   of the path (0.2325 m), the scan runner once on the same frames giving
   the batched run's poses; (c) the learned flagship at K=1024, parity,
   5-point (the reference's ``mono_slam.py`` configuration), held to 80%,
   launching ``select``, ``gnn_layer`` and ``sinkhorn_decode`` and not
   ``refine_cost`` or ``sparse_cost``; (d) the learned flagship in odometry
   mode, held as (b). Each prints pairs/s, tracked pairs and the Sim(3) ATE
   (a parity run's ATE is printed, not held: parity composes point
   transforms); (a) and (c) also the ms and added peak memory of one 5-point
   ``estimate_relative_pose`` of a pair batch;
10. the back end (``forest-slam slam``/``stereo``): (a) tests/test_slam.py's
   out-and-back corridor (72 frames, the PRNGKey(3) world drawn by
   ``utils/threefry.py``) at 960x600 through ``run_slam`` (odometry,
   keyframe stride 4, 16 loop candidates at 6 keyframes, similarity 0.5,
   25 inliers, P3P at 512 hypotheses): ORB (512 features, 8 levels) and the
   learned flagship (K=1024, radius 12) with and without ``WindowBAConfig()``,
   held to the test's rules (tracked above 90%, a loop accepted 6 or more
   keyframes apart, the end error below the VO's and below 0.15 m); ORB held
   to tracking and the end error, its loop rules printed (its signatures
   cannot find the revisit at 960x600); ORB with DLT-6 printed; (b) tests/test_relocalize.py's scene (24 frames,
   frame 12 noise) at 960x600, ORB, ``relocalize_trajectory``: both noise
   pairs lost, frame 13 repaired against a frame before 12, the end error
   from above 0.25 m to below 0.1 m and a third of before; (c) the
   962-pair workload (learned, batches of 32 and 48) through
   ``run_stereo_vo(ba=WindowBAConfig())`` and ``run_slam`` (keyframe stride
   5: 193 keyframes, the default loop configuration), then SLAM with BA
   with its stages timed: 962/962 tracked in each, BA's ATE below 1.05x the
   VO's; pairs/s, ATE, stage ms, loops and peak memory printed; (d) on the
   31-pair clip, ORB: ``mode="scan"`` tracks the batched run's pairs, and
   ``run_stereo_vo_streaming`` in chunks of 8 writes the trajectory it
   returns, equal to the scan's within 1e-4 m;
11. the 962-pair workload of ``bench.py`` through
   ``forest_slam_tpu_torch.bench``: 64 unique 960x600 frames ping-ponged to
   963, frame and pair batches of 32 and 48; the learned front end (a
   fall-back to ORB fails the run) with a warm-up and three timed runs
   (three more when they spread by over 10%), then ORB with a warm-up and
   one timed run; each held to 90% of its pairs tracked and ATE below
   0.25 m, with pairs/s, ATE and RPE printed, and the bench's roofline
   (``mfu``, ``hbm_frac``, ``roofline_frac``, each held in (0, 1]) beside
   the card's name and power limit; the learned workload once more through the chunked
   runner (``run_stereo_vo_batched`` with ``frame_indices``), whose poses
   and ok flags must equal the device runner's; then ``python -m
   forest_slam_tpu_torch.bench --frames 97 --no-gates --runner chunked
   --profile DIR`` in a process of its own, which must exit 0 with every
   field of ``bench.py``'s emit, a non-null ``mfu`` and a written trace;
12. the gate suite of ``bench.py`` (``forest_slam_tpu_torch.bench.run_gates``):
   each vo gate's clip rendered on the card, worst of seeds 0 and 1; the
   gates that pass in the JAX package's record (``BENCH_r05.json``) are held
   to ``bench.py``'s bounds, ``blur_wb_k10`` and ``plain_k20`` (which fail
   there too) are printed only; the plain gates print that they did not run
   where their checkpoint is absent;
13. training (``python -m forest_slam_tpu_torch.train``'s recipe at full
   width: stem 2, 9 layer pairs, 16 pairs of 120x160, 48 corners; the
   corridor pool cut to 128 pairs, the run to 300 steps): one step on the
   card against the CPU's on the same batch and parameters (loss terms and
   gradients within ``TRAIN_AGREEMENT``), then ``train`` from
   ``create_train_state``, whose loss must fall (the last tenth's mean below
   0.8x the first tenth's), with the attention kernel launched 18 times a
   step and no other kernel; steps/s printed with the card's name and power
   limit; the trained weights written by ``save_params`` and read back by
   ``load_learned_frontend`` unchanged;
14. multi-GPU, on one card through NCCL with a one-rank ``make_mesh(1)``:
   (a) ``make_sharded_train_step`` at the training phase's full width on a
   16-pair batch (a 16-pair corridor pool), held against the unsharded
   ``train_step`` on the same batch and parameters (loss terms and
   gradients within ``TRAIN_AGREEMENT``, the update's norm within 5%),
   the step launching ``attention`` 18 times and no other kernel; (b)
   ``run_batched_eval`` on 4 distinct 960x600 sequences of 16 frames
   (world seed s, speed 0.12 + 0.02 s), the learned flagship (K=1024,
   radius 12) and then the ORB path's configuration, each sequence's poses
   and ok flags equal bit for bit to ``run_stereo_vo_device`` on it alone
   with the generator seeded from (seed, s), each held to 90% tracked and
   ATE below 0.25 m, the learned run launching ``select``,
   ``sparse_cost``, ``gnn_layer``, ``sinkhorn_decode`` and
   ``refine_cost``, the ORB run ``detect`` and ``sparse_cost``; (c)
   ``python -m forest_slam_tpu_torch.parallel.dryrun 1`` in a process of its
   own, which must exit 0; seconds, sequences/s and steps/s printed with the
   card's name and power limit;
15. distillation (``python -m forest_slam_tpu_torch.train.distill``'s
   round-5 recipe at full width: teacher
   ``weights/learned_frontend_stem2_subpix_wide.msgpack``, a stem-4
   student, batch 8 of 240x320, lr 1e-3, w_scale 2, w_blur 0.7, w_subpix
   0.5; the pool cut to 64 frames of 600x960, the run to 300 steps): one
   step on the card against the CPU's on the same batch, teacher and
   student (``DISTILL_AGREEMENT``), then ``distill``, whose loss must fall
   by the training phase's rule with no kernel launched; steps/s printed;
   the checkpoint read back (the student equal, the teacher's SuperGlue
   subtree byte-equal, stem 4) and loaded by ``load_learned_frontend``;
   the distilled front end's tracking of the 31-pair clip printed, not held;
16. bag input (run after the back end): a BotanicGarden-shaped bag written
   under a temporary directory (removed at the end): bench.py's corridor
   world and 64 unique workload poses ping-ponged to 129 frames at 10 Hz,
   rendered at the BotanicGarden rig (left at K_left, right at K_right
   through T_left_right), each view distorted by its camera's k1, k2, as
   960x600 bgr8 stereo (446 MB, uncompressed) with /gt_poses (lidar poses
   whose T_RGB0_VLP16 @ pose are the camera poses) and /velodyne_points
   (3000 points a scan, 5% NaN), and a 16-frame copy in bz2 chunks of 512
   KiB; the native reader must read both (equal to the Python parser on
   the bz2 bag), the first 16 loaded frames must equal a float64 host
   undistort of the frames written, and the CLI runs in process: gt-traj
   (equal to the rendered poses), gt-map, ``stereo --bag`` (learned with
   the map and the viewer, ORB, learned with ``--rectify``) and ``slam
   --bag`` (learned, and learned with ``--rectify``), each in odometry
   mode, evaluated by ``eval`` against the bag's gt-traj and held to 90%
   tracked, the ``--rectify`` runs also to ATE below 0.25 m in Sim(3) and
   SE(3) (the unrectified runs keep the reference's double distortion
   correction in PnP and its unrectified stereo, so their ATE is printed);
   the learned path on the loaded frames with the rig's distortion zeroed,
   held to ATE below 0.25 m (Sim(3)); ``mono --bag`` (ORB, odometry, 32
   frames at stride 2) held to the mono rules; and ``view``; reader MB/s,
   ``preprocess_frames`` ms a frame, pairs/s and ATE printed;
17. last, the bench's device-time cross-check of both 962-pair workloads
   (``device_pairs_per_sec``, which must be set), printed beside the card's
   name and power limit: a ``torch.profiler`` window slows the host-bound
   runs that follow it in the same process.

The kernel checks also run the shapes the workload and the gates give the
kernels: the sparse cost at 32 frames of K=1024 and of 512, the GNN layer at
96 sequences, Sinkhorn at 48, 15 and 7 pairs, refine at 48 pairs and at
radius 24 with frame 0 upscaled by 1.0, 1.2, 1.44 and 1.7 against frame 1
at 960x600, select at 32 960x600 frames and at the wide-baseline octaves
(416x672 and 288x480) of 16 frames, detect over the levels of 32 frames, and
attention at the training step's (32, 4, 48, 64).

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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 and
# float64 CUDA-core and bf16 tensor-core operations/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
F64_OPS = 34e12
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
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

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
    ops, nbytes = kernel_costs("sparse_cost", B, H_, W_, K_, D, w)
    return err, err == 0.0, bound(nbytes, ops, F32_OPS), args


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
    """The layer's least time (roofline.gnn_layer_cost, the weights ``ws``)."""
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

    ops, nbytes = kernel_costs("gnn_layer", N, K_, S, D, sum(t.numel() * t.element_size() for t in ws))
    return bound(nbytes, ops, BF16_OPS)


# LightGlue (the sp_lightglue.seq962 cell): a pair chunk of 48 pairs of 2048
# keypoints, both sets of a pair in one fused-layer launch (96 sequences), 9
# layers of a self and a cross block; the gaps a block's kernel may have to
# its plain version, over the plain output's largest magnitude
# (test_torch_cuda.py::test_lightglue_layer_variants_kernel gives the reason)
LG_PAIRS, LG_K, LG_LAYERS = BENCH_PAIRS, 2048, 9
LG_LAYER_MAX, LG_LAYER_MEAN = 2 ** -5, 2 ** -10
LG_SEED = 2 ** 31 + 29


def lightglue_config(n_layers=LG_LAYERS, residual_scale=None) -> dict:
    """The sp_lightglue configuration (bench_port/configs/sp_lightglue.json)
    at ``n_layers``, and at ``residual_scale`` where given (1: every FFN at
    full strength; the configuration's own keeps the clip tracking)."""
    with open(os.path.join(ROOT, "bench_port", "configs", "sp_lightglue.json")) as f:
        cfg = json.load(f)
    assumed = cfg["assumed"] if residual_scale is None else dict(cfg["assumed"], residual_scale=residual_scale)
    return dict(cfg, lightglue_layers=n_layers, assumed=assumed)


def lightglue_weights(cfg: dict, dev, seed=LG_SEED) -> dict:
    """The benchmark's LightGlue weight draw (bench_port/frontends/
    superpoint_lightglue.py:weights) for ``cfg`` at ``seed``."""
    from bench_port import manifest

    return manifest.frontend("superpoint_lightglue").weights(cfg, ROOT, seed, dev)


def lightglue_inputs(dev, n_layers: int, residual_scale: float = 1.0, seed: int = LG_SEED):
    """(configuration, state dict, xy0, d0, v0, xy1, d1, v1): the cell's
    configuration at ``n_layers`` and ``residual_scale``, its weight draw,
    and 48 pairs of 2048 keypoints at 960x600 whose second set is the first
    permuted, moved and with noisy descriptors, 1700-2048 of them valid."""
    cfg = lightglue_config(n_layers, residual_scale)
    sd = lightglue_weights(cfg, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    P, K_, D = LG_PAIRS, LG_K, cfg["descriptor_dim"]
    xy0 = torch.rand((P, K_, 2), generator=g, device=dev) * torch.tensor([float(W), float(H)], device=dev)
    d0 = torch.nn.functional.normalize(torch.randn((P, K_, D), generator=g, device=dev), dim=-1)
    perm = torch.argsort(torch.rand((P, K_), generator=g, device=dev), dim=1)
    xy1 = xy0.gather(1, perm[..., None].expand(-1, -1, 2)) + 2.0
    d1 = torch.nn.functional.normalize(d0.gather(1, perm[..., None].expand(-1, -1, D))
                                       + 0.03 * torch.randn((P, K_, D), generator=g, device=dev), dim=-1)
    n = torch.randint(1700, K_ + 1, (2, P, 1), generator=g, device=dev)
    slots = torch.arange(K_, device=dev)
    return cfg, sd, xy0, d0, slots < n[0], xy1, d1, slots < n[1]


def fp8(t):
    """t rounded to float8 e4m3 with one scale a tensor, in t's dtype: the
    control one precision below bf16."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(), min=1e-30) / 448.0
    return ((tf / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def lightglue_layer_case(dev, kind: str) -> dict:
    """Layer 0's ``kind`` block of LightGlue ("self": rotary q/k, GELU;
    "cross": q and k both from ``to_qk``, GELU; LayerNorm eps 1e-5) on the
    cell's 96 sequences of 2048 tokens with full-strength weights: the
    kernel's and an fp8 control's (largest, mean) gap to the plain version
    over the largest magnitude of its output on valid tokens, whether the
    kernel's output is finite, and the kernel's and plain version's calls."""
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain
    from forest_slam_tpu_torch.frontend.lightglue import LN_EPS, LightGlue, LightGlueConfig

    cfg, sd, xy0, d0, v0, xy1, d1, v1 = lightglue_inputs(dev, 1)
    lg = LightGlue(LightGlueConfig(n_layers=1), sd, device=dev)
    x0, r0 = lg.encode(xy0, d0, (H, W))
    x1, r1 = lg.encode(xy1, d1, (H, W))
    x = torch.cat([x0, x1]).contiguous()
    valid = torch.cat([v0, v1])
    if kind == "self":
        args, ws = (x, x, valid), lg.self_w[0]
        kw = dict(rope=torch.cat([r0, r1]).contiguous(), ln_eps=LN_EPS, gelu=True)
    else:
        args, ws = (x, torch.cat([x1, x0]).contiguous(), torch.cat([v1, v0])), lg.cross_w[0]
        kw = dict(ln_eps=LN_EPS, gelu=True)
    heads = cfg["num_heads"]
    with torch.no_grad():
        got = gnn_layer(*args, ws, heads, **kw).float()
        ref = gnn_layer_plain(*args, ws, heads, **kw).float()
        control = gnn_layer_plain(fp8(args[0]), fp8(args[1]), args[2], tuple(
            fp8(w) if w.dtype == torch.bfloat16 else w for w in ws), heads, **kw).float()
    scale = float(ref[valid].abs().max())
    gaps = [((a - ref)[valid].abs().max().item() / scale, (a - ref)[valid].abs().mean().item() / scale)
            for a in (got, control)]
    finite = bool(torch.isfinite(got).all().item())
    del got, ref, control
    return dict(kernel=gaps[0], control=gaps[1], finite=finite,
                call=lambda: gnn_layer(*args, ws, heads, **kw), plain=lambda: gnn_layer_plain(*args, ws, heads, **kw))


def check_lightglue_layers(dev) -> list:
    """The fused layer's LightGlue blocks at the cell's shape, each held to
    LG_LAYER_MAX and LG_LAYER_MEAN while its fp8 control misses the mean;
    ms, plain ms and the bound of the front end's ``layer_cost`` (S once a
    cross block)."""
    from bench_port import manifest

    layer_cost = manifest.frontend("superpoint_lightglue").layer_cost
    D = 256
    out = []
    for kind in ("self", "cross"):
        c = lightglue_layer_case(dev, kind)
        (kmax, kmean), (cmax, cmean) = c["kernel"], c["control"]
        cost = layer_cost(kind, LG_PAIRS, LG_K, D, HEADS)
        b_ms, b_by = bound(cost.bytes, cost.flops, BF16_OPS)
        with torch.no_grad():
            ms, plain_ms = time_ms(c["call"]), time_ms(c["plain"], reps=2)
        out.append(dict(kind=kind, shape=[2 * LG_PAIRS, LG_K, LG_K, D], max_gap=kmax, mean_gap=kmean,
                        control_max_gap=cmax, control_mean_gap=cmean,
                        ok=c["finite"] and kmax <= LG_LAYER_MAX and kmean <= LG_LAYER_MEAN and cmean > LG_LAYER_MEAN,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        del c
        torch.cuda.empty_cache()
    return out


def lightglue_path(dev, wrappers, launches_by_path, report, run_with, n_pairs) -> list:
    """The clip through ``run_stereo_vo_device`` with SuperPoint (the
    flagship checkpoint at K=2048) + LightGlue (the configuration's weight
    draw, 9 layers): held to the learned path's tracking and ATE, ``select``,
    ``sparse_cost``, ``refine_cost`` and ``pnp_refine`` (once a pair chunk)
    launched, ``gnn_layer`` 2 x 9 times a pair chunk and ``sinkhorn_decode``
    never."""
    from forest_slam_tpu_torch.frontend.base import lightglue_frontend
    from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend

    cfg = lightglue_config()
    sp = load_learned_frontend(FLAGSHIP_PATH, (H, W), LG_K, device=dev)
    lg = LightGlue(LightGlueConfig(n_layers=LG_LAYERS), lightglue_weights(cfg, dev), device=dev)
    run = run_with(lightglue_frontend(sp, lg))
    _, _, t_cold = drive_path(wrappers, run)
    log(f"LightGlue path (K={LG_K}, {LG_LAYERS} layers, residual_scale {cfg['assumed']['residual_scale']}) warm-up "
        f"run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run)
    launches_by_path["lightglue"] = launches
    tracked, err = report("LightGlue", out, t_run, launches, shares=False)
    failures = path_failures("LightGlue", out, tracked, err, launches,
                             ("select", "sparse_cost", "gnn_layer", "refine_cost", "pnp_refine"), n_pairs=n_pairs,
                             idle_kernels=("sinkhorn_decode",))
    failures += pnp_launch_failures("LightGlue", launches, n_pairs)
    chunks = -(-n_pairs // PAIR_BATCH)
    if launches["gnn_layer"] != 2 * LG_LAYERS * chunks:
        failures.append(f"LightGlue: {launches['gnn_layer']} gnn_layer launches, not {2 * LG_LAYERS} a pair chunk "
                        f"({2 * LG_LAYERS * chunks})")
    return failures


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
    lightglue = check_lightglue_layers(dev)
    ok &= all(o["ok"] for o in lightglue)
    b_ms, b_by = gnn_bound(ws, N, K, K)
    return dict(
        name="gnn_layer", source="forest_slam_tpu_torch/csrc/gnn_layer.cu",
        replaces="forest_slam_tpu/frontend/pallas_gnn.py:214",
        tolerance="max <= 0.05 * max|ref|, mean <= 2e-3 * max|ref|; LightGlue's blocks max <= 2^-5, mean <= 2^-10 "
                  "of max|ref|, the fp8 control's mean above",
        max_abs_err=err, mean_abs_err=mean_err, ok=ok, other_shapes=extra, lightglue=lightglue,
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
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

    ops, nbytes = kernel_costs("sinkhorn_decode", B, K0, K1, iters)
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
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

    B, H0, W0, H1, W1, K_, R = shape
    t = REFINE_TEMPLATE
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
    ops, nbytes = kernel_costs("refine_cost", B, H0, W0, H1, W1, K_, R, t, nvalid.tolist())
    return err, err == 0.0, bound(nbytes, ops, F32_OPS), args


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
    from forest_slam_tpu_torch.frontend.detect_kernel import detect_pooled, detect_pooled_levels, detect_pooled_plain
    from forest_slam_tpu_torch.utils.roofline import detect_ops, kernel_costs

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
        ops, nbytes = kernel_costs("detect", [tuple(lv.shape) for lv in lvs],
                                   sum(detect_ops(lv, args[0], args[2]) for lv in lvs))
        return bound(nbytes, ops, F32_OPS)

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
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

    heat = peaky_heat(dev, gen, shape)
    v, i = nms_block_max(heat)
    rv, ri = nms_block_max_plain(heat)
    ops, nbytes = kernel_costs("select", *shape, 4)
    b = bound(nbytes, ops, F32_OPS)
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


# PnP-RANSAC's refine-and-select kernel (csrc/pnp_refine.cu) at the shapes the
# paths hand it: name -> (pairs, points, minimal solver, the identity start's
# anneal (0: none), hypotheses drawn, camera: "synthetic" (the clips' ideal
# rig) or "botanic" (BotanicGarden's left camera, k1 -0.060, k2 0.094, as the
# bag and the CLI run)); the three best hypotheses start 8 Gauss-Newton steps
PNP_STARTS, PNP_ITERS = 3, 8
PNP_SHAPES = {
    "learned chunk": (BENCH_PAIRS, K, "dlt6", 48.0, 1024, "synthetic"),
    "ORB cell chunk": (192, ORB_FEATURES, "dlt6", 48.0, 1024, "synthetic"),
    "ORB clip batch": (PAIR_BATCH, ORB_FEATURES, "dlt6", 48.0, 1024, "synthetic"),
    "wide-baseline gate, P3P": (GATE_PAIRS[0], K, "p3p", 48.0, 1024, "synthetic"),
    "loop verification": (16, K, "dlt6", 48.0, 512, "synthetic"),
    "streaming step": (1, ORB_FEATURES, "dlt6", 48.0, 512, "synthetic"),
    "bag batch": (PAIR_BATCH, K, "dlt6", 48.0, 1024, "botanic"),
    "256 hypotheses, bag camera": (BENCH_PAIRS, K, "dlt6", 48.0, 256, "botanic"),
}
PNP_LEARNED = "learned chunk"
# pnp_refine_agreement's limit on the pairs where the kernel and the plain
# version differ, each of which pnp_degenerate must mark: a share of a
# call's pairs
PNP_MAX_APART = 0.05


def pnp_stage_args(dev, P, N, minimal, identity, seed=0, n_hypotheses=1024, camera="synthetic"):
    """The arguments solve_pnp_ransac hands to pnp_kernel.refine_and_select
    on P pairs of N points (30% outliers, 5% invalid, 0.2 px noise, a pose a
    pair near tests/test_torch_pnp.py's) seen by ``camera`` (PNP_SHAPES),
    caught by a stand-in that runs nothing."""
    import numpy as np

    from forest_slam_tpu_torch.core.camera import PinholeCamera, project_points
    from forest_slam_tpu_torch.core.lie import se3_exp
    from forest_slam_tpu_torch.geometry import pnp, pnp_kernel
    from forest_slam_tpu_torch.io import calib

    rng = np.random.default_rng(seed)
    if camera == "botanic":
        Kmat, dist = calib.BOTANIC_K_LEFT.astype(np.float32), torch.as_tensor(calib.BOTANIC_DIST_LEFT)
    else:
        Kmat, dist = np.array([[643.2, 0, 479.5], [0, 643.2, 299.5], [0, 0, 1]], np.float32), torch.zeros(5)
    xi = torch.as_tensor([0.02, -0.01, 0.15, 0.01, -0.02, 0.005] + rng.normal(size=(P, 6)) * 0.01)
    T = se3_exp(xi).double()
    X = torch.as_tensor(np.stack([rng.uniform(-4, 4, (P, N)), rng.uniform(-1.5, 1.5, (P, N)),
                                  rng.uniform(3, 25, (P, N))], -1))
    pc = X @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]
    cam64 = PinholeCamera(K=torch.as_tensor(Kmat, dtype=torch.float64), dist=dist.double(), width=960, height=600)
    uv = project_points(pc, cam64).numpy() + rng.normal(size=(P, N, 2)) * 0.2
    bad = rng.random((P, N)) < 0.3
    uv[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    valid = torch.as_tensor(rng.random((P, N)) > 0.05, device=dev)
    cam = PinholeCamera(K=torch.as_tensor(Kmat, device=dev), dist=dist.float().to(dev), width=960, height=600)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seen = []
    real = pnp_kernel.refine_and_select
    pnp_kernel.refine_and_select = lambda *a: seen.append(a)
    try:
        pnp.solve_pnp_ransac(X.float().to(dev), torch.as_tensor(uv, dtype=torch.float32, device=dev), valid, cam,
                             generator=gen, n_hypotheses=n_hypotheses, identity_prior_anneal=identity,
                             minimal=minimal)
    finally:
        pnp_kernel.refine_and_select = real
    return seen[0]


def pnp_degenerate(gated, chosen, k):
    """Pairs (P,) whose candidate ``chosen`` (P,) was refined from a start
    whose plain refinement gated one or two points in some step (``gated``:
    candidates_plain's counts). J^T J has rank 4 or less there, the 1e-6
    damping is below float32's resolution of it, so the plain version's
    float32 step is rounding noise and the kernel's float64 step is not:
    the two refinements of that start part, and under distortion one may
    reach a NaN score, which wins. Candidate k, the unrefined start, never
    is; k + 1 is the identity start; -1 stands for any start."""
    if not gated:  # no refinement steps
        return torch.zeros_like(chosen, dtype=torch.bool)
    ill = torch.stack(gated, -1)
    ill = ((ill > 0) & (ill < 3)).any(-1)  # (P, starts)
    start = torch.where(chosen > k, chosen - 1, chosen).clamp(0, ill.shape[1] - 1)
    return torch.where(chosen < 0, ill.any(-1), ill.gather(1, start[:, None])[:, 0] & (chosen != k))


def pnp_refine_agreement(got, args, max_apart=PNP_MAX_APART) -> dict:
    """The refine-and-select kernel's result ``got`` against the plain
    version on the same arguments (and device), pair by pair: the candidate
    the kernel chose (the plain candidate nearest its pose) is the plain
    version's first maximum or scores within 1e-3 of it; R and t within
    1e-4 of that candidate's; NaN in both or in neither; inlier counts
    within 2, masks apart on at most 0.5% of the points. A pair that
    differs is left out only where pnp_degenerate marks the plain choice or
    the kernel's; where the kernel's pose is within 1e-4 of no plain
    candidate (NaN included), which start it chose cannot be told, and any
    start marks the pair. At most ``max_apart`` of the pairs may be left out.
    ok is n_inliers >= min_inliers everywhere. The counts (``degenerate``:
    pairs marked; ``apart``: pairs that differ), gaps and ``ok``."""
    from forest_slam_tpu_torch.core.lie import so3_orthonormalize
    from forest_slam_tpu_torch.geometry.pnp_kernel import candidates_plain

    gated = []
    P_c, inl_c, cnt_c, score = candidates_plain(*args[:-1], gated=gated)
    k = args[2].shape[1]
    R_c, t_c = so3_orthonormalize(P_c[..., :3]), P_c[..., 3]
    b = torch.argmax(score, dim=1)  # refine_and_select_plain's choice
    rows = torch.arange(len(b), device=b.device)
    gap = ((R_c - got.R[:, None]).abs().flatten(2).amax(-1) + (t_c - got.t[:, None]).abs().amax(-1))
    nan_got, nan_ref = torch.isnan(got.t).any(-1), torch.isnan(t_c[rows, b]).any(-1)
    kc = torch.nan_to_num(gap, nan=float("inf")).argmin(1)
    same_choice = (kc == b) | ((score[rows, kc] - score[rows, b]).abs() < 1e-3)
    R_err = (got.R - R_c[rows, kc]).abs().flatten(1).amax(-1)
    t_err = (got.t - t_c[rows, kc]).abs().amax(-1)
    n_diff = (got.n_inliers - cnt_c[rows, b]).abs()
    mask_frac = (got.inliers != inl_c[rows, kc]).float().mean(-1)
    both_nan = nan_got & nan_ref
    agree = both_nan | ((nan_got == nan_ref) & same_choice & (R_err <= 1e-4) & (t_err <= 1e-4) & (n_diff <= 2)
                        & (mask_frac <= 0.005))
    matched = (R_err <= 1e-4) & (t_err <= 1e-4)
    degenerate = pnp_degenerate(gated, b, k) | pnp_degenerate(gated, torch.where(matched, kc, -1), k)
    held = agree & ~both_nan
    out = dict(
        pairs=len(b), nan_pairs=int(both_nan.sum()), degenerate=int(degenerate.sum()),
        apart=int((~agree).sum()), apart_degenerate=int((~agree & degenerate).sum()),
        other_choice=int((kc != b)[held].sum()),
        max_R_err=float(R_err[held].max()) if held.any() else 0.0,
        max_t_err=float(t_err[held].max()) if held.any() else 0.0,
        max_n_diff=int(n_diff[held].max()) if held.any() else 0,
        max_mask_frac=float(mask_frac[held].max()) if held.any() else 0.0,
        ok_flag=bool(torch.equal(got.ok, got.n_inliers >= args[-1])),
        tracked=float(got.ok.float().mean()))
    out["ok"] = bool((agree | degenerate).all()) and out["apart"] <= max_apart * len(b) and out["ok_flag"]
    return out


def check_pnp_refine(dev, gen):
    """The refine-and-select kernel against its plain version at each of
    PNP_SHAPES (pnp_refine_agreement's tolerances, one launch a call), with
    each shape's ms (one launch, host enqueue in it) and 20 launches back
    to back a launch; the bound at the learned chunk's shape."""
    from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select, refine_and_select_plain
    from forest_slam_tpu_torch.utils.roofline import kernel_costs, pnp_refine_f64_flops

    shapes = {}
    for name, (P, N, minimal, identity, hyps, camera) in PNP_SHAPES.items():
        args = pnp_stage_args(dev, P, N, minimal, identity, n_hypotheses=hyps, camera=camera)
        n = refine_and_select.launches
        agree = pnp_refine_agreement(refine_and_select(*args), args)
        agree["ok"] &= refine_and_select.launches == n + 1
        shapes[name] = dict(shape=(P, N, minimal, identity, hyps, camera), agreement=agree,
                            ms=time_ms(lambda: refine_and_select(*args)),
                            back_to_back_ms=time_ms(lambda: refine_and_select(*args), launches=20))
        if name == PNP_LEARNED:
            plain_ms = time_ms(lambda: refine_and_select_plain(*args))
    P, N, _, identity, _, _ = PNP_SHAPES[PNP_LEARNED]
    shape = (P, N, PNP_STARTS, identity > 0, PNP_ITERS)
    ops, nbytes = kernel_costs("pnp_refine", *shape)
    f64 = pnp_refine_f64_flops(*shape)
    # the float32 and the float64 operations each at their own peak
    b_ms, b_by = bound(nbytes, (ops - f64) + f64 * F32_OPS / F64_OPS, F32_OPS)
    learned = shapes[PNP_LEARNED]
    return dict(
        name="pnp_refine", source="forest_slam_tpu_torch/csrc/pnp_refine.cu", replaces=None,
        tolerance="R, t 1e-4; inliers 2; masks 0.5%; the choice or a score within 1e-3; "
                  f"pairs apart only where degenerate, at most {PNP_MAX_APART:.0%}",
        max_abs_err=max(max(s["agreement"]["max_R_err"], s["agreement"]["max_t_err"]) for s in shapes.values()),
        ok=all(s["agreement"]["ok"] for s in shapes.values()), shapes=shapes,
        ms=learned["ms"], back_to_back_ms=learned["back_to_back_ms"], plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def check_attention(dev, gen):
    import torch.nn.functional as F

    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward, masked_attention_plain
    from forest_slam_tpu_torch.utils.roofline import kernel_costs

    B = 2 * PAIR_BATCH  # both images of a pair batch in one launch
    err, mean_err, _, ok, masked_row_err, (q, k, v, mask, scale) = attention_case(dev, gen, (B, HEADS, K, K))
    r_err, r_mean, r_top, r_ok, r_masked, _ = attention_case(dev, gen, ATTENTION_RAGGED)
    # the training step's shape: both images of 16 pairs, 48 corners
    t_err, t_mean, t_top, t_ok, t_masked, (tq, tk, tv, tmask, _) = attention_case(dev, gen, ATTENTION_TRAIN)
    t_ops, t_bytes = kernel_costs("attention", *ATTENTION_TRAIN, HEAD_DIM)
    t_bound = bound(t_bytes, t_ops, BF16_OPS)
    t_amask = tmask[:, None, None, :]
    amask = mask[:, None, None, :]
    sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale)
    ops, nbytes = kernel_costs("attention", B, HEADS, K, K, HEAD_DIM)
    b_ms, b_by = bound(nbytes, ops, BF16_OPS)
    return dict(
        name="attention", source="forest_slam_tpu_torch/csrc/attention.cu",
        replaces="forest_slam_tpu/frontend/pallas_attention.py:149",
        tolerance="max <= 2^-7 * max|ref|, mean <= 1e-3 * max|ref|",
        max_abs_err=err, mean_abs_err=mean_err, masked_row_err=masked_row_err, ok=ok and r_ok and t_ok,
        ragged=dict(shape=list(ATTENTION_RAGGED), max_abs_err=r_err, mean_abs_err=r_mean, max_abs_ref=r_top,
                    masked_row_err=r_masked, ok=r_ok),
        train_shape=dict(shape=list(ATTENTION_TRAIN), max_abs_err=t_err, mean_abs_err=t_mean, max_abs_ref=t_top,
                         masked_row_err=t_masked, ok=t_ok, ms=time_ms(lambda: attention_forward(tq, tk, tv, tmask, scale)),
                         plain_ms=time_ms(lambda: masked_attention_plain(tq, tk, tv, tmask, scale)),
                         bound_ms=t_bound[0], bound_by=t_bound[1],
                         library_ms=time_ms(lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=t_amask,
                                                                                   scale=scale))),
        sdpa_nan_rows=bool(torch.isnan(sdpa[-1]).any().item()),
        ms=time_ms(lambda: attention_forward(q, k, v, mask, scale)),
        plain_ms=time_ms(lambda: masked_attention_plain(q, k, v, mask, scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale)),
    )


# the training phase: python -m forest_slam_tpu_torch.train's recipe (the
# JAX package's train-frontend, cli.py:723-772) at full width: SuperPoint
# stem 2, channels (64, 64, 128, 128), D=256; SuperGlue 9 layer pairs, 4
# heads, 20 Sinkhorn iterations; 16 pairs of 120x160 a batch, 48 corners,
# lr 1e-3, texture 0.4, corridor 0.3. Cut: the corridor pool, 128 pairs in
# place of 4096, and the run, 300 steps in place of 2000.
TRAIN_STEPS = 300
TRAIN_BATCH, TRAIN_H, TRAIN_W, TRAIN_M = 16, 120, 160, 48
TRAIN_POOL = 128
TRAIN_LOSS_RATIO = 0.8  # tests/test_training.py's rule, over tenths of the run
ATTENTION_TRAIN = (2 * TRAIN_BATCH, HEADS, TRAIN_M, TRAIN_M)  # both images of a batch, one launch
# One step on the card against the CPU, same batch and parameters. The bf16
# model's gradient through SuperGlue's Sinkhorn NLL is sensitive: on the
# CPU a 1e-6 relative perturbation of every parameter moves the matching
# loss by 1.4e-3 and leaves the gradient at cosine 0.9978 (rel-L2 0.067, the
# worst leaf 0.994; scripts/train_grad_envelope.py --side port); the card
# sums its convolutions and attention in
# another order. The bounds leave about five times that room; the
# detector and descriptor terms, which skip SuperGlue, are held tighter.
TRAIN_AGREEMENT = dict(detector=1e-3, descriptor=5e-3, matching=3e-2, loss=3e-2, sp_min_cos=0.98,
                       global_cos=0.95, global_rel=0.35, leaf_min_cos=0.85)


def train_config():
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
    from forest_slam_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(superpoint=SuperPointConfig(stem_stride=2), height=TRAIN_H, width=TRAIN_W,
                       batch_size=TRAIN_BATCH, max_corners=TRAIN_M, learning_rate=1e-3, texture_fraction=0.4,
                       corridor_fraction=0.3, corridor_pool_size=TRAIN_POOL)


def step_gradients(fe, batch, cfg):
    """One training step's metrics and gradients, of the total and of the
    detector + descriptor terms, as float64 numpy by parameter name."""
    from forest_slam_tpu_torch.train.trainer import loss_fn

    names, params = zip(*fe.named_parameters())
    total, m = loss_fn(fe, batch, cfg)
    g_all = torch.autograd.grad(total, params, retain_graph=True)
    g_sp = torch.autograd.grad(m["detector"] + m["descriptor"], params, allow_unused=True)

    def host(grads):
        return {n: np.zeros(p.numel()) if g is None else g.detach().double().cpu().numpy().ravel()
                for n, p, g in zip(names, params, grads)}

    return {k: float(v.detach()) for k, v in m.items()}, host(g_all), host(g_sp)


def step_agreement(ref, got):
    """How far one step's (metrics, gradients) are from another's: each
    loss term's relative difference, the least cosine of a SuperPoint leaf's
    detector + descriptor gradient, the whole gradient's cosine and relative
    L2, the least cosine of a leaf that carries signal (norm above 1e-3 of
    the whole), and whether all are within TRAIN_AGREEMENT."""
    (rm, ra, rs), (gm, ga, gs) = ref, got
    cos = lambda a, b: float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    rel = {k: abs(gm[k] - rm[k]) / max(abs(rm[k]), 1e-12) for k in rm}
    sp_min_cos = min(cos(rs[n], gs[n]) for n in rs if n.startswith("superpoint."))
    a = np.concatenate(list(ra.values()))
    g = np.concatenate([ga[n] for n in ra])
    total = np.linalg.norm(a)
    leaf_cos = {n: cos(ra[n], ga[n]) for n in ra if np.linalg.norm(ra[n]) >= 1e-3 * total}
    worst = min(leaf_cos, key=leaf_cos.get)
    out = dict(rel=rel, sp_min_cos=sp_min_cos, global_cos=cos(a, g), global_rel=float(np.linalg.norm(a - g) / total),
               leaf_min_cos=leaf_cos[worst], leaf_worst=worst, leaves_checked=len(leaf_cos))
    tol = TRAIN_AGREEMENT
    out["ok"] = (all(rel[k] <= tol[k] for k in ("detector", "descriptor", "matching", "loss"))
                 and sp_min_cos >= tol["sp_min_cos"] and out["global_cos"] >= tol["global_cos"]
                 and out["global_rel"] <= tol["global_rel"] and out["leaf_min_cos"] >= tol["leaf_min_cos"])
    return out


# the distillation phase: python -m forest_slam_tpu_torch.train.distill's
# round-5 recipe (BASELINE.md:543-546) at full width: the stem-2 wide-gap
# subpix teacher into a stem-4 student, channels (64, 64, 128, 128), D=256,
# batch 8 of 240x320, lr 1e-3, w_scale 2, w_blur 0.7, w_subpix 0.5, so every
# term runs. Cut: the pool to 64 frames of 600x960 (of 256), the run to 300
# steps (of 24,000). The history holds every tenth step (log_every 10, as
# the reference's scan returns a chunk's last), and the loss rule reads it.
DISTILL_STEPS = 300
DISTILL_POOL = 64
DISTILL_LOG_EVERY = 10
# One step on the card against the CPU, same batch, teacher and student
# (distill_setup's). Each bound is five times the larger of two readings on
# that batch, rounded up to 1, 2 or 5 of its decade: the CPU's envelope, how
# far the CPU's step moves when every student parameter moves by a relative
# 1e-6 (det 1.1e-7, desc 2.0e-6, cos_kp 5.5e-5, subpix 2.7e-7, scale 1.2e-7,
# blur 4.1e-6, loss 1.7e-6; gradient cosine 1 - 6.0e-6, rel-L2 0.0035, the
# worst leaf 1 - 1.9e-5), and the card's own distance (det 1.1e-7, desc
# 3.0e-6, cos_kp 1.7e-4, subpix 9.2e-5, scale 1.5e-6, blur 1.2e-6, loss
# 1.1e-5; 1 - 2.3e-6, 0.0022, 1 - 4.8e-6); both from
# scripts/train_grad_envelope.py --side distill on the H100's machine. The
# card's subpix gap comes from the teacher's forward, which the envelope
# never moves: the card's bf16 convolutions round 10% of the teacher's
# logits the other way (by up to 4.0), which moves its in-cell centre of
# mass by up to 0.13 px; the CPU student on the card teacher's outputs
# carries 9.22e-5 of subpix's 9.25e-5, the student's own arithmetic 3.3e-7.
# The cross-entropy terms hardly see it: a fresh student's cell
# distribution is near uniform. No Sinkhorn runs here, so the step is far
# less chaotic than training's.
DISTILL_AGREEMENT = dict(det=1e-6, desc=2e-5, cos_kp=1e-3, subpix=5e-4, scale=1e-5, blur=5e-5, loss=1e-4,
                         global_cos=0.99995, global_rel=0.02, leaf_min_cos=0.9999)


def distill_config():
    from forest_slam_tpu_torch.frontend.weights import PLAIN_WB_PATH
    from forest_slam_tpu_torch.train.distill import DistillConfig

    return DistillConfig(teacher_path=PLAIN_WB_PATH, stem_stride=4, height=240, width=320, batch_size=8,
                         learning_rate=1e-3, pool_frames=DISTILL_POOL, w_scale=2.0, w_blur=0.7, w_subpix=0.5)


def distill_setup(dev, cfg=None):
    """The distillation phase's start: (cfg, load_teacher's (teacher, tree,
    meta), a student from seed 0, the generator on ``dev`` and the host one,
    both seeded 1, and the scene pool rendered from the first)."""
    from forest_slam_tpu_torch.train.distill import create_student_state, load_teacher, make_scene_pool

    cfg = cfg or distill_config()
    teacher = load_teacher(cfg, dev)
    state = create_student_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    host_gen = torch.Generator()
    host_gen.manual_seed(1)
    return cfg, teacher, state, gen, host_gen, make_scene_pool(gen, cfg, dev)


def distill_gradients(student, teacher_out, inputs, cfg):
    """One distillation step's metrics and the student's gradient, as
    float64 numpy by parameter name, from the teacher's outputs
    (``teacher_outputs``) and ``step_inputs``' (images, zoom, blurred)."""
    from forest_slam_tpu_torch.train.distill import distill_loss

    images, zoom, blurred = inputs
    names, params = zip(*student.named_parameters())
    total, m = distill_loss(student, teacher_out, images, cfg, zoom, blurred)
    grads = torch.autograd.grad(total, params)
    return ({k: float(v.detach()) for k, v in m.items()},
            {n: g.detach().double().cpu().numpy().ravel() for n, g in zip(names, grads)})


def distill_agreement(ref, got):
    """Each metric's relative difference, the gradient's cosine and relative
    L2, the least cosine of a leaf carrying more than 1e-3 of the gradient's
    norm, and whether all are within DISTILL_AGREEMENT."""
    (rm, rg), (gm, gg) = ref, got
    cos = lambda a, b: float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    rel = {k: abs(gm[k] - rm[k]) / max(abs(rm[k]), 1e-12) for k in rm}
    a = np.concatenate(list(rg.values()))
    g = np.concatenate([gg[n] for n in rg])
    total = np.linalg.norm(a)
    leaf_cos = {n: cos(rg[n], gg[n]) for n in rg if np.linalg.norm(rg[n]) >= 1e-3 * total}
    worst = min(leaf_cos, key=leaf_cos.get)
    out = dict(rel=rel, global_cos=cos(a, g), global_rel=float(np.linalg.norm(a - g) / total),
               leaf_min_cos=leaf_cos[worst], leaf_worst=worst, leaves_checked=len(leaf_cos))
    tol = DISTILL_AGREEMENT
    out["ok"] = (all(rel[k] <= tol[k] for k in rel) and out["global_cos"] >= tol["global_cos"]
                 and out["global_rel"] <= tol["global_rel"] and out["leaf_min_cos"] >= tol["leaf_min_cos"])
    return out


def same_tree(a, b) -> bool:
    """Two parameter trees hold the same keys, dtypes, shapes and bytes."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def distill_phase(dev, wrappers, launches_by_path, smi, track_clip):
    """The round-5 distillation recipe through ``distill``: one step agrees
    with the CPU's, the loss falls with no kernel launched, and the
    checkpoint reads back whole; ``track_clip(frontend)`` gives the
    distilled front end's (tracked, pairs, ATE) on the 31-pair clip,
    printed only."""
    import copy
    import tempfile

    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend, read_checkpoint, superpoint_to_jax
    from forest_slam_tpu_torch.train.distill import distill, save_distilled, step_inputs, teacher_outputs

    failures = []
    t0 = time.time()
    cfg, (teacher, tree, meta), state, gen, host_gen, pool = distill_setup(dev)
    torch.cuda.synchronize()
    log(f"distill: teacher {os.path.basename(cfg.teacher_path)} (stem {teacher.cfg.stem_stride}) loaded and a "
        f"{pool.shape[0]}-frame pool at {pool.shape[2]}x{pool.shape[1]} rendered on the card in {time.time() - t0:.2f} s")

    # one step on the card against the CPU: same batch, teacher and student
    inputs = step_inputs(gen, host_gen, cfg, pool)
    t0 = time.time()
    card = distill_gradients(state.student, teacher_outputs(teacher, inputs[0]), inputs, cfg)
    t_card = time.time() - t0
    cpu_inputs = (inputs[0].cpu(), tuple(t.cpu() for t in inputs[1]), inputs[2].cpu())
    t0 = time.time()
    cpu = distill_gradients(copy.deepcopy(state.student).cpu(),
                            teacher_outputs(copy.deepcopy(teacher).cpu(), cpu_inputs[0]), cpu_inputs, cfg)
    t_cpu = time.time() - t0
    agree = distill_agreement(cpu, card)
    log(f"distill: one step, card against CPU ({t_card:.2f} s vs {t_cpu:.2f} s, first calls): metrics card "
        + ", ".join(f"{k} {card[0][k]:.6g}" for k in card[0]) + "; relative differences "
        + ", ".join(f"{k} {v:.3g}" for k, v in agree["rel"].items())
        + f"; gradient cosine {agree['global_cos']:.7f}, rel-L2 {agree['global_rel']:.5f}, least leaf cosine "
        f"{agree['leaf_min_cos']:.6f} ({agree['leaf_worst']}, {agree['leaves_checked']} leaves) (tolerance "
        f"{DISTILL_AGREEMENT}): {'PASS' if agree['ok'] else 'FAIL'}")
    if not agree["ok"]:
        failures.append("distill: the card's step disagrees with the CPU's")
    del card, cpu, cpu_inputs

    (state, history, payload), launches, t_run = drive_path(
        wrappers, lambda: distill(cfg, DISTILL_STEPS, seed=0, log_every=DISTILL_LOG_EVERY, state=state, pool=pool,
                                  teacher=(teacher, tree, meta), device=dev))
    launches_by_path["distill"] = launches
    steps = np.array([s for s, _ in history])
    losses = np.array([m["loss"] for _, m in history])
    tenth = DISTILL_STEPS // 10
    first, last = float(losses[steps < tenth].mean()), float(losses[steps >= DISTILL_STEPS - tenth].mean())
    log(f"distill: {DISTILL_STEPS} steps of {cfg.batch_size} crops at {cfg.width}x{cfg.height} (stem "
        f"{teacher.cfg.stem_stride} -> {cfg.stem_stride}) in {t_run:.2f} s: {DISTILL_STEPS / t_run:.2f} steps/s on "
        f"{torch.cuda.get_device_name(0)} ({smi}); mean logged loss first tenth {first:.4f}, last tenth {last:.4f} "
        f"(ratio {last / first:.4f}, rule < {TRAIN_LOSS_RATIO}); last step "
        + " ".join(f"{k}={v:.4f}" for k, v in history[-1][1].items()) + f"; launches {launches}")
    if len(history) != DISTILL_STEPS // DISTILL_LOG_EVERY or not np.isfinite(losses).all():
        failures.append("distill: a loss is not finite (or logged steps are missing)")
    if not last < TRAIN_LOSS_RATIO * first:
        failures.append(f"distill: the loss did not fall ({first:.4f} -> {last:.4f})")
    busy = [k for k, n in launches.items() if n]
    if busy:
        failures.append(f"distill: kernels launched that distillation must not run: {busy}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "distilled.msgpack")
        save_distilled(payload, cfg, path, meta)
        back_meta, back = read_checkpoint(path)
        ok_student = same_tree(back["superpoint"]["params"], superpoint_to_jax(state.student))
        ok_sg = same_tree(back["superglue"], tree["superglue"])
        fe_d = load_learned_frontend(path, (H, W), K, device=dev)
        ok = ok_student and ok_sg and back_meta["stem_stride"] == 4 and fe_d.cfg.superpoint.stem_stride == 4
        log(f"distill: checkpoint of {os.path.getsize(path)} bytes (meta {back_meta}) read back: student "
            f"{'equal' if ok_student else 'DIFFERENT'}, SuperGlue subtree {'byte-equal to the teacher' if ok_sg else 'DIFFERENT'}; "
            f"loaded by load_learned_frontend at stem {fe_d.cfg.superpoint.stem_stride}")
    if not ok:
        failures.append("distill: the checkpoint read back differs (student, SuperGlue subtree or meta)")
    tracked, pairs, err = track_clip(learned_frontend(fe_d))
    log(f"distill: the {DISTILL_STEPS}-step student on the {pairs}-pair clip (printed, not held): {tracked}/{pairs} "
        f"tracked, ATE {err:.4f} m")
    print(json.dumps({"distill": {"steps": DISTILL_STEPS, "steps_per_s": DISTILL_STEPS / t_run, "seconds": t_run,
                                  "loss_first_tenth": first, "loss_last_tenth": last,
                                  "loss_logged": [round(float(x), 4) for x in losses],
                                  "agreement": {k: agree[k] for k in ("rel", "global_cos", "global_rel",
                                                                       "leaf_min_cos")},
                                  "launches": launches, "clip_tracked": tracked, "clip_ate_m": err}}), flush=True)
    return failures


# monocular VO (forest-slam mono) on the clip's left frames: tracked shares
# by compose mode (tests/test_pipeline_mono.py's rules) and the Sim(3) ATE
# bound, 5% of the path (31 pairs x 0.15 m)
MONO_MIN_TRACKED = {"parity": 0.8, "odometry": 0.9}
MONO_MAX_ATE_M = 0.05 * (N_FRAMES - 1) * 0.15
MONO_HYPOTHESES = 1024
MONO_SCAN_POSE_TOL = 1e-4  # m and rotation entries: the scan runner against the batched one


def mono_inputs(frontend, il, cam, n_pairs=PAIR_BATCH):
    """One pair batch of the mono path: the matched normalised points of
    frames 0..n_pairs and their mask, by the path's own ``matched_points``."""
    from forest_slam_tpu_torch.pipelines.mono import matched_points

    feats = frontend.extract(il[:n_pairs + 1])
    prev = type(feats)(*(a[:-1] for a in feats))
    cur = type(feats)(*(a[1:] for a in feats))
    return matched_points(prev, cur, cam, frontend, tuple(il.shape[1:]))


def five_point_timing(frontend, il, cam):
    """ms of one 5-point ``estimate_relative_pose`` of a pair batch at the
    path's shapes (CUDA events), and the peak memory it adds."""
    from forest_slam_tpu_torch.geometry.epipolar import estimate_relative_pose
    from forest_slam_tpu_torch.geometry.ransac import gumbel_per_item

    x0, x1, mask = mono_inputs(frontend, il, cam)
    g = torch.Generator(device=il.device)
    g.manual_seed(0)
    gumbel = gumbel_per_item(x0.shape[0], (MONO_HYPOTHESES, x0.shape[1]), g, il.device)
    run = lambda: estimate_relative_pose(x0, x1, mask, 1.0 / cam.fx, gumbel, minimal="5pt")  # noqa: E731
    ms = time_ms(run, reps=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**20, tuple(x0.shape)


def mono_phase(wrappers, launches_by_path, smi, il, gt, rig, fe):
    """``forest-slam mono`` on the clip's left frames through run_mono_vo,
    1024 hypotheses: ORB and the learned flagship, each in parity (5-point)
    and odometry (8-point) mode, held to their tracked shares, odometry also
    to the Sim(3) ATE bound; ORB launches detect and nothing else, the
    learned path select, gnn_layer and sinkhorn_decode and not refine_cost
    or sparse_cost; ORB parity through the plain versions tracks the same
    pairs; the scan runner gives ORB odometry's poses."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.mono import MonoConfig, run_mono_vo

    ts = np.arange(N_FRAMES) * 0.1
    cam = rig.left
    n_pairs = N_FRAMES - 1
    failures, records = [], {}
    launches_by_path["mono"] = {k: 0 for k in wrappers}
    orb, learned = orb_frontend(MonoConfig().orb, MonoConfig().max_match_distance), learned_frontend(fe)
    idle = {"orb": [k for k in wrappers if k != "detect"],
            "learned": ["refine_cost", "sparse_cost", "detect", "attention", "pnp_refine"]}
    path_kernels = {"orb": ["detect"], "learned": ["select", "gnn_layer", "sinkhorn_decode"]}
    for name, frontend, mode in (("orb_parity", orb, "parity"), ("orb_odometry", orb, "odometry"),
                                 ("learned_parity", learned, "parity"), ("learned_odometry", learned, "odometry")):
        kind = name.split("_")[0]
        cfg = MonoConfig(compose_mode=mode, n_hypotheses=MONO_HYPOTHESES)
        def run(c=cfg, f=frontend, m="batched"):
            return run_mono_vo(il, ts, cam, c, seed=0, frontend=f, mode=m)[1]

        drive_path(wrappers, run)  # warm-up
        out, launches, t_run = drive_path(wrappers, run)
        for k, n in launches.items():
            launches_by_path["mono"][k] += n
        tracked = int(out.ok.sum().item())
        err = ate(out.pose, gt, with_scale=True)
        rec = dict(tracked=tracked, pairs=n_pairs, ate_sim3_m=err, pairs_per_s=n_pairs / t_run, seconds=t_run,
                   launches=launches)
        if not (bool(torch.isfinite(out.pose).all().item()) and tuple(out.pose.shape) == (n_pairs, 4, 4)):
            failures.append(f"mono {name}: poses not finite or of the wrong shape")
        if tracked < MONO_MIN_TRACKED[mode] * n_pairs:
            failures.append(f"mono {name}: only {tracked}/{n_pairs} pairs tracked")
        if mode == "odometry" and not err < MONO_MAX_ATE_M:
            failures.append(f"mono {name}: Sim(3) ATE {err} m >= {MONO_MAX_ATE_M} m")
        zero = [k for k in path_kernels[kind] if launches[k] == 0]
        busy = [k for k in idle[kind] if launches[k] != 0]
        if zero or busy:
            failures.append(f"mono {name}: kernels never launched {zero}, launched and must not be {busy}")
        bound = (f"bound {MONO_MAX_ATE_M:.4f} m" if mode == "odometry"
                 else "printed, not held: parity composes point transforms")
        notes = [f"{tracked}/{n_pairs} tracked (rule >= {MONO_MIN_TRACKED[mode]:.0%}), Sim(3) ATE {err:.4f} m ({bound}), "
                 f"{n_pairs / t_run:.2f} pairs/s ({t_run:.3f} s) on {torch.cuda.get_device_name(0)} ({smi})",
                 f"launches {launches}"]
        if mode == "parity":
            ms, peak_mib, shape = five_point_timing(frontend, il, cam)
            rec.update(five_point_ms=ms, five_point_peak_mib=peak_mib, five_point_batch=list(shape))
            notes.append(f"one 5-point estimate_relative_pose of a pair batch {list(shape)}: {ms:.3f} ms, peak memory "
                         f"+{peak_mib:.1f} MiB")
        if name == "orb_parity":
            plain_cfg = cfg._replace(orb=OrbConfig(detect_path="plain"))
            plain, _, _ = drive_path(wrappers, lambda: run_mono_vo(il, ts, cam, plain_cfg, seed=0)[1])
            rec["plain_ok_agreement"] = (plain.ok == out.ok).float().mean().item()
            notes.append(f"plain versions track the same pairs: {rec['plain_ok_agreement']:.3f}")
            if rec["plain_ok_agreement"] < 1.0:
                failures.append("mono orb_parity: the kernel and the plain version track different pairs")
        if name == "orb_odometry":
            scan, _, t_scan = drive_path(wrappers, lambda: run(m="scan"))
            diff = (scan.pose - out.pose).abs().max().item()
            rec.update(scan_seconds=t_scan, scan_max_pose_diff=diff, scan_bit_equal=torch.equal(scan.pose, out.pose))
            notes.append(f"scan runner {t_scan:.3f} s, largest pose difference {diff:.3g}, bit-equal "
                         f"{rec['scan_bit_equal']}")
            if not (torch.equal(scan.ok, out.ok) and diff <= MONO_SCAN_POSE_TOL):
                failures.append(f"mono orb_odometry: the scan runner differs from the batched one ({diff})")
        records[name] = rec
        log(f"mono {name}: " + "; ".join(notes))
        torch.cuda.empty_cache()
    print(json.dumps({"mono": records}), flush=True)
    return failures


# the slam phase: tests/test_slam.py's loop, tests/test_relocalize.py's repair,
# bench.py's 962-pair workload through the back end, and the sequential runners
SLAM_LOOP = dict(max_candidates=16, min_separation=6, min_similarity=0.5, min_inliers=25)
SLAM_LOOP_KF_STRIDE = 4
SLAM_LOOP_MAX_END_M = 0.15  # tests/test_slam.py: the endpoint after SLAM below this and below VO's
SLAM_HYPOTHESES = 512  # tests/test_slam.py's and tests/test_relocalize.py's StereoConfig
# the loop's in-place turn (10 degrees a frame, 110 px at 960x600): with tests/test_slam.py's DLT-6 neither
# front end tracks it (ROADMAP Queue C item 8); the held runs take P3P, and the DLT-6 runs are printed
SLAM_LOOP_MINIMAL = "p3p"
SLAM_LOOP_RULES = ("tracked > 90%", "a loop accepted", "loops >= 6 keyframes apart", "end error below VO's",
                   f"end error < {SLAM_LOOP_MAX_END_M} m")
SLAM_TEST_ORB = dict(n_features=384, n_levels=4)  # tests/test_slam.py's own ORB, held to all of its rules
# with 512 features and 8 levels ORB's signatures rank the true revisit far below the 16 candidates at
# 960x600, so it accepts no loop and misses the test's loop rules (Queue C item 8). That run is held to what
# such a run can show: tracking, the end error, candidates that are the 16 best separated pairs of its
# keyframes' signatures ranked again on the host, and a pose graph that leaves the VO's poses as they were
# while no loop is accepted (a loop, if one is, to the test's rules on it)
SLAM_ORB_LOOP_HELD = ("tracked > 90%", f"end error < {SLAM_LOOP_MAX_END_M} m", "candidates = host top 16",
                      "no loop: SLAM = VO", "each loop >= 6 keyframes apart, end error below VO's")
SLAM_NO_LOOP_TOL = 1e-4  # largest pose-matrix entry change with odometry edges alone (CPU reading 4.5e-6 at 224x160)
# a true revisit: keyframes this close, as in scripts/jax_loop_reference.py (only (0, 17): 1 m apart, one heading)
SLAM_REVISIT_M, SLAM_REVISIT_DEG = 1.25, 20.0
RELOC_FRAMES, RELOC_NOISE_FRAME, RELOC_SPEED = 24, 12, 0.25
RELOC_MAX_END_M = 0.1  # tests/test_relocalize.py
BA_MAX_ATE_RATIO = 1.05  # tests/test_window_ba.py:58
STREAM_CHUNK = 8
STREAM_POSE_TOL = 1e-4  # m: streaming against the scan (tests/test_streaming.py)
SLAM_KF_STRIDE = 5  # the 963-frame run: 193 keyframes


def slam_loop_scene(dev):
    """tests/test_slam.py's out-and-back corridor (n_forward=12, n_turn=18,
    speed 0.25, n_rejoin=6: 72 frames with a true revisit) in its own world,
    the corridor of PRNGKey(3), at 960x600."""
    from forest_slam_tpu_torch.io.synthetic import (corridor_textures, default_rig, make_corridor_world,
                                                    out_and_back_trajectory, render_stereo)

    world = make_corridor_world(textures=corridor_textures(3, draws="jax"), device=dev)
    rig = default_rig(H, W, device=dev)
    Ts = out_and_back_trajectory(n_forward=12, n_turn=18, speed=0.25, n_rejoin=6, device=dev)
    il, ir, _ = render_stereo(world, Ts, rig, H, W)
    return il.contiguous(), ir.contiguous(), Ts, rig


def slam_reloc_scene(dev):
    """tests/test_relocalize.py's scene at 960x600: 24 corridor frames of the
    PRNGKey(3) world at 0.25 m, frame 12 replaced by uniform noise in both
    views; the truth relative to frame 0."""
    from forest_slam_tpu_torch.io.synthetic import (corridor_textures, corridor_trajectory, default_rig,
                                                    make_corridor_world, render_stereo)

    world = make_corridor_world(textures=corridor_textures(3, draws="jax"), device=dev)
    rig = default_rig(H, W, device=dev)
    Ts = corridor_trajectory(RELOC_FRAMES, speed=RELOC_SPEED, device=dev)
    il, ir, _ = render_stereo(world, Ts, rig, H, W)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    noise = torch.rand((H, W), generator=g, device=dev) * 255.0
    il[RELOC_NOISE_FRAME] = noise
    ir[RELOC_NOISE_FRAME] = noise
    return il, ir, torch.linalg.inv(Ts[0]) @ Ts, rig


def slam_revisits(Ts, min_sep):
    """Keyframe pairs at least ``min_sep`` apart whose true poses lie within
    SLAM_REVISIT_M and SLAM_REVISIT_DEG of each other."""
    kf = Ts[::SLAM_LOOP_KF_STRIDE].double().cpu().numpy()
    out = []
    for i in range(len(kf)):
        for j in range(i + min_sep, len(kf)):
            c = np.clip((np.trace(kf[i, :3, :3].T @ kf[j, :3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            close = np.linalg.norm(kf[i, :3, 3] - kf[j, :3, 3]) < SLAM_REVISIT_M
            if close and np.degrees(np.arccos(c)) < SLAM_REVISIT_DEG:
                out.append((i, j))
    return out


def slam_retrieval(frontend, il, Ts, cfg):
    """The keyframes' signatures ranked on the host in float64: the top
    ``max_candidates`` separated pairs, the range of all separated
    similarities, the gap after the last candidate, and each true revisit's
    similarity and rank."""
    from forest_slam_tpu_torch.backend.loop_closure import descriptor_signature

    with torch.no_grad():
        f = frontend.extract(il[::SLAM_LOOP_KF_STRIDE])
    sig = descriptor_signature(f.desc, f.valid).double().cpu().numpy()
    sim = sig @ sig.T
    n = sim.shape[0]
    sep = sorted(((i, j) for i in range(n) for j in range(i + cfg.min_separation, n)), key=lambda p: -sim[p])
    return dict(top=sep[:cfg.max_candidates], range=[float(sim[sep[-1]]), float(sim[sep[0]])],
                margin=float(sim[sep[cfg.max_candidates - 1]] - sim[sep[cfg.max_candidates]]),
                revisits=[[i, j, float(sim[i, j]), sep.index((i, j)) + 1]
                          for i, j in slam_revisits(Ts, cfg.min_separation)])


def slam_phase(dev, wrappers, launches_by_path, smi, fe, clip, workload):
    """The back end on the card, each run with its launch counts reset:
    (a) loop closure on the out-and-back corridor with P3P: the learned
    flagship with and without window BA and ORB with the test's own
    settings (384 features, 4 levels) held to tests/test_slam.py's rules,
    ORB at 512 features and 8 levels to SLAM_ORB_LOOP_HELD; the runs with
    the test's DLT-6 printed; (b) relocalization on the noise-frame corridor, ORB, held to
    tests/test_relocalize.py's; (c) bench.py's 962-pair workload, learned,
    through ``run_stereo_vo(ba=WindowBAConfig())`` and ``run_slam``: 962/962
    tracked and BA's ATE below 1.05x the VO's (``workload``: the bench
    phase's learned Workload and its VO record), with pairs/s, ATE, stage
    ms, loops and peak memory printed; (d) the sequential runners on the 31-pair
    clip, ORB: the scan tracks the batched run's pairs, and streaming in
    chunks of 8 writes the trajectory it returns, equal to the scan's."""
    import tempfile

    from forest_slam_tpu_torch import bench
    from forest_slam_tpu_torch.backend.loop_closure import LoopClosureConfig
    from forest_slam_tpu_torch.backend.relocalize import RelocalizeConfig, relocalize_trajectory
    from forest_slam_tpu_torch.backend.window import WindowBAConfig
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.io.tum import read_tum
    from forest_slam_tpu_torch.pipelines.slam import SlamConfig, run_slam
    from forest_slam_tpu_torch.pipelines.stereo import (StereoConfig, run_stereo_vo, run_stereo_vo_device,
                                                        run_stereo_vo_streaming)

    t_phase = time.time()
    failures, records = [], {}
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    orb_kernels = ("detect", "sparse_cost", "pnp_refine")
    learned_kernels = ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost", "pnp_refine")
    orb_cfg = StereoConfig(orb=OrbConfig(n_features=ORB_FEATURES, n_levels=ORB_LEVELS), n_hypotheses=SLAM_HYPOTHESES,
                           compose_mode="odometry")
    loop_orb = orb_cfg._replace(pnp_minimal=SLAM_LOOP_MINIMAL)
    learned_dlt6 = StereoConfig(n_hypotheses=SLAM_HYPOTHESES, compose_mode="odometry", match_refine_radius=12)
    loop_learned = learned_dlt6._replace(pnp_minimal=SLAM_LOOP_MINIMAL)
    orb, learned = orb_frontend(orb_cfg.orb, orb_cfg.max_match_distance), learned_frontend(fe)
    test_dlt6 = orb_cfg._replace(orb=OrbConfig(**SLAM_TEST_ORB))
    loop_orb_test = test_dlt6._replace(pnp_minimal=SLAM_LOOP_MINIMAL)
    orb_test = orb_frontend(test_dlt6.orb, test_dlt6.max_match_distance)

    def launched(name, launches, kernels):
        launches_by_path[f"slam_{name}"] = launches
        zero = [k for k in kernels if launches[k] == 0]
        if zero:
            failures.append(f"slam {name}: kernels never launched on the path: {zero}")

    # (a) loop closure
    il, ir, Ts, rig = slam_loop_scene(dev)
    n = il.shape[0]
    ts = np.arange(n) * 0.1
    gt_end = Ts[-1, :3, 3]
    loop_cfg = LoopClosureConfig(**SLAM_LOOP)
    fronts = {"orb": orb, "orb_test": orb_test, "learned": learned}
    retrieval = {k: slam_retrieval(f, il, Ts, loop_cfg) for k, f in fronts.items()}
    for k, r in retrieval.items():
        log(f"slam loop retrieval, {k}: separated similarities {r['range'][0]:.4f}-{r['range'][1]:.4f}, "
            f"16th minus 17th {r['margin']:.3g}; true revisits (i, j, similarity, rank) {r['revisits']}")
    records["retrieval"] = retrieval
    for name, stereo, front, ba, held in (("loop_orb", loop_orb, "orb", None, SLAM_ORB_LOOP_HELD),
                                          ("loop_orb_dlt6", orb_cfg, "orb", None, ()),
                                          ("loop_orb_test", loop_orb_test, "orb_test", None, SLAM_LOOP_RULES),
                                          ("loop_orb_test_dlt6", test_dlt6, "orb_test", None, ()),
                                          ("loop_learned", loop_learned, "learned", None, SLAM_LOOP_RULES),
                                          ("loop_learned_dlt6", learned_dlt6, "learned", None, ()),
                                          ("loop_learned_ba", loop_learned, "learned", WindowBAConfig(),
                                           SLAM_LOOP_RULES)):
        cfg = SlamConfig(stereo=stereo, loop=loop_cfg, keyframe_stride=SLAM_LOOP_KF_STRIDE, ba=ba)
        frontend = fronts[front]
        (_, out), launches, t_run = drive_path(wrappers, lambda: run_slam(il, ir, ts, rig, cfg, seed=0,
                                                                          frontend=frontend))
        launched(name, launches, orb_kernels if front.startswith("orb") else learned_kernels)
        tracked = int(out.vo.ok.sum().item())
        acc = out.loop_accepted.cpu()
        pairs = out.loop_pairs.cpu()[acc]
        vo_end = (out.vo.pose[-1, :3, 3] - gt_end).norm().item()
        slam_end = (out.pose[-1, :3, 3] - gt_end).norm().item()
        apart = bool(((pairs[:, 1] - pairs[:, 0]).abs() >= 6).all())
        moved = (out.pose - out.vo.pose).abs().max().item()
        candidates = out.loop_pairs.cpu().tolist()
        rules = dict(zip(SLAM_LOOP_RULES, (tracked > 0.9 * (n - 1), int(acc.sum()) >= 1, apart, slam_end < vo_end,
                                           slam_end < SLAM_LOOP_MAX_END_M)))
        top = sorted(retrieval[front]["top"])
        rules |= {"candidates = host top 16": sorted(map(tuple, candidates)) == top,
                  "no loop: SLAM = VO": bool(acc.any()) or moved <= SLAM_NO_LOOP_TOL,
                  "each loop >= 6 keyframes apart, end error below VO's":
                      not acc.any() or (apart and slam_end < vo_end)}
        records[name] = dict(tracked=tracked, pairs=n - 1, loops=int(acc.sum()), loop_pairs=pairs.tolist(),
                             candidates=candidates, slam_minus_vo=moved, vo_end_m=vo_end, slam_end_m=slam_end,
                             seconds=t_run, pairs_per_s=(n - 1) / t_run, rules=rules, held=list(held),
                             launches=launches)
        log(f"slam {name} ({stereo.pnp_minimal}): {tracked}/{n - 1} tracked, candidates {candidates}, "
            f"{int(acc.sum())} loops accepted {pairs.tolist()}, end error VO {vo_end:.4f} m -> SLAM {slam_end:.4f} m "
            f"(largest pose change {moved:.3g}), {(n - 1) / t_run:.2f} pairs/s ({t_run:.3f} s) on {card}; "
            f"rules {rules}: held {list(held)}, the rest printed")
        missed = [k for k in held if not rules[k]]
        if missed:
            failures.append(f"slam {name}: tests/test_slam.py's rules missed: {missed}")
    del il, ir

    # (b) relocalization
    il, ir, gt, rig = slam_reloc_scene(dev)

    def reloc():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        outs, art = run_stereo_vo_device(il, ir, rig, orb_cfg, g, orb, return_artifacts=True)
        g.manual_seed(1)
        return outs, relocalize_trajectory(outs.pose, outs.ok, art, rig.left, orb, (H, W), RelocalizeConfig(),
                                           generator=g)

    (outs, (poses, ev)), launches, t_run = drive_path(wrappers, reloc)
    launched("reloc", launches, orb_kernels)
    ok = outs.ok.cpu().numpy()
    end = gt[-1, :3, 3].double().cpu().numpy()
    before = float(np.linalg.norm(outs.pose[-1, :3, 3].double().cpu().numpy() - end))
    after = float(np.linalg.norm(poses[-1, :3, 3] - end))
    rules = {"both noise pairs lost": not ok[RELOC_NOISE_FRAME - 1] and not ok[RELOC_NOISE_FRAME],
             "n_lost == 2": ev.n_lost == 2, "a repair": ev.n_repaired >= 1,
             "frame 13 repaired": bool((ev.frame == RELOC_NOISE_FRAME + 1).any()),
             "references before 12": bool((ev.reference < RELOC_NOISE_FRAME).all()),
             "error before > 0.25 m": before > 0.25, f"error after < {RELOC_MAX_END_M} m": after < RELOC_MAX_END_M,
             "error after < before / 3": after < before / 3}
    records["reloc"] = dict(ok=ok.tolist(), events=dict(frame=ev.frame.tolist(), reference=ev.reference.tolist(),
                                                        n_inliers=ev.n_inliers.tolist(), n_lost=ev.n_lost),
                            end_before_m=before, end_after_m=after, seconds=t_run, rules=rules, launches=launches)
    log(f"slam reloc: {int(ok.sum())}/{ok.size} tracked, events frame {ev.frame.tolist()} reference "
        f"{ev.reference.tolist()} inliers {ev.n_inliers.tolist()}, n_lost {ev.n_lost}; end error {before:.4f} m -> "
        f"{after:.4f} m; {t_run:.3f} s on {card}; rules {rules}")
    if not all(rules.values()):
        failures.append(f"slam reloc: tests/test_relocalize.py's rules missed: {[k for k, v in rules.items() if not v]}")
    del il, ir

    # (c) the 962-pair workload through the back end; its VO is the bench phase's learned run
    wl, rec = workload[0], {"vo": workload[1]}
    ul, ur, _, rig = wl.images
    idx = torch.as_tensor(bench.frame_index(bench.N_FRAMES, bench.N_UNIQUE), device=dev, dtype=torch.long)
    il, ir = ul[idx], ur[idx]
    n = il.shape[0]
    ts = np.arange(n) * 0.1
    cfg = bench.main_config("sp")
    batches = dict(frame_batch=bench.FRAME_CHUNK, pair_batch=bench.PAIR_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    out, launches, t_run = drive_path(wrappers, lambda: run_stereo_vo(il, ir, ts, rig, cfg, seed=0, frontend=learned,
                                                                      ba=WindowBAConfig(), **batches)[1])
    launched("workload_vo_ba", launches, learned_kernels)
    err, _ = bench.trajectory_errors(out.pose, wl.truth)
    rec["vo_ba"] = dict(tracked=int(out.ok.sum().item()), ate_m=err.rmse, seconds=t_run, pairs_per_s=(n - 1) / t_run,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    slam_cfg = SlamConfig(stereo=cfg, keyframe_stride=SLAM_KF_STRIDE)
    torch.cuda.reset_peak_memory_stats()
    (_, out), launches, t_run = drive_path(wrappers, lambda: run_slam(il, ir, ts, rig, slam_cfg, seed=0,
                                                                      frontend=learned, **batches))
    launched("workload_slam", launches, learned_kernels)
    err, _ = bench.trajectory_errors(out.pose, wl.truth)
    rec["slam"] = dict(tracked=int(out.vo.ok.sum().item()), ate_m=err.rmse, seconds=t_run,
                       pairs_per_s=(n - 1) / t_run, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       loops=int(out.n_loops.item()), loop_pairs=out.loop_pairs[out.loop_accepted].tolist(),
                       keyframes=len(range(0, n, SLAM_KF_STRIDE)), launches=launches)
    # the stages of SLAM with BA: the host milliseconds of their spans
    from forest_slam_tpu_torch.pipelines.slam import run_stereo_slam
    from forest_slam_tpu_torch.utils import trace

    def staged():
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return run_stereo_slam(il, ir, rig, slam_cfg._replace(ba=WindowBAConfig()), g, learned, **batches)

    torch.cuda.reset_peak_memory_stats()
    with trace.recording() as stages:
        out, launches, t_run = drive_path(wrappers, staged)
    stage_ms = {k.removeprefix("fs.slam."): r["host_ms"] for k, r in stages.summary().items()
                if k.startswith("fs.slam.")}
    launched("workload_slam_ba", launches, learned_kernels)
    err, _ = bench.trajectory_errors(out.pose, wl.truth)
    rec["slam_ba"] = dict(tracked=int(out.vo.ok.sum().item()), ate_m=err.rmse, seconds=t_run,
                          pairs_per_s=(n - 1) / t_run, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          loops=int(out.n_loops.item()), stage_ms=stage_ms,
                          launches=launches)
    records["workload"] = rec
    for name, r in rec.items():
        log(f"slam workload {name}: {r['tracked']}/{n - 1} tracked, ATE {r['ate_m']:.4f} m, {r['pairs_per_s']:.2f} "
            f"pairs/s ({r['seconds']:.3f} s)" + (f", peak {r['peak_gib']:.2f} GiB" if "peak_gib" in r else "")
            + f" on {card}" + (" (the bench phase's learned run, median of its timed runs)" if name == "vo" else "")
            + (f"; {r['keyframes']} keyframes, {r['loops']} loops accepted {r['loop_pairs']}" if name == "slam" else "")
            + (f"; {r['loops']} loops accepted, stage ms {({k: round(v, 1) for k, v in r['stage_ms'].items()})}"
               if name == "slam_ba" else ""))
    if not all(r["tracked"] == n - 1 for r in rec.values()):
        failures.append(f"slam workload: not every pair tracked {[r['tracked'] for r in rec.values()]}")
    if not rec["vo_ba"]["ate_m"] < BA_MAX_ATE_RATIO * rec["vo"]["ate_m"]:
        failures.append(f"slam workload: BA's ATE {rec['vo_ba']['ate_m']} >= {BA_MAX_ATE_RATIO} x VO's "
                        f"{rec['vo']['ate_m']}")
    del il, ir, out
    torch.cuda.empty_cache()

    # (d) the sequential runners on the 31-pair clip
    il, ir, _, rig = clip
    n = il.shape[0]
    ts = np.arange(n) * 0.1
    batched, _, _ = drive_path(wrappers, lambda: run_stereo_vo(il, ir, ts, rig, orb_cfg, seed=0)[1])
    scan, launches, t_scan = drive_path(wrappers, lambda: run_stereo_vo(il, ir, ts, rig, orb_cfg, seed=0,
                                                                        mode="scan")[1])
    launched("scan", launches, orb_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.txt")
        (traj, stream), launches, t_stream = drive_path(wrappers, lambda: run_stereo_vo_streaming(
            il, ir, ts, rig, orb_cfg, path, seed=0, chunk=STREAM_CHUNK))
        on_disk = read_tum(path)
    launched("stream", launches, orb_kernels)
    file_diff = float(np.abs(on_disk.positions - traj.positions).max())
    scan_diff = (stream.pose - scan.pose.cpu()).abs().max().item()
    rules = {"scan tracks the batched pairs": torch.equal(scan.ok, batched.ok),
             "file rows = returned trajectory": len(on_disk) == n - 1 and file_diff < 1e-5,
             f"stream = scan within {STREAM_POSE_TOL}": scan_diff <= STREAM_POSE_TOL}
    records["runners"] = dict(batched_tracked=int(batched.ok.sum().item()), scan_tracked=int(scan.ok.sum().item()),
                              scan_seconds=t_scan, stream_seconds=t_stream, stream_vs_scan=scan_diff,
                              file_vs_returned=file_diff, rules=rules)
    log(f"slam runners: batched {int(batched.ok.sum().item())}/{n - 1}, scan {int(scan.ok.sum().item())}/{n - 1} "
        f"({t_scan:.3f} s), streaming in chunks of {STREAM_CHUNK} ({t_stream:.3f} s) against the scan {scan_diff:.3g}, "
        f"file against returned {file_diff:.3g}; rules {rules}")
    if not all(rules.values()):
        failures.append(f"slam runners: {[k for k, v in rules.items() if not v]}")
    records["seconds"] = time.time() - t_phase
    log(f"slam phase: {records['seconds']:.1f} s")
    print(json.dumps({"slam": records}, default=str), flush=True)
    return failures


SGM_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "sgm_cv2.npz")


def dense_phase(wrappers, launches_by_path, smi, run, report, il, ir):
    """The 31-pair clip through ``run`` (the learned path with dense
    depth): tracking within the clip's bounds, the learned kernels but
    ``sparse_cost`` launched; SGM's time a frame; the cv2 fixture check."""
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig, sgm_disparity

    _, _, t_cold = drive_path(wrappers, run)
    log(f"dense path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run)
    launches_by_path["dense"] = launches
    n_pairs = out.pose.shape[0]
    tracked, err = report("dense", out, t_run, launches, shares=False)
    failures = path_failures("dense", out, tracked, err, launches,
                             ("select", "gnn_layer", "sinkhorn_decode", "refine_cost", "pnp_refine"),
                             idle_kernels=("sparse_cost",))
    sgm_ms = time_ms(lambda: sgm_disparity(il[:2], ir[:2], SgmConfig()), reps=3) / 2
    fixture, fix_failures = sgm_fixture_check(il.device)
    failures += fix_failures
    log(f"dense: SGM (D={SgmConfig().num_disparities}, block {SgmConfig().block_size}) {sgm_ms:.2f} ms a frame at "
        f"{il.shape[2]}x{il.shape[1]} in pairs of frames, {n_pairs / t_run:.2f} pairs/s on the clip, on "
        f"{torch.cuda.get_device_name(0)} ({smi}); cv2 fixture: valid {fixture['valid_share']:.4f}, |ours - cv2| "
        f"median {fixture['median_vs_cv2']:.4f} p90 {fixture['p90_vs_cv2']:.4f}, median error to ground truth "
        f"{fixture['median_vs_gt']:.4f} (cv2 {fixture['cv2_median_vs_gt']:.4f}); card equals CPU on every integer "
        f"disparity: {fixture['integer_equal_cpu']}, largest difference {fixture['max_abs_diff_cpu']:.3g} (CPU "
        f"{fixture['cpu_seconds']:.2f} s)")
    print(json.dumps({"dense": {"tracked": tracked, "pairs": n_pairs, "ate_m": err, "pairs_per_s": n_pairs / t_run,
                                "sgm_ms_per_frame": sgm_ms, "fixture": fixture, "launches": launches}}), flush=True)
    return failures


def sgm_fixture_check(dev):
    """The port's SGM on the card over the OpenCV fixture (600x960, D=96):
    tests/test_stereo_disparity.py's bounds, and equality with the port's
    CPU result. Returns (record, failures)."""
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig, sgm_disparity

    fix = np.load(SGM_FIXTURE)
    left, right, cv, gt = (fix[k].astype(np.float32) for k in ("left", "right", "disparity", "gt_disparity"))
    lt, rt = torch.as_tensor(left)[None], torch.as_tensor(right)[None]
    ours = sgm_disparity(lt.to(dev), rt.to(dev), SgmConfig())[0].cpu().numpy()
    t0 = time.time()
    on_cpu = sgm_disparity(lt, rt, SgmConfig())[0].numpy()
    t_cpu = time.time() - t0
    both = (ours > 0) & (cv > 0)
    both[:, :100] = False
    agree = np.abs(ours - cv)[both]
    m = both & (gt > 1.0) & (gt < 90.0)
    med_ours, med_cv = float(np.median(np.abs(ours - gt)[m])), float(np.median(np.abs(cv - gt)[m]))
    rec = dict(valid_share=float(both.mean()), median_vs_cv2=float(np.median(agree)),
               p90_vs_cv2=float(np.percentile(agree, 90)), median_vs_gt=med_ours, cv2_median_vs_gt=med_cv,
               integer_equal_cpu=bool(np.array_equal(np.floor(ours), np.floor(on_cpu))),
               max_abs_diff_cpu=float(np.abs(ours - on_cpu).max()), cpu_seconds=t_cpu)
    failures = []
    if not (rec["valid_share"] > 0.5 and rec["median_vs_cv2"] < 0.5 and rec["p90_vs_cv2"] < 2.0
            and med_ours < max(2.0 * med_cv, 0.3)):
        failures.append(f"dense: SGM outside the cv2 fixture's bounds: {rec}")
    if not (rec["integer_equal_cpu"] and rec["max_abs_diff_cpu"] <= 1e-6):
        failures.append("dense: SGM on the card differs from the CPU's on the fixture")
    return rec, failures


# the bag phase: a BotanicGarden-shaped stereo bag written on the host and read
# back through the CLI (forest_slam_tpu_torch.cli), as a user runs it
BAG_FRAMES = 129  # bench.py's 64 unique workload poses, ping-ponged
BAG_CHECK_FRAMES = 16  # the bz2 copy, and the frames whose loaded stacks are checked
BAG_BZ2_CHUNK = 512 * 1024
BAG_LIDAR_POINTS, BAG_LIDAR_NAN = 3000, 0.05
BAG_MONO_FRAMES, BAG_MONO_STRIDE = 32, 2
# mono's Sim(3) ATE bound: 5% of the path of frames 0, 2, ..., 62 (chip_smoke's mono rule)
BAG_MONO_MAX_ATE_M = 0.05 * (BAG_MONO_FRAMES - 1) * BAG_MONO_STRIDE * 0.15
# grey levels: the card's undistorted stacks against a float64 host undistort of the frames written
BAG_PREPROCESS_TOL = 0.05
BAG_GT_TOL_M = 1e-5  # gt-traj's camera poses against the rendered ones (written as %f)
# the CLI's unrectified runs on a distorted rig keep two behaviours of the reference that bias their poses, so
# their ATE is printed, not held (ROADMAP Queue C item 12): PnP scores with the distortion of a camera whose
# frames are already undistorted (geometry/pnp.py, the reference's double correction), and sparse stereo reads
# disparity along rows of unrectified frames whose principal points differ by 5 px (quirk B3). --rectify runs,
# and the zero-distortion run, are held.
BAG_UNRECTIFIED_NOTE = "printed, not held: PnP's double distortion correction, unrectified stereo"
BAG_KERNELS = {"sp": ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost", "pnp_refine"),
               "orb": ("detect", "sparse_cost", "pnp_refine")}


def bag_scene(dev, n_unique=None, n_frames=BAG_FRAMES):
    """bench.py's corridor world and the first ``n_unique`` (default all
    64) of its unique workload poses (0.15 m a frame) ping-ponged to
    ``n_frames``, rendered at the BotanicGarden rig (left at K_left; right at
    K_right, T_left_right from the left) and distorted by each camera's k1,
    k2: (left, right) distorted float frames, the ideal left frames, the
    poses, the rig."""
    from forest_slam_tpu_torch import bench
    from forest_slam_tpu_torch.core.lie import se3_compose
    from forest_slam_tpu_torch.io import calib
    from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, distort_view, make_corridor_world, render_view

    n_unique = bench.N_UNIQUE if n_unique is None else n_unique
    rig = calib.botanic_garden_rig(dev)
    world = make_corridor_world(textures=bench._world_arrays("corridor", 0.0), device=dev)  # cached by the bench phase
    Ts = corridor_trajectory(n_unique, speed=bench.SPEED, device=dev)
    il, ir = [], []
    for s in range(0, n_unique, 16):
        T = Ts[s:s + 16]
        il.append(render_view(world, T, rig.left.K, calib.BOTANIC_HEIGHT, calib.BOTANIC_WIDTH)[0])
        ir.append(render_view(world, se3_compose(T, rig.T_left_right), rig.right.K, calib.BOTANIC_HEIGHT,
                              calib.BOTANIC_WIDTH)[0])
    il, ir = torch.cat(il), torch.cat(ir)
    dl, dr = distort_view(il, rig.left), distort_view(ir, rig.right)
    idx = torch.as_tensor(bench.frame_index(n_frames, n_unique), device=dev, dtype=torch.long)
    return dl[idx], dr[idx], il[idx], Ts[idx], rig


def bag_lidar(Ts, seed=0):
    """One scan a frame in the VLP16 frame: points on the corridor's walls
    (x = +-4 m) and floor (y = 1.5 m) within 12 m of the camera, a share NaN."""
    from forest_slam_tpu_torch.io import calib

    rng = np.random.default_rng(seed)
    T = Ts.double().cpu().numpy()
    T_sensor = np.linalg.inv(calib.BOTANIC_T_RGB0_VLP16) @ T
    scans = []
    for k in range(T.shape[0]):
        n = BAG_LIDAR_POINTS
        z = T[k, 2, 3] + rng.uniform(-12.0, 12.0, n)
        wall = rng.random(n) < 2 / 3
        x = np.where(wall, np.where(rng.random(n) < 0.5, -4.0, 4.0), rng.uniform(-4.0, 4.0, n))
        y = np.where(wall, rng.uniform(-4.5, 1.5, n), 1.5)
        world = np.stack([x, y, z, np.ones(n)], axis=1)
        pts = (world @ np.linalg.inv(T_sensor[k]).T)[:, :3].astype(np.float32)
        pts[rng.random(n) < BAG_LIDAR_NAN] = np.nan
        scans.append(pts)
    return scans


def undistort_host(frames: np.ndarray, cam) -> np.ndarray:
    """The loader's preprocessing done independently on the host in float64:
    BGR frames (N, H, W, 3) uint8 to gray, then the bilinear undistort remap
    (cv2.initUndistortRectifyMap's map; samples outside read 0)."""
    K = cam.K.double().cpu().numpy()
    k1, k2, p1, p2, k3 = cam.dist.double().cpu().numpy()
    H, W = cam.height, cam.width
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = (gx - K[0, 2]) / K[0, 0], (gy - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    sx = (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)) * K[0, 0] + K[0, 2]
    sy = (y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y) * K[1, 1] + K[1, 2]
    gray = frames[..., 0] * 0.114 + frames[..., 1] * 0.587 + frames[..., 2] * 0.299
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    out = np.zeros(gray.shape, np.float64)
    for dy, dx, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)), (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < gray.shape[1]) & (xx >= 0) & (xx < gray.shape[2])
        out += np.where(inside, gray[:, yy.clip(0, gray.shape[1] - 1), xx.clip(0, gray.shape[2] - 1)], 0.0) * w
    return out


def bag_phase(dev, wrappers, launches_by_path, smi):
    """A 960x600 BotanicGarden-shaped stereo bag (bgr8, uncompressed, with
    /gt_poses and /velodyne_points) and a 16-frame copy in bz2 chunks of 512
    KiB, written under a temporary directory, then the CLI in process:
    gt-traj, gt-map, stereo --bag (sp with the map and the viewer, orb, sp
    with --rectify) and slam --bag (sp, and sp with --rectify), each
    evaluated by ``eval`` against the bag's own gt-traj and held to
    MIN_TRACKED, the --rectify runs also to MAX_ATE_M in Sim(3) and SE(3)
    (the unrectified runs' ATE printed: BAG_UNRECTIFIED_NOTE); the learned
    path on the loaded frames with the rig's distortion zeroed, held to
    MAX_ATE_M in Sim(3); mono --bag (orb, 32 frames at stride 2) held to the
    mono rules; and view. Also held: the native reader on both bags, native
    and Python readers equal on the bz2 bag, gt-traj equal to the rendered
    poses, and the first 16 loaded frames equal to a float64 host undistort
    of the frames written. Each run resets the launch counts."""
    import contextlib
    import io
    import re
    import tempfile

    from forest_slam_tpu_torch.cli import main as cli_main
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.io import calib
    from forest_slam_tpu_torch.io.dataset import (LEFT_TOPIC, RIGHT_TOPIC, load_stereo_from_bag, preprocess_frames,
                                                  read_stereo, read_stereo_python)
    from forest_slam_tpu_torch.io.synthetic import write_stereo_bag
    from forest_slam_tpu_torch.io.tum import read_tum, write_tum
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo

    t_phase = time.time()
    failures, records = [], {}
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    dl, dr, ideal, Ts, rig = bag_scene(dev)
    stamps = 1.6e9 + 0.1 * np.arange(BAG_FRAMES)
    t_render = time.time() - t_phase

    def cli(name, argv, kernels=()):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, launches, t = drive_path(wrappers, lambda: cli_main(argv))
        said = out.getvalue()
        launches_by_path[f"bag_{name}"] = launches
        if rc != 0:
            failures.append(f"bag {name}: the CLI exited {rc}: {said[-500:]}")
        zero = [k for k in kernels if launches[k] == 0]
        if zero:
            failures.append(f"bag {name}: kernels never launched: {zero}")
        if "--bag" in argv and argv[0] in ("stereo", "slam", "mono") and "(native reader)" not in said:
            failures.append(f"bag {name}: the CLI did not read with the native reader: {said[:300]}")
        return said, launches, t

    with tempfile.TemporaryDirectory(prefix="bag_phase_") as tmp:
        big, small = os.path.join(tmp, "botanic.bag"), os.path.join(tmp, "botanic_bz2.bag")
        t0 = time.time()
        write_stereo_bag(big, dl, dr, stamps, Ts, calib.BOTANIC_T_RGB0_VLP16, bag_lidar(Ts))
        t_write = time.time() - t0
        t0 = time.time()
        write_stereo_bag(small, dl[:BAG_CHECK_FRAMES], dr[:BAG_CHECK_FRAMES], stamps[:BAG_CHECK_FRAMES],
                         compression="bz2", chunk_size=BAG_BZ2_CHUNK)
        t_write_bz2 = time.time() - t0
        mb, mb_bz2 = os.path.getsize(big) / 1e6, os.path.getsize(small) / 1e6
        log(f"bag: wrote {BAG_FRAMES} stereo pairs at 960x600 bgr8 ({mb:.1f} MB, {t_write:.2f} s) and a "
            f"{BAG_CHECK_FRAMES}-pair copy in bz2 chunks of {BAG_BZ2_CHUNK // 1024} KiB ({mb_bz2:.1f} MB, "
            f"{t_write_bz2:.2f} s); scene rendered and distorted on the card in {t_render:.2f} s")

        # the readers: native and Python on both bags
        reads = {}
        for tag, path in (("plain", big), ("bz2", small)):
            size = os.path.getsize(path) / 1e6
            t0 = time.time()
            nl, nr, nt, reader = read_stereo(path)
            t_nat = time.time() - t0
            t0 = time.time()
            pl, pr, pt = read_stereo_python(path, LEFT_TOPIC, RIGHT_TOPIC, None, 1)
            t_py = time.time() - t0
            equal = bool(np.array_equal(nl, pl) and np.array_equal(nr, pr) and np.array_equal(nt, pt))
            frames_mb = (nl.nbytes + nr.nbytes) / 1e6
            reads[tag] = dict(reader=reader, pairs=int(nl.shape[0]), file_mb=size, frames_mb=frames_mb,
                              native_mb_s=frames_mb / t_nat, python_mb_s=frames_mb / t_py, native_s=t_nat,
                              python_s=t_py, equal=equal)
            if reader != "native":
                failures.append(f"bag: the loader read the {tag} bag with the {reader} reader, not the native one")
            if not equal or nl.shape[0] != (BAG_FRAMES if tag == "plain" else BAG_CHECK_FRAMES):
                failures.append(f"bag: the native and Python readers differ on the {tag} bag")
            if tag == "plain":
                lefts = nl
            del nl, nr, pl, pr
        torch.cuda.synchronize()
        t0 = time.time()
        pre = preprocess_frames(lefts, rig.left, device=dev)
        torch.cuda.synchronize()
        pre_ms = (time.time() - t0) * 1e3 / BAG_FRAMES
        del pre
        # the first frames through the loader against the host's float64 undistort of the frames written
        seq = load_stereo_from_bag(big, rig, max_frames=BAG_CHECK_FRAMES, device=dev)
        want = undistort_host(lefts[:BAG_CHECK_FRAMES], rig.left)
        got = seq.images_left.double().cpu().numpy()
        pre_err = float(np.abs(got - want).max())
        dev_ideal = (seq.images_left - ideal[:BAG_CHECK_FRAMES])[:, 10:-10, 10:-10].abs()
        ideal_stats = dict(mean=dev_ideal.mean().item(), p99=torch.quantile(dev_ideal[0].flatten()[::17], 0.99).item(),
                           max=dev_ideal.max().item())
        if seq.reader != "native" or pre_err > BAG_PREPROCESS_TOL:
            failures.append(f"bag: loaded frames off the host undistort by {pre_err} (tolerance "
                            f"{BAG_PREPROCESS_TOL}), reader {seq.reader}")
        records.update(reads=reads, preprocess_ms_per_frame=pre_ms, preprocess_max_err=pre_err,
                       undistort_of_distort=ideal_stats, bag_mb=mb, bz2_mb=mb_bz2, write_s=t_write)
        log(f"bag readers (MB of frames delivered a second) on {card}'s host: " + "; ".join(
            f"{tag} ({r['file_mb']:.1f} MB file, {r['frames_mb']:.1f} MB of frames): {r['reader']} "
            f"{r['native_mb_s']:.1f} MB/s ({r['native_s']:.3f} s), Python {r['python_mb_s']:.1f} MB/s "
            f"({r['python_s']:.3f} s), equal {r['equal']}" for tag, r in reads.items())
            + f"; preprocess_frames {pre_ms:.3f} ms a frame (960x600 bgr8 -> gray, undistorted); loaded frames vs "
            f"host float64 undistort max {pre_err:.3g} (tolerance {BAG_PREPROCESS_TOL}); undistort of the distort "
            f"against the rendered frames (10 px border out): mean {ideal_stats['mean']:.3f}, p99 "
            f"{ideal_stats['p99']:.2f}, max {ideal_stats['max']:.2f} grey levels")
        del seq, dl, dr, ideal
        torch.cuda.empty_cache()

        gt, gtmap = os.path.join(tmp, "gt.txt"), os.path.join(tmp, "gt_map.ply")
        said, _, t_gt = cli("gt_traj", ["gt-traj", "--bag", big, "--out", gt])
        gt_err = float(np.abs(read_tum(gt).positions - Ts[1:, :3, 3].double().cpu().numpy()).max())
        if len(read_tum(gt)) != BAG_FRAMES - 1 or not gt_err < BAG_GT_TOL_M:
            failures.append(f"bag gt-traj: {len(read_tum(gt))} poses, {gt_err} m off the rendered poses")
        said, _, t_map = cli("gt_map", ["gt-map", "--bag", big, "--out", gtmap])
        n_map = int(re.search(r"gt-map: (\d+) points", said).group(1)) if "gt-map:" in said else 0
        if n_map < 1000:
            failures.append(f"bag gt-map: {n_map} points")
        records["gt"] = dict(traj_seconds=t_gt, traj_max_err_m=gt_err, map_points=n_map, map_seconds=t_map)
        log(f"bag gt-traj: {BAG_FRAMES - 1} poses in {t_gt:.2f} s, {gt_err:.3g} m off the rendered poses; gt-map: "
            f"{n_map} points in {t_map:.2f} s")

        def evaluate(est, scale):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli_main(["eval", "--est", est, "--gt", gt] + ([] if scale else ["--no-scale"]))
            return json.loads(out.getvalue())["ape"]

        # (name, CLI arguments, front end, writes the map and viewer, ATE held)
        runs = (("stereo_sp", ["stereo", "--frontend", "sp"], "sp", True, False),
                ("stereo_orb", ["stereo", "--frontend", "orb"], "orb", False, False),
                ("stereo_sp_rectify", ["stereo", "--frontend", "sp", "--rectify"], "sp", False, True),
                ("slam_sp", ["slam", "--frontend", "sp"], "sp", False, False),
                ("slam_sp_rectify", ["slam", "--frontend", "sp", "--rectify"], "sp", False, True))
        est_sp = None
        for name, argv, kind, outputs, ate_held in runs:
            est = os.path.join(tmp, f"{name}.txt")
            extra = ["--map-out", os.path.join(tmp, "map.ply"), "--viewer-out", os.path.join(tmp, "run.html")] \
                if outputs else []
            said, launches, t = cli(name, argv + ["--bag", big, "--compose-mode", "odometry", "--out", est,
                                                  "--device", dev.type] + extra, BAG_KERNELS[kind])
            m = re.search(r"tracked (\d+)/(\d+)", said)
            tracked, pairs = (int(m.group(1)), int(m.group(2))) if m else (0, BAG_FRAMES - 1)
            sim3, se3 = evaluate(est, True), evaluate(est, False)
            loops = re.search(r"loops (\d+)", said)
            rec = dict(tracked=tracked, pairs=pairs, ate_sim3_m=sim3["rmse"], ate_se3_m=se3["rmse"],
                       pairs_per_s=pairs / t, seconds=t, launches=launches)
            if loops:
                rec["loops"] = int(loops.group(1))
            if outputs:
                est_sp = est
                html = open(os.path.join(tmp, "run.html")).read()
                rec["viewer_bytes"] = len(html)
                if '"name": "map"' not in html:
                    failures.append(f"bag {name}: the viewer holds no map layer")
            records[name] = rec
            if pairs != BAG_FRAMES - 1 or tracked < MIN_TRACKED * pairs:
                failures.append(f"bag {name}: {tracked}/{pairs} pairs tracked")
            if ate_held and not max(sim3["rmse"], se3["rmse"]) < MAX_ATE_M:
                failures.append(f"bag {name}: ATE {sim3['rmse']} m Sim(3), {se3['rmse']} m SE(3), bound {MAX_ATE_M} m")
            bound = f"bound {MAX_ATE_M}" if ate_held else BAG_UNRECTIFIED_NOTE
            log(f"bag {name}: {tracked}/{pairs} tracked, ATE {sim3['rmse']:.4f} m Sim(3), {se3['rmse']:.4f} m SE(3) "
                f"({bound}), {pairs / t:.2f} pairs/s through the CLI ({t:.3f} s: read, preprocess, front-end load and "
                f"the run){'' if not loops else f', loops {loops.group(1)}'} on {card}; launches {launches}")
            torch.cuda.empty_cache()

        # the cause of the unrectified runs' error: the same frames, the rig's distortion zeroed after undistortion
        seq = load_stereo_from_bag(big, rig, device=dev)
        zero = torch.zeros(5, device=dev)
        plain_rig = rig._replace(left=rig.left._replace(dist=zero), right=rig.right._replace(dist=zero))
        fe = learned_frontend(load_learned_frontend(FLAGSHIP_PATH, (calib.BOTANIC_HEIGHT, calib.BOTANIC_WIDTH),
                                                    device=dev))
        cfg = StereoConfig(compose_mode="odometry", match_refine_radius=12)
        (traj, outs), launches, t = drive_path(wrappers, lambda: run_stereo_vo(
            seq.images_left, seq.images_right, seq.timestamps, plain_rig, cfg, frontend=fe))
        launches_by_path["bag_stereo_sp_zero_dist"] = launches
        del seq
        est = os.path.join(tmp, "zero_dist.txt")
        write_tum(est, traj)
        sim3, se3 = evaluate(est, True), evaluate(est, False)
        tracked = int(outs.ok.sum().item())
        records["stereo_sp_zero_dist"] = dict(tracked=tracked, ate_sim3_m=sim3["rmse"], ate_se3_m=se3["rmse"],
                                              pairs_per_s=(BAG_FRAMES - 1) / t, launches=launches)
        if tracked < MIN_TRACKED * (BAG_FRAMES - 1) or not sim3["rmse"] < MAX_ATE_M:
            failures.append(f"bag stereo_sp_zero_dist: {tracked} tracked, Sim(3) ATE {sim3['rmse']} m")
        zero_k = [k for k in BAG_KERNELS["sp"] if launches[k] == 0]
        if zero_k:
            failures.append(f"bag stereo_sp_zero_dist: kernels never launched: {zero_k}")
        log(f"bag stereo_sp_zero_dist (the loaded frames, the rig's distortion zeroed for PnP): {tracked}/"
            f"{BAG_FRAMES - 1} tracked, ATE {sim3['rmse']:.4f} m Sim(3) (bound {MAX_ATE_M}), {se3['rmse']:.4f} m SE(3) "
            f"(printed: unrectified depth's scale); {(BAG_FRAMES - 1) / t:.2f} pairs/s on {card}; launches {launches}")
        del fe, outs
        torch.cuda.empty_cache()

        est = os.path.join(tmp, "mono.txt")
        said, launches, t = cli("mono_orb", ["mono", "--bag", big, "--frontend", "orb", "--compose-mode", "odometry",
                                             "--max-frames", str(BAG_MONO_FRAMES), "--frame-stride",
                                             str(BAG_MONO_STRIDE), "--out", est, "--device", dev.type], ("detect",))
        m = re.search(r"tracked (\d+)/(\d+)", said)
        tracked, pairs = (int(m.group(1)), int(m.group(2))) if m else (0, BAG_MONO_FRAMES - 1)
        sim3 = evaluate(est, True)
        records["mono_orb"] = dict(tracked=tracked, pairs=pairs, ate_sim3_m=sim3["rmse"], matched=sim3["n"],
                                   pairs_per_s=pairs / t, seconds=t, launches=launches)
        if pairs != BAG_MONO_FRAMES - 1 or tracked < MONO_MIN_TRACKED["odometry"] * pairs:
            failures.append(f"bag mono_orb: {tracked}/{pairs} pairs tracked")
        if not sim3["rmse"] < BAG_MONO_MAX_ATE_M or sim3["n"] != pairs:
            failures.append(f"bag mono_orb: Sim(3) ATE {sim3['rmse']} m >= {BAG_MONO_MAX_ATE_M} m or "
                            f"{sim3['n']} poses matched")
        if launches["sparse_cost"]:
            failures.append("bag mono_orb: sparse_cost launched on the mono path")
        log(f"bag mono_orb (frames 0..{(BAG_MONO_FRAMES - 1) * BAG_MONO_STRIDE} at stride {BAG_MONO_STRIDE}): "
            f"{tracked}/{pairs} tracked, Sim(3) ATE {sim3['rmse']:.4f} m (bound {BAG_MONO_MAX_ATE_M:.4f} m), "
            f"{pairs / t:.2f} pairs/s through the CLI ({t:.3f} s) on {card}; launches {launches}")

        view = os.path.join(tmp, "view.html")
        said, _, t_view = cli("view", ["view", "--traj", f"learned={est_sp}", "--gt", gt, "--map", gtmap, "--out",
                                       view])
        html = open(view).read() if os.path.exists(view) else ""
        if not all(f'"name": "{n}"' in html for n in ("learned", "ground truth", "map")):
            failures.append("bag view: the viewer lacks a layer")
        records["view"] = dict(bytes=len(html), seconds=t_view)
    records["seconds"] = time.time() - t_phase
    log(f"bag phase: {records['seconds']:.1f} s on {card}")
    print(json.dumps({"bag": records}), flush=True)
    return failures


def render_frames(dev, h, w, n, seed=0, speed=0.15):
    """n consecutive corridor frames at w x h rendered on the card: (left,
    right, ground-truth poses, rig)."""
    from forest_slam_tpu_torch.core.lie import se3_compose
    from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, default_rig, make_corridor_world, render_view

    world = make_corridor_world(seed=seed, device=dev)
    rig = default_rig(h, w, baseline=0.25, device=dev)
    Ts = corridor_trajectory(n, speed=speed, device=dev)
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


def ate(poses, gt, with_scale=False):
    """ATE of the poses of frames 1..N-1 against the truth of frames
    0..N-1, SE(3)-aligned (Sim(3) with ``with_scale``, for mono)."""
    from forest_slam_tpu_torch.eval.metrics import ape_translation
    from forest_slam_tpu_torch.io.tum import Trajectory

    ts = np.arange(gt.shape[0]) * 0.1
    est = Trajectory.from_matrices(ts[1:], poses.double().cpu().numpy())
    ref = Trajectory.from_matrices(ts, gt.double().cpu().numpy())
    return ape_translation(est, ref, align=True, with_scale=with_scale).rmse


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


def pnp_launch_failures(name, launches, n_pairs, pair_batch=PAIR_BATCH):
    """PnP-RANSAC's refine-and-select kernel launched once a pair chunk."""
    chunks = -(-n_pairs // pair_batch)
    if launches["pnp_refine"] != chunks:
        return [f"{name}: {launches['pnp_refine']} pnp_refine launches, not one per pair chunk ({chunks})"]
    return []


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


BENCH_CLI_FRAMES = 97


def bench_cli_phase(smi):
    """``python -m forest_slam_tpu_torch.bench --frames 97 --no-gates
    --runner chunked --profile DIR`` in a process of its own: it must exit 0,
    end with a line holding every field of bench.py's emit with a non-null
    mfu, and write its trace."""
    import tempfile

    from forest_slam_tpu_torch import bench

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "forest_slam_tpu_torch.bench", "--frames", str(BENCH_CLI_FRAMES), "--no-gates",
               "--runner", "chunked", "--profile", tmp]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.time() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1]) if lines else {}
        except ValueError:
            rec = {}
        missing = [k for k in bench.EMIT_KEYS if k not in rec]
        trace = os.path.join(tmp, "trace.json")
        traced = os.path.exists(trace) and os.path.getsize(trace) > 0
        log(f"bench CLI ({' '.join(cmd[1:])}): exit {proc.returncode} in {seconds:.1f} s; {rec.get('value')} pairs/s, "
            f"{rec.get('ok_frames')}/{rec.get('n_frames')} tracked, ATE {rec.get('ate_rmse')} m, mfu {rec.get('mfu')}, "
            f"hbm_frac {rec.get('hbm_frac')}, roofline_frac {rec.get('roofline_frac')}, device_pairs_per_sec "
            f"{rec.get('device_pairs_per_sec')}, on {torch.cuda.get_device_name(0)} ({smi}); trace written: {traced} "
            f"({os.path.getsize(trace) if traced else 0} bytes); missing fields {missing}")
        for line in proc.stderr.splitlines():
            if "the ten operations" in line or line.startswith("#   "):
                print("  " + line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            failures.append(f"bench CLI: exit {proc.returncode}")
        if missing or rec.get("mfu") is None or not traced:
            failures.append(f"bench CLI: fields missing {missing}, mfu {rec.get('mfu')}, trace written {traced}")
    print(json.dumps({"bench_cli": rec}), flush=True)
    return failures


def train_phase(dev, wrappers, launches_by_path, smi):
    """Train from create_train_state through ``train`` (the entry point's
    loop) on a pool rendered on the card: the loss must fall by the rule,
    the attention kernel launch 18 times a step and no other kernel, one
    step agree with the CPU's, and the checkpoint read back whole."""
    import copy
    import tempfile

    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend, params_to_jax, save_params
    from forest_slam_tpu_torch.train.data import TrainingBatch, make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import checkpoint_meta, create_train_state, train

    failures = []
    cfg = train_config()
    t0 = time.time()
    state = create_train_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pool = make_corridor_pool(gen, TRAIN_POOL, TRAIN_H, TRAIN_W, TRAIN_M, device=dev)
    torch.cuda.synchronize()
    log(f"train: {TRAIN_POOL}-pair corridor pool rendered on the card in {time.time() - t0:.2f} s; labelled corners "
        f"{int(pool.valid0.sum().item())} in view 0, {int(pool.valid1.sum().item())} visible in view 1")

    # one step on the card against the CPU: same batch, same parameters
    batch = make_training_batch(gen, TRAIN_BATCH, TRAIN_H, TRAIN_W, TRAIN_M, cfg.texture_fraction,
                                cfg.corridor_fraction, pool, dev)
    t0 = time.time()
    card = step_gradients(state.frontend, batch, cfg)
    t_card = time.time() - t0
    t0 = time.time()
    cpu = step_gradients(copy.deepcopy(state.frontend).cpu(), TrainingBatch(*(t.cpu() for t in batch)), cfg)
    t_cpu = time.time() - t0
    agree = step_agreement(cpu, card)
    log(f"train: one step, card against CPU ({t_card:.2f} s vs {t_cpu:.2f} s, first calls): losses card "
        + ", ".join(f"{k} {card[0][k]:.6g}" for k in card[0]) + "; relative differences "
        + ", ".join(f"{k} {v:.3g}" for k, v in agree["rel"].items())
        + f"; gradient cosine {agree['global_cos']:.6f}, rel-L2 {agree['global_rel']:.4f}, least leaf cosine "
        f"{agree['leaf_min_cos']:.5f} ({agree['leaf_worst']}, {agree['leaves_checked']} leaves), SuperPoint's "
        f"detector + descriptor gradient least cosine {agree['sp_min_cos']:.6f} (tolerance {TRAIN_AGREEMENT}): "
        f"{'PASS' if agree['ok'] else 'FAIL'}")
    if not agree["ok"]:
        failures.append("train: the card's step disagrees with the CPU's")
    del card, cpu

    (state, history), launches, t_run = drive_path(
        wrappers, lambda: train(cfg, TRAIN_STEPS, seed=0, log_every=50, state=state, device=dev,
                                corridor_pool=pool, verbose=False))
    launches_by_path["train"] = launches
    losses = np.array([m["loss"] for _, m in history])
    tenth = TRAIN_STEPS // 10
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    log(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} pairs at {TRAIN_W}x{TRAIN_H} (stem 2, "
        f"{cfg.superglue.gnn_layers} layer pairs, {TRAIN_M} corners) in {t_run:.2f} s: {TRAIN_STEPS / t_run:.2f} steps/s on "
        f"{torch.cuda.get_device_name(0)} ({smi}); mean loss first tenth {first:.4f}, last tenth {last:.4f} "
        f"(ratio {last / first:.4f}, rule < {TRAIN_LOSS_RATIO}); last step "
        + " ".join(f"{k}={v:.4f}" for k, v in history[-1][1].items()) + f"; launches {launches}")
    print(json.dumps({"train": {"steps": TRAIN_STEPS, "steps_per_s": TRAIN_STEPS / t_run, "seconds": t_run,
                                "loss_first_tenth": first, "loss_last_tenth": last,
                                "loss_every_50": [round(float(x), 4) for x in losses[::50]],
                                "agreement": {k: agree[k] for k in ("rel", "global_cos", "global_rel", "leaf_min_cos",
                                                                     "sp_min_cos")},
                                "launches": launches}}), flush=True)
    if len(history) != TRAIN_STEPS or not all(np.isfinite(list(m.values())).all() for _, m in history):
        failures.append("train: a loss is not finite (or steps are missing)")
    if not last < TRAIN_LOSS_RATIO * first:
        failures.append(f"train: the loss did not fall ({first:.4f} -> {last:.4f})")
    per_step = 2 * cfg.superglue.gnn_layers
    if launches["attention"] != per_step * TRAIN_STEPS:
        failures.append(f"train: {launches['attention']} attention launches, not {per_step} a step")
    busy = [k for k, n in launches.items() if k != "attention" and n]
    if busy:
        failures.append(f"train: kernels launched that the training path must not run: {busy}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.msgpack")
        save_params(params_to_jax(state.frontend), path, meta=checkpoint_meta(cfg))
        back = load_learned_frontend(path, (TRAIN_H, TRAIN_W), TRAIN_M, device=dev)
        ok = (same_tree(params_to_jax(state.frontend), params_to_jax(back)) and back.cfg.superpoint.stem_stride == 2
              and back.cfg.superglue.gnn_layers == 9)
        log(f"train: checkpoint of {os.path.getsize(path)} bytes written by save_params and read back by "
            f"load_learned_frontend: {'equal weights' if ok else 'DIFFERENT'}")
    if not ok:
        failures.append("train: the checkpoint read back differs from the trained weights")
    return failures


# the multi-GPU phase: parallel/, pipelines/batch_eval.py and the sharded
# train step on one card, one NCCL rank (the driver's machine has one)
MULTICHIP_SEQS, MULTICHIP_FRAMES = 4, 16
MULTICHIP_POOL = 16
MULTICHIP_UPDATE_RTOL = 5e-2  # tests/test_training.py's bound on the update norm
MULTICHIP_KERNELS = {"learned": ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost",
                                 "pnp_refine"),
                     "orb": ("detect", "sparse_cost", "pnp_refine")}
DRYRUN_TIMEOUT_S = 300


def multichip_phase(dev, wrappers, launches_by_path, smi, fe, orb_cfg):
    """make_mesh(1) on the card: the sharded train step against train_step,
    run_batched_eval against run_stereo_vo_device with both front ends, and
    the dry run in a process of its own."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.parallel import make_mesh
    from forest_slam_tpu_torch.pipelines.batch_eval import run_batched_eval, sequence_seed
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device
    from forest_slam_tpu_torch.train.data import make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state, make_sharded_train_step, train_step

    failures = []
    t_phase = time.time()
    mesh = make_mesh(1, "cuda")
    log(f"multichip: make_mesh(1): {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{torch.distributed.get_backend()}, rank {torch.distributed.get_rank()} of "
        f"{torch.distributed.get_world_size()}")

    # (a) the sharded train step against train_step, same batch and parameters
    cfg = train_config()
    state = create_train_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    pool = make_corridor_pool(gen, MULTICHIP_POOL, TRAIN_H, TRAIN_W, TRAIN_M, device=dev)
    batch = make_training_batch(gen, TRAIN_BATCH, TRAIN_H, TRAIN_W, TRAIN_M, cfg.texture_fraction,
                                cfg.corridor_fraction, pool, dev)
    ref = step_gradients(state.frontend, batch, cfg)
    step, sharded = make_sharded_train_step(mesh, state, cfg)
    host = lambda grads: {n: g.detach().double().cpu().numpy().ravel() for n, g in grads.items()}
    _, g_sp = step.gradients(sharded, batch, of=lambda m: m["detector"] + m["descriptor"])
    metrics, g_all = step.gradients(sharded, batch)
    got = ({k: float(v) for k, v in metrics.items()}, host(g_all), host(g_sp))
    agree = step_agreement(ref, got)
    start = {n: p.detach().clone() for n, p in state.frontend.named_parameters()}
    (sharded, step_metrics), launches, t_step = drive_path(wrappers, lambda: step(sharded, batch))
    launches_by_path["multichip_train"] = launches
    state, _ = train_step(state, batch, cfg)
    full = step.parameters(sharded)
    norm = lambda new: float(sum(float(((new[n] - start[n]).double() ** 2).sum()) for n in start) ** 0.5)
    n_ref = norm({n: p.detach() for n, p in state.frontend.named_parameters()})
    n_got = norm(full)
    upd_rel = abs(n_got - n_ref) / max(n_ref, 1e-30)
    ok_train = agree["ok"] and upd_rel <= MULTICHIP_UPDATE_RTOL and sharded.step == 1
    log(f"multichip: sharded train step ({len(sharded.shards)} kernels sharded over model=1) against train_step: "
        "relative loss differences " + ", ".join(f"{k} {v:.3g}" for k, v in agree["rel"].items())
        + f"; gradient cosine {agree['global_cos']:.6f}, rel-L2 {agree['global_rel']:.4f}, least leaf cosine "
        f"{agree['leaf_min_cos']:.5f} ({agree['leaves_checked']} leaves); update norm {n_got:.6g} vs {n_ref:.6g} "
        f"(relative {upd_rel:.3g}, bound {MULTICHIP_UPDATE_RTOL}): {'PASS' if ok_train else 'FAIL'}; one step "
        f"{t_step:.3f} s ({1 / t_step:.2f} steps/s) on {torch.cuda.get_device_name(0)} ({smi}); launches {launches}")
    if not ok_train:
        failures.append("multichip: the sharded train step disagrees with train_step")
    if launches["attention"] != 2 * cfg.superglue.gnn_layers:
        failures.append(f"multichip: {launches['attention']} attention launches in the sharded step, not "
                        f"{2 * cfg.superglue.gnn_layers}")
    busy = [k for k, n in launches.items() if k != "attention" and n]
    if busy:
        failures.append(f"multichip: kernels launched that the training step must not run: {busy}")
    del state, sharded, step, pool, batch, ref, got, g_all, g_sp, full, start
    torch.cuda.empty_cache()

    # (b) run_batched_eval on 4 distinct 960x600 sequences, learned then ORB
    seqs = [render_frames(dev, H, W, MULTICHIP_FRAMES, seed=s, speed=0.12 + 0.02 * s) for s in range(MULTICHIP_SEQS)]
    il = torch.stack([q[0] for q in seqs])
    ir = torch.stack([q[1] for q in seqs])
    gt = torch.stack([q[2] for q in seqs])
    rig = seqs[0][3]
    del seqs
    runs = {"learned": (StereoConfig(n_hypotheses=1024, compose_mode="odometry", match_refine_radius=12),
                        learned_frontend(fe)),
            "orb": (orb_cfg, None)}
    record = {}
    for name, (scfg, frontend) in runs.items():
        (results, poses, ok), launches, t_run = drive_path(
            wrappers, lambda: run_batched_eval(il, ir, gt, rig, scfg, mesh, frontend=frontend, frame_batch=FRAME_BATCH,
                                               pair_batch=PAIR_BATCH, with_ok=True))
        launches_by_path[f"multichip_{name}"] = launches
        same = []
        for s in range(MULTICHIP_SEQS):
            g = torch.Generator(device=dev)
            g.manual_seed(sequence_seed(0, s))
            alone = run_stereo_vo_device(il[s], ir[s], rig, scfg, g,
                                         frontend or orb_frontend(scfg.orb, scfg.max_match_distance),
                                         frame_batch=FRAME_BATCH, pair_batch=PAIR_BATCH)
            same.append(bool(np.array_equal(poses[s], alone.pose.double().cpu().numpy())
                             and np.array_equal(ok[s], alone.ok.cpu().numpy())))
        n_pairs = MULTICHIP_FRAMES - 1
        tracked = [int(o.sum()) for o in ok]
        ates = [r.ate_rmse for r in results]
        log(f"multichip: run_batched_eval, {name}, {MULTICHIP_SEQS} sequences of {MULTICHIP_FRAMES} frames at {W}x{H}: "
            f"tracked {tracked} of {n_pairs}, ATE {[round(a, 4) for a in ates]} m; each equal to run_stereo_vo_device "
            f"alone: {same}; {t_run:.3f} s, {MULTICHIP_SEQS / t_run:.3f} sequences/s, "
            f"{MULTICHIP_SEQS * n_pairs / t_run:.2f} pairs/s on {torch.cuda.get_device_name(0)} ({smi}); "
            f"launches {launches}")
        record[name] = dict(tracked=tracked, ate_m=ates, seconds=t_run, sequences_per_s=MULTICHIP_SEQS / t_run,
                            equal_alone=same, launches=launches)
        if not all(same):
            failures.append(f"multichip {name}: a sequence's poses or ok flags differ from run_stereo_vo_device's")
        for s in range(MULTICHIP_SEQS):
            if tracked[s] < MIN_TRACKED * n_pairs or not ates[s] < MAX_ATE_M:
                failures.append(f"multichip {name}: sequence {s} {tracked[s]}/{n_pairs} tracked, ATE {ates[s]} m")
        zero = [k for k in MULTICHIP_KERNELS[name] if launches[k] == 0]
        if zero:
            failures.append(f"multichip {name}: kernels never launched: {zero}")
        if len({round(a, 6) for a in ates}) != MULTICHIP_SEQS:
            failures.append(f"multichip {name}: the sequences' ATEs are not distinct: {ates}")
    del il, ir, gt
    torch.cuda.empty_cache()

    # (c) the dry run, in a process of its own
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.parallel.dryrun", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    t_dry = time.time() - t0
    for line in out.stdout.strip().splitlines():
        print("  " + line, flush=True)
    log(f"multichip: python -m forest_slam_tpu_torch.parallel.dryrun 1 exited {out.returncode} in {t_dry:.1f} s")
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr, flush=True)
        failures.append(f"multichip: the dry run exited {out.returncode}")
    t_all = time.time() - t_phase
    log(f"multichip phase: {t_all:.1f} s on {torch.cuda.get_device_name(0)} ({smi})")
    print(json.dumps({"multichip": {"seconds": t_all, "train_step_s": t_step, "steps_per_s": 1 / t_step,
                                    "update_norm_rel": upd_rel, "agreement": {k: agree[k] for k in (
                                        "rel", "global_cos", "global_rel", "leaf_min_cos", "sp_min_cos")},
                                    "batch_eval": record, "dryrun_s": t_dry}}), flush=True)
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
    from forest_slam_tpu_torch.utils import trace

    with trace.recording() as setup:
        path = _build.build()
    lib = setup.find("fs.setup.kernel_library")[0]
    log(f"build: {os.path.relpath(path, ROOT)} in {lib.host_ms / 1e3:.1f} s (cached={not lib.attrs['built']})")
    for line in _build.last_log.splitlines():
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
    from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select
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
                      lambda: check_attention(dev, gen), lambda: check_pnp_refine(dev, gen)):
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
    trs = att["train_shape"]
    log(f"  attention at the training step's (B, h, K, S) = {tuple(trs['shape'])}: max error {trs['max_abs_err']:.6g} "
        f"of {trs['max_abs_ref']:.4g}, mean {trs['mean_abs_err']:.3g}, fully masked sequence to "
        f"{trs['masked_row_err']:.3g}: {'PASS' if trs['ok'] else 'FAIL'}; {trs['ms']:.4f} ms vs plain "
        f"{trs['plain_ms']:.4f} ms, bound {trs['bound_ms']:.4f} ms by {trs['bound_by']}, scaled_dot_product_attention "
        f"{trs['library_ms']:.4f} ms")
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
    for o in gnn["lightglue"]:
        log(f"  gnn_layer, LightGlue's {o['kind']} block at (N, K, S, D) = {tuple(o['shape'])}"
            f"{' (rotary q/k, GELU)' if o['kind'] == 'self' else ' (q and k from to_qk, GELU)'}, eps 1e-5: largest gap "
            f"{o['max_gap']:.4g}, mean {o['mean_gap']:.3g} of max|plain| (fp8 control {o['control_max_gap']:.4g}, "
            f"{o['control_mean_gap']:.3g}): {'PASS' if o['ok'] else 'FAIL'}; {o['ms']:.4f} ms vs plain "
            f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms by {o['bound_by']} (layer_cost, S once)")
    for name, o in by_name["pnp_refine"]["shapes"].items():
        P, N, minimal, identity, hyps, camera = o["shape"]
        log(f"  pnp_refine, {name}: {P} pairs of {N} points, the {PNP_STARTS} best of {hyps} {minimal} hypotheses"
            f"{' and the identity' if identity else ''}, {camera} camera, {PNP_ITERS} steps: "
            f"{'PASS' if o['agreement']['ok'] else 'FAIL'}; {o['ms']:.4f} ms, {o['back_to_back_ms']:.4f} ms a launch "
            f"back to back; agreement {o['agreement']}")
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
                "attention": attention_forward, "pnp_refine": refine_and_select}
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
    failures += path_failures("ORB", out, tracked, err, launches, ("detect", "sparse_cost", "pnp_refine"))
    if launches["detect"] != N_FRAMES // FRAME_BATCH:  # one launch per frame batch, all levels in it
        failures.append(f"ORB: {launches['detect']} detect launches, not one per frame batch")
    failures += pnp_launch_failures("ORB", launches, n_pairs)
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
                              ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost", "pnp_refine"))
    failures += pnp_launch_failures("learned", launches, n_pairs)
    plain_sp = {"nms_backend": "plain"}
    plain_fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev, superpoint_overrides=plain_sp,
                                     superglue_overrides={"gnn_impl": "plain", "sinkhorn_impl": "plain"})
    plain_cfg = cfg._replace(sparse=cfg.sparse._replace(cost_path="plain"), match_refine_cost_path="plain")
    plain_out, _, t_plain = drive_path(wrappers, run_learned(plain_cfg, learned_frontend(plain_fe)))
    compare("learned", out, plain_out, t_plain)
    del plain_fe

    # SuperPoint + LightGlue (the sp_lightglue.seq962 cell's front end) at K=2048 on the same clip: the
    # configuration's weight draw, both blocks of every layer one fused-layer launch, no Sinkhorn
    failures += lightglue_path(dev, wrappers, launches_by_path, report, lambda f: run_learned(cfg, f), n_pairs)
    torch.cuda.empty_cache()

    # learned path with the unfused GNN: bench.py --sg-gnn xla
    fe_x = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev,
                                 superglue_overrides={"gnn_impl": "xla", "attention_impl": "auto"})
    _, _, t_cold = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_x)))
    log(f"unfused-GNN path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_x)))
    launches_by_path["unfused"] = launches
    tracked, err = report("unfused-GNN", out, t_run, launches)
    failures += path_failures("unfused-GNN", out, tracked, err, launches,
                              ("attention", "select", "sparse_cost", "sinkhorn_decode", "refine_cost", "pnp_refine"),
                              idle_kernels=("gnn_layer",))
    del fe_x
    plain_fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev, superpoint_overrides=plain_sp,
                                     superglue_overrides={"gnn_impl": "xla", "attention_impl": "plain",
                                                          "sinkhorn_impl": "plain"})
    plain_out, _, t_plain = drive_path(wrappers, run_learned(plain_cfg, learned_frontend(plain_fe)))
    compare("unfused-GNN", out, plain_out, t_plain)
    del plain_fe

    # the unfused GNN with the stock library attention: bench.py --sg-gnn xla --sg-attention flash
    fe_f = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device=dev,
                                 superglue_overrides={"gnn_impl": "xla", "attention_impl": "flash"})
    _, _, t_cold = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_f)))
    log(f"flash-attention path warm-up run: {t_cold:.2f} s")
    out, launches, t_run = drive_path(wrappers, run_learned(cfg, learned_frontend(fe_f)))
    launches_by_path["flash"] = launches
    tracked, err = report("unfused-GNN with scaled_dot_product_attention", out, t_run, launches)
    failures += path_failures("flash", out, tracked, err, launches,
                              ("select", "sparse_cost", "sinkhorn_decode", "refine_cost", "pnp_refine"),
                              max_ate=float("inf"),
                              idle_kernels=("gnn_layer", "attention"))
    del fe_f

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
                              ("select", "gnn_layer", "sparse_cost", "sinkhorn_decode", "refine_cost", "pnp_refine"),
                              n_pairs=LOWRES_FRAMES - 1, max_ate=LOWRES_MAX_ATE_M)
    del plain_out, out
    torch.cuda.empty_cache()

    # dense stereo: the reference's SGBM parity path with the flagship front end
    from forest_slam_tpu_torch.stereo.disparity import SgmConfig

    failures += dense_phase(wrappers, launches_by_path, smi, run_learned(cfg._replace(dense_depth=True, sgm=SgmConfig()),
                                                                         frontend), report, il, ir)
    torch.cuda.empty_cache()

    # monocular VO: forest-slam mono on the left frames, ORB and learned, parity and odometry
    failures += mono_phase(wrappers, launches_by_path, smi, il, gt, rig, fe)

    # bench.py's 962-pair workload, learned then ORB
    records, timed_workloads = {}, {}
    for kind, n_timed, path_kernels in (("sp", 3, ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode",
                                                   "refine_cost", "pnp_refine")),
                                        ("orb", 1, ("detect", "sparse_cost", "pnp_refine"))):
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
        # the bench's roofline, as python -m forest_slam_tpu_torch.bench runs it; its device-time
        # cross-check comes at the end (a torch.profiler window slows this process's later runs)
        roof = bench.roofline_record(wl, float(np.median(times)), dev)
        rec.update({k: roof[k] for k in ("mfu", "hbm_frac", "roofline_frac", "bytes_accounting")})
        records[name], timed_workloads[name] = rec, wl
        log(f"{name}: {rec['value']} pairs/s (median of {len(times)} runs {rec['runs_s']} s, spread "
            f"{rec['run_spread']}), {rec['ok_frames']}/{rec['n_frames']} pairs tracked, ATE {rec['ate_rmse']} m, "
            f"RPE {rec['rpe']['rmse_pct']} % over {rec['rpe']['delta_m']} m ({rec['rpe']['n']} pairs); mfu "
            f"{rec['mfu']}, hbm_frac {rec['hbm_frac']}, roofline_frac {rec['roofline_frac']} "
            f"({roof['summary']['total_flops'] / 1e12:.3f} TFLOP, {roof['summary']['total_bytes'] / 1e9:.3f} GB), on "
            f"{torch.cuda.get_device_name(0)} ({smi}); launches {launches}")
        failures += path_failures(name, out, rec["ok_frames"], rec["ate_rmse"], launches, path_kernels,
                                  n_pairs=rec["n_frames"], max_ate=BENCH_MAX_ATE_M)
        bad = [k for k in ("mfu", "hbm_frac", "roofline_frac") if rec[k] is None or not 0 < rec[k] <= 1]
        if bad:
            failures.append(f"{name}: roofline shares not in (0, 1]: {bad}")
        if kind == "sp":
            # the chunked runner (bench.py --runner chunked) on the same workload: the device runner's poses
            chunked, launches, t_chunked = drive_path(wrappers, wl.runs["chunked"])
            launches_by_path["bench_learned_chunked"] = launches
            same = torch.equal(chunked.pose, out.pose) and torch.equal(chunked.ok, out.ok)
            log(f"{name} through the chunked runner (frame_indices, each chunk gathered): {t_chunked:.3f} s, "
                f"{rec['n_frames'] / t_chunked:.2f} pairs/s; poses and ok flags equal to the device runner's: {same}; "
                f"launches {launches}")
            if not same:
                failures.append(f"{name}: the chunked runner's poses or ok flags differ from the device runner's")
            failures += path_failures(f"{name} chunked", chunked, int(chunked.ok.sum().item()), rec["ate_rmse"],
                                      launches, path_kernels, n_pairs=rec["n_frames"], max_ate=BENCH_MAX_ATE_M)
            del chunked
            err, _ = bench.trajectory_errors(out.pose, wl.truth)
            learned_workload = (wl, dict(tracked=rec["ok_frames"], ate_m=err.rmse, seconds=float(np.median(times)),
                                         pairs_per_s=rec["n_frames"] / float(np.median(times))))
        del wl, out
        torch.cuda.empty_cache()
    failures += bench_cli_phase(smi)

    # the back end: loop closure, relocalization, the workload with BA and SLAM, the sequential runners
    failures += slam_phase(dev, wrappers, launches_by_path, smi, fe, (il, ir, gt, rig), learned_workload)
    del learned_workload
    torch.cuda.empty_cache()

    # bag input: a BotanicGarden-shaped 960x600 bag through the CLI
    failures += bag_phase(dev, wrappers, launches_by_path, smi)
    torch.cuda.empty_cache()

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
    zero = [k for k in ("select", "sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost", "pnp_refine")
            if launches[k] == 0]
    if zero:
        failures.append(f"gates: kernels never launched: {zero}")
    print(json.dumps({"gates": gates, "gate_failures": gate_failures or None, "not_run": not_run}), flush=True)
    torch.cuda.empty_cache()

    # the training path: python -m forest_slam_tpu_torch.train's recipe at full width
    failures += train_phase(dev, wrappers, launches_by_path, smi)
    torch.cuda.empty_cache()

    # multi-GPU on one card: the sharded train step, batched multi-sequence evaluation, the dry run
    failures += multichip_phase(dev, wrappers, launches_by_path, smi, fe, orb_cfg)
    torch.cuda.empty_cache()

    # distillation: python -m forest_slam_tpu_torch.train.distill's round-5 recipe at full width
    def track_clip(f):
        out = run_learned(cfg, f)()
        return int(out.ok.sum().item()), n_pairs, ate(out.pose, gt)

    failures += distill_phase(dev, wrappers, launches_by_path, smi, track_clip)

    # the 962-pair workloads' device-time cross-check (bench.cross_check), last: a torch.profiler window slows
    # this process's later host-bound runs (ORB 1.438 -> 1.674 s a run, training and distillation too)
    for name, wl in timed_workloads.items():
        rec = records[name]
        rec["device_pairs_per_sec"] = bench.cross_check(wl, rec["value"])
        log(f"{name}: device_pairs_per_sec {rec['device_pairs_per_sec']} (wall {rec['value']} pairs/s), mfu "
            f"{rec['mfu']}, hbm_frac {rec['hbm_frac']}, roofline_frac {rec['roofline_frac']}, on "
            f"{torch.cuda.get_device_name(0)} ({smi})")
        if not rec["device_pairs_per_sec"]:
            failures.append(f"{name}: no device_pairs_per_sec")
    del timed_workloads
    print(json.dumps({"bench": records}), flush=True)

    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
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
