#!/usr/bin/env python3
"""Time the port's kernels of one checkout on one GPU.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--kernels detect,refine_cost] [--sinkhorn-clusters 8,12,16]

imports ``forest_slam_tpu_torch`` from ``DIR`` (default: this repository),
builds its kernels, and times, at ``chip_smoke.py``'s shapes and on its
inputs: ``attention_forward`` at (16, 4, 1024, 64) beside
``scaled_dot_product_attention``; ``gnn_layer`` (the flagship checkpoint's
first cross layer) at 16 sequences of 1024 x 256 and at the lowres gate's 48
of 512 x 256; ``sinkhorn_decode`` (20 iterations, the flagship's dustbin
score) at (8, 1024, 1024) and at the lowres gate's (23, 512, 512);
detection over the eight pyramid levels of a batch of 8 960x600 frames (one
``detect_pooled_levels`` call where the checkout has it, else eight
``detect_pooled`` calls), on random levels and on the levels of 8 rendered
corridor frames; ``refine_cost_volume`` at 8 pairs of K=1024 at 960x600 and
the lowres gate's 23 pairs of K=512; ``sparse_cost_rows`` (D=96, w=7) at
the ORB path's 8 frames of K=512 and the learned paths' 8 of K=1024 at
960x600 and the lowres gate's 24 of K=512 at 224x160; ``nms_block_max`` at 8
960x600 heat maps and the lowres gate's three octaves of 24; and, when
named in ``--kernels`` (checkouts from the one that added it),
``refine_and_select`` (PnP-RANSAC's refine-and-select stage) at the learned
chunk's 48 pairs of K=1024, with its plain version's times beside it. The case
functions (inputs and the check against the plain versions) are
``chip_smoke.py``'s, loaded from this repository whatever ``DIR`` is, so
both checkouts get the same inputs and the same tolerances.

Two times per kernel and call: ``ms``, the median of 7 CUDA-event timings of
20 calls back to back, after a warm-up (it holds the gaps between launches
where the host enqueues more slowly than the card runs a small kernel), and
``device_ms``, the device time ``torch.profiler`` records over 20 calls
(``forest_slam_tpu_torch.bench.device_ms`` of this repository),
divided by 20 (the median of three such windows). ``--sinkhorn-clusters``
also times the Sinkhorn kernel with each of the given cluster sizes forced
(checkouts whose wrapper has ``_launch(..., cluster)``). ``--kernels``
times only the named kernels (attention, gnn_layer, sinkhorn_decode, detect,
refine_cost, sparse_cost, select, pnp_refine; default all but pnp_refine). The last line of
its output is one JSON object with the times, whether each kernel was within
its tolerance, the card's name and its power limit.

To compare two versions of the kernels on one card, run it in turns within
one command, one process per run, for example with the parent commit's
package unpacked into a gitignored directory (``git archive``):

    for r in _smoke_checkout/parent . . _smoke_checkout/parent; do
        python3 scripts/torch_kernel_ab.py --root $r; done

Only the public wrappers are called, so any checkout whose wrappers have
these signatures can be timed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_chip_smoke():
    """This repository's chip_smoke.py, with this repository's kernel cost
    formulas (utils/roofline.py, which it imports) whatever checkout the
    kernels come from."""
    sys.modules["forest_slam_tpu_torch.utils.roofline"] = load_file(
        "forest_slam_tpu_torch.utils.roofline", os.path.join(REPO, "forest_slam_tpu_torch", "utils", "roofline.py"))
    return load_file("chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--kernels", default="attention,gnn_layer,sinkhorn_decode,detect,refine_cost,sparse_cost,select",
                    help="comma-separated kernels to time")
    ap.add_argument("--sinkhorn-clusters", default="", help="comma-separated cluster sizes to force")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    clusters = [int(c) for c in opts.sinkhorn_clusters.split(",") if c]
    kernels = set(opts.kernels.split(","))
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    # the device timer of this repository's bench (it imports only numpy and torch at module level)
    device_ms = load_file("bench_timing", os.path.join(REPO, "forest_slam_tpu_torch", "bench.py")).device_ms
    from forest_slam_tpu_torch import _build
    from forest_slam_tpu_torch.frontend import detect_kernel
    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer
    from forest_slam_tpu_torch.frontend.refine_kernel import refine_cost_volume
    from forest_slam_tpu_torch.frontend.select_kernel import nms_block_max
    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import sinkhorn_decode
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows

    if not _build.__file__.startswith(root):
        print(f"FAIL: imported {_build.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the checkpoint of this repository, so a checkout of the package alone can be timed
    fe = load_learned_frontend(os.path.join(REPO, "weights", os.path.basename(FLAGSHIP_PATH)), (smoke.H, smoke.W),
                               smoke.K, device=dev)
    layer = fe.superglue.layers["cross_0"]
    with torch.no_grad():  # the cached bf16 copies, as inference takes them
        ws, heads = layer.weights(), layer.num_heads

    out = {"label": os.path.relpath(root), "device": smoke.nvidia_smi_line(), "kernels": {}}

    def timed(name, ok, fn, **extra):
        out["kernels"][name] = dict(ok=bool(ok), ms=smoke.time_ms(fn, reps=7, launches=20),
                                    device_ms=device_ms(fn, calls=20), **extra)

    def detect_call(levels, args):
        if hasattr(detect_kernel, "detect_pooled_levels"):
            return lambda: detect_kernel.detect_pooled_levels(levels, *args)
        return lambda: [detect_kernel.detect_pooled(lv, *args) for lv in levels]

    with torch.no_grad():
        if "attention" in kernels:
            shape = (2 * smoke.PAIR_BATCH, smoke.HEADS, smoke.K, smoke.K)
            *_, ok, _, (q, k, v, mask, scale) = smoke.attention_case(dev, gen, shape)
            amask = mask[:, None, None, :]
            timed("attention", ok, lambda: attention_forward(q, k, v, mask, scale))
            timed("sdpa", True, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale))
        if "gnn_layer" in kernels:
            for name, (N, L) in (("gnn_layer", (2 * smoke.PAIR_BATCH, smoke.K)),
                                 ("gnn_layer_lowres", (2 * smoke.LOWRES_FRAMES, smoke.LOWRES_K)),
                                 ("gnn_layer_bench", (2 * smoke.BENCH_PAIRS, smoke.K))):
                *_, ok, (x, src, m) = smoke.gnn_case(dev, gen, ws, heads, N, L, L, False)
                timed(name, ok, lambda: gnn_layer(x, src, m, ws, heads))
        if "sinkhorn_decode" in kernels:
            iters = fe.cfg.superglue.sinkhorn_iterations
            named = [("sinkhorn", smoke.SINKHORN_SHAPES[0]), ("sinkhorn_lowres", smoke.SINKHORN_SHAPES[1])]
            named += [(f"sinkhorn {sh[0]}x{sh[1]}x{sh[2]}", sh) for sh in smoke.SINKHORN_SHAPES[3:]]
            for name, shape in named:
                *_, ok, args = smoke.sinkhorn_case(dev, gen, shape, fe.superglue.bin_score, iters)
                timed(name, ok, lambda: sinkhorn_decode(*args))
                if clusters:
                    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import _launch, launch_plan

                    out["kernels"][name]["by_cluster"] = {
                        c: dict(launch_plan(*shape[:3], dev, c), ms=smoke.time_ms(lambda: _launch(*args, cluster=c),
                                                                                 reps=7, launches=20))
                        for c in clusters}
        if "detect" in kernels:
            levels, dargs = smoke.detect_case(dev, gen)
            plain = [detect_kernel.detect_pooled_plain(lv, *dargs) for lv in levels]
            ok = all(smoke.detect_agreement(detect_call(levels, dargs)(), plain)[1:4])
            timed("detect", ok, detect_call(levels, dargs))
            big, _ = smoke.detect_case(dev, gen, smoke.BENCH_FRAMES)
            plain = [detect_kernel.detect_pooled_plain(lv, *dargs) for lv in big]
            ok = all(smoke.detect_agreement(detect_call(big, dargs)(), plain)[1:4])
            timed(f"detect {smoke.BENCH_FRAMES} frames", ok, detect_call(big, dargs))
            # the same launch on the levels of rendered frames, where FAST
            # fires far less often than on noise
            il = smoke.render_frames(dev, smoke.H, smoke.W, smoke.FRAME_BATCH)[0].contiguous()
            from forest_slam_tpu_torch.frontend.orb import OrbConfig, _level_geometry
            from forest_slam_tpu_torch.utils.filters import resize_bilinear

            frames = [il]
            for h, w, _ in _level_geometry(smoke.H, smoke.W, OrbConfig())[0][1:]:
                frames.append(resize_bilinear(frames[-1], h, w).contiguous())
            plain = [detect_kernel.detect_pooled_plain(lv, *dargs) for lv in frames]
            ok = all(smoke.detect_agreement(detect_call(frames, dargs)(), plain)[1:4])
            timed("detect_rendered", ok, detect_call(frames, dargs), corners=corner_shares(frames, dargs))
        if "refine_cost" in kernels:
            names = ["refine_cost", "refine_cost_lowres"] + [
                "refine_cost {}x{} R{} frame0 {}x{}".format(sh[0], sh[5], sh[6], sh[2], sh[1])
                for sh in smoke.REFINE_SHAPES[2:]]
            for name, shape in zip(names, smoke.REFINE_SHAPES):
                _, ok, _, args = smoke.refine_case(dev, gen, shape)
                timed(name, ok, lambda: refine_cost_volume(*args))
        if "sparse_cost" in kernels:
            for shape in smoke.SPARSE_SHAPES:
                _, ok, _, args = smoke.sparse_case(dev, gen, shape)
                B, H, W, K = shape
                timed(f"sparse_cost {B}x{K} at {W}x{H}", ok, lambda: sparse_cost_rows(*args))
        if "select" in kernels:
            for shape in smoke.select_shapes():
                ok, _, _, heat = smoke.select_case(dev, gen, shape)
                timed("select {}x{}x{}".format(*shape), ok, lambda: nms_block_max(heat))
        if "pnp_refine" in kernels:
            from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select, refine_and_select_plain

            P, N, minimal, identity, hyps, camera = smoke.PNP_SHAPES[smoke.PNP_LEARNED]
            args = smoke.pnp_stage_args(dev, P, N, minimal, identity, n_hypotheses=hyps, camera=camera)
            agree = smoke.pnp_refine_agreement(refine_and_select(*args), args)
            timed("pnp_refine", agree["ok"], lambda: refine_and_select(*args))
            timed("pnp_refine plain", True, lambda: refine_and_select_plain(*args))
    ok = all(r["ok"] for r in out["kernels"].values())
    print(f"{out['label']} on {out['device']}; within tolerance: {ok}", flush=True)
    for name, r in out["kernels"].items():
        print(f"  {name}: {r['ms']:.4f} ms back to back, {r['device_ms']:.4f} ms device time a call"
              + ("" if r["ok"] else " OUT OF TOLERANCE"), flush=True)
        for c, rc in r.get("by_cluster", {}).items():
            print(f"    clusters of {c}: {rc['ms']:.4f} ms ({rc['rows_per_cta']} rows per CTA, "
                  f"{rc['smem_rows']} in shared memory, {rc['l2_rows']} in L2, {rc['active_clusters']} clusters "
                  f"active, {rc['waves']} wave(s))", flush=True)
    if "detect_rendered" in out["kernels"]:
        print(f"  rendered levels: {out['kernels']['detect_rendered']['corners']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def corner_shares(levels, args):
    """Over all levels: the share of pixels inside the margin that are FAST
    corners, and the shares of 32x32 tiles and of rows that hold one."""
    import torch
    import torch.nn.functional as F

    from forest_slam_tpu_torch.frontend.fast import fast_score_map, interior_mask

    threshold, _, margin = args
    n = dict(pixels=0, corners=0, rows=0, corner_rows=0, tiles=0, corner_tiles=0)
    for lv in levels:
        B, h, w = lv.shape
        inside = interior_mask(h, w, margin, lv.device)
        corners = (fast_score_map(lv, threshold) > 0) & inside
        tiles = F.max_pool2d(corners.float()[:, None], 32, ceil_mode=True)
        n["pixels"] += B * int(inside.sum())
        n["corners"] += int(corners.sum())
        n["rows"] += B * h
        n["corner_rows"] += int(corners.any(-1).sum())
        n["tiles"] += tiles.numel()
        n["corner_tiles"] += int(tiles.sum())
    return dict(corner_share=n["corners"] / n["pixels"], row_share=n["corner_rows"] / n["rows"],
                tile_share=n["corner_tiles"] / n["tiles"])


if __name__ == "__main__":
    sys.exit(main())
