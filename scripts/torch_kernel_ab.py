#!/usr/bin/env python3
"""Time the attention, fused GNN-layer and Sinkhorn kernels of one checkout on one GPU.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--sinkhorn-clusters 8,12,16]

imports ``forest_slam_tpu_torch`` from ``DIR`` (default: this repository),
builds its kernels, and times ``attention_forward`` at (16, 4, 1024, 64)
beside ``scaled_dot_product_attention``, ``gnn_layer`` (the flagship
checkpoint's first cross layer) at 16 sequences of 1024 x 256 and at the
lowres gate's 48 of 512 x 256, and ``sinkhorn_decode`` (20 iterations, the
flagship's dustbin score) at (8, 1024, 1024) and at the lowres gate's (23,
512, 512). The inputs and the check against the plain versions are
``chip_smoke.py``'s (``attention_case``, ``gnn_case``, ``sinkhorn_case``),
loaded from this repository whatever ``DIR`` is, so both checkouts get the
same inputs and the same tolerances. ``--sinkhorn-clusters`` also times the
Sinkhorn kernel with each of the given cluster sizes forced, at both shapes
(checkouts whose wrapper has ``_launch(..., cluster)``). Each time is the median of 7 CUDA-event
timings of 20 launches each, after a warm-up, so it leaves out the gaps
between launches that ``chip_smoke.py``'s one launch per event pair holds.
The last line of its output is one JSON object with the times, whether each
kernel was within its tolerance, the card's name and its power limit.

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


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--sinkhorn-clusters", default="", help="comma-separated cluster sizes to force")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    clusters = [int(c) for c in opts.sinkhorn_clusters.split(",") if c]
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    from forest_slam_tpu_torch import _build
    from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward
    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer
    from forest_slam_tpu_torch.frontend.sinkhorn_kernel import sinkhorn_decode
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend

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
    ws, heads = layer.weights(), layer.num_heads

    def timed(fn):
        return smoke.time_ms(fn, reps=7, launches=20)

    out = {"label": os.path.relpath(root), "device": smoke.nvidia_smi_line()}
    with torch.no_grad():
        shape = (2 * smoke.PAIR_BATCH, smoke.HEADS, smoke.K, smoke.K)
        *_, ok, _, (q, k, v, mask, scale) = smoke.attention_case(dev, gen, shape)
        amask = mask[:, None, None, :]
        out["attention_ok"] = ok
        out["attention_ms"] = timed(lambda: attention_forward(q, k, v, mask, scale))
        out["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask, scale=scale))
        for name, (N, L) in (("gnn_layer", (2 * smoke.PAIR_BATCH, smoke.K)),
                             ("gnn_layer_lowres", (2 * smoke.LOWRES_FRAMES, smoke.LOWRES_K))):
            *_, ok, (x, src, m) = smoke.gnn_case(dev, gen, ws, heads, N, L, L, False)
            out[f"{name}_ok"] = ok
            out[f"{name}_ms"] = timed(lambda: gnn_layer(x, src, m, ws, heads))
        iters = fe.cfg.superglue.sinkhorn_iterations
        for name, shape in (("sinkhorn", smoke.SINKHORN_SHAPES[0]), ("sinkhorn_lowres", smoke.SINKHORN_SHAPES[1])):
            *_, ok, args = smoke.sinkhorn_case(dev, gen, shape, fe.superglue.bin_score, iters)
            out[f"{name}_ok"] = ok
            out[f"{name}_ms"] = timed(lambda: sinkhorn_decode(*args))
            if clusters:
                from forest_slam_tpu_torch.frontend.sinkhorn_kernel import _launch, launch_plan

                out[f"{name}_by_cluster"] = {
                    c: dict(launch_plan(*shape[:3], dev, c), ms=timed(lambda: _launch(*args, cluster=c)))
                    for c in clusters}
    ok = all(v for k, v in out.items() if k.endswith("_ok"))
    print(f"{out['label']}: attention {out['attention_ms']:.4f} ms (sdpa {out['sdpa_ms']:.4f} ms), gnn_layer "
          f"{out['gnn_layer_ms']:.4f} ms, lowres {out['gnn_layer_lowres_ms']:.4f} ms, sinkhorn_decode "
          f"{out['sinkhorn_ms']:.4f} ms, lowres {out['sinkhorn_lowres_ms']:.4f} ms on {out['device']}; within "
          f"tolerance: {ok}", flush=True)
    for name in ("sinkhorn", "sinkhorn_lowres"):
        for c, r in out.get(f"{name}_by_cluster", {}).items():
            print(f"  {name} with clusters of {c}: {r['ms']:.4f} ms ({r['rows_per_cta']} rows per CTA, "
                  f"{r['smem_rows']} in shared memory, {r['l2_rows']} in L2, {r['active_clusters']} clusters "
                  f"active, {r['waves']} wave(s))", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
