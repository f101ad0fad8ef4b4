"""csrc/detect.cu's share of its roofline, in percent: the least time of each launch
(roofline.detect_cost: the data-gated float32 operations counted on the
chunk's pyramid levels over the float32 peak, or the levels' bytes over
HBM's rate) summed over the profiled launches, over the kernel's device
time. A launch detects every level of one frame chunk; read only where the
profiled launches are the ones the chunks imply."""

import torch


def read(ctx):
    t, cfg, tr, peaks = ctx["trace"], ctx["config"], ctx["traffic"], ctx["peaks"]
    if peaks is None or "detect_levels_kernel" not in t["kernels"]:
        return None
    from bench_port.reference.orb import pyramid

    rl = ctx["roofline"]
    orb = cfg["orb"]
    M, fc = tr["n_frames"], tr["frame_chunk"]
    chunks = [(s, min(s + fc, M)) for s in range(0, M, fc)]
    launches, device_s = t["kernels"]["detect_levels_kernel"]
    if launches != len(chunks) * t["sequences"]:
        return None
    left = ctx["inputs"]["left_u"]
    ops_u = torch.zeros(left.shape[0], dtype=torch.float64)
    for u in range(left.shape[0]):
        ops_u[u] = sum(rl.detect_ops(lv, orb["fast_threshold"], orb["edge_margin"])
                       for lv in pyramid(left[u:u + 1], orb))
    index = ctx["inputs"]["index"].cpu()
    shapes = [lv.shape[1:] for lv in pyramid(left[:1], orb)]
    bound = 0.0
    for s, e in chunks:
        cost = rl.detect_cost([(e - s, h, w) for h, w in shapes], float(ops_u[index[s:e]].sum()))
        bound += rl.bound_seconds(cost, peaks["f32"], peaks["hbm"])
    return 100.0 * bound * t["sequences"] / device_s
