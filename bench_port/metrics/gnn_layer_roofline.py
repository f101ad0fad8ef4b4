"""csrc/gnn_layer.cu's share of its roofline, in percent: the least time of each launch
(roofline.gnn_layer_cost at its shape, operations over the bf16 peak or
bytes over HBM's rate) summed over the profiled launches, over the device
time of the kernels one launch runs (its GEMMs, attention and LayerNorm).
A launch is one GNN layer on the 2P sequences of a pair chunk of P pairs;
read only where the profiled launches are the ones the chunks imply."""

KERNELS = ("gemm_kernel", "gnn_attention_kernel", "layernorm_relu_kernel")


def read(ctx):
    t, cfg, tr, peaks = ctx["trace"], ctx["config"], ctx["traffic"], ctx["peaks"]
    if peaks is None or "gnn_attention_kernel" not in t["kernels"]:
        return None
    rl = ctx["roofline"]
    n_pairs, pc = tr["n_frames"] - 1, tr["pair_chunk"]
    chunks = [min(pc, n_pairs - s) for s in range(0, n_pairs, pc)]
    per_seq = 2 * cfg["gnn_layers"]
    if t["kernels"]["gnn_attention_kernel"][0] != per_seq * len(chunks) * t["sequences"]:
        return None
    K, D = cfg["max_keypoints"], cfg["descriptor_dim"]
    wb = rl.gnn_layer_weight_bytes(D)
    bound = sum(per_seq * rl.bound_seconds(rl.gnn_layer_cost(2 * p, K, K, D, wb), peaks["bf16"], peaks["hbm"])
                for p in chunks) * t["sequences"]
    device = sum(t["kernels"][k][1] for k in KERNELS if k in t["kernels"])
    return 100.0 * bound / device
