"""csrc/gnn_layer.cu's share of its roofline on LightGlue's blocks, in
percent: the least time of each launch (the front end's ``layer_cost``:
the block's published operations, S once a cross block, over the bf16 peak,
or its bytes over HBM's rate) summed over the profiled launches, over the
device time of the kernels one launch runs (its GEMMs with and without the
rotary epilogue, attention and LayerNorm + GELU). A launch is one self or
one cross block on the 2P sequences of a pair chunk of P pairs; read only
where the profiled launches are the ones the chunks imply."""

KERNELS = ("gemm_kernel", "gnn_attention_kernel", "layernorm_gelu_kernel")


def read(ctx):
    t, cfg, tr, peaks, fe = ctx["trace"], ctx["config"], ctx["traffic"], ctx["peaks"], ctx["frontend"]
    if peaks is None or "layernorm_gelu_kernel" not in t["kernels"] or not hasattr(fe, "layer_cost"):
        return None
    rl = ctx["roofline"]
    n_pairs, pc = tr["n_frames"] - 1, tr["pair_chunk"]
    chunks = [min(pc, n_pairs - s) for s in range(0, n_pairs, pc)]
    L = cfg["lightglue_layers"]
    if t["kernels"]["gnn_attention_kernel"][0] != 2 * L * len(chunks) * t["sequences"]:
        return None
    K, D, h = cfg["max_keypoints"], cfg["descriptor_dim"], cfg["num_heads"]
    bound = sum(L * rl.bound_seconds(fe.layer_cost(kind, p, K, D, h), peaks["bf16"], peaks["hbm"])
                for p in chunks for kind in ("self", "cross")) * t["sequences"]
    device = sum(t["kernels"][k][1] for k in KERNELS if k in t["kernels"])
    return 100.0 * bound / device
