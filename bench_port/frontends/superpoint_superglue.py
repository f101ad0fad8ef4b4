"""SuperPoint + SuperGlue (arXiv:1712.07629, arXiv:1911.11763) from the
configuration's checkpoint file, which each side reads itself: the port
through its own loader, the reference through its own msgpack reader."""

from __future__ import annotations

import os

import torch

from bench_port import roofline
from bench_port.reference import superglue, superpoint
from bench_port.reference.msgpack import read_checkpoint

compares_obs = True  # refinement runs, so the refined observations are compared


def keypoints(cfg: dict) -> int:
    return cfg["max_keypoints"]


def weights(cfg: dict, root: str, seed: int, device):
    return None  # both sides read the checkpoint


def program(cfg: dict, stereo_cfg, inputs: dict, root: str, device):
    """The port's front end from the checkpoint, refused where the
    checkpoint does not run the configuration's settings."""
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend

    H, W = inputs["left"].shape[-2:]
    fe = load_learned_frontend(os.path.join(root, cfg["checkpoint"]), (H, W), cfg["max_keypoints"], device=device)
    got = dict(stem_stride=fe.cfg.superpoint.stem_stride, gnn_layers=fe.cfg.superglue.gnn_layers,
               sinkhorn_iterations=fe.cfg.superglue.sinkhorn_iterations,
               num_heads=fe.cfg.superglue.num_heads, descriptor_dim=fe.cfg.superglue.descriptor_dim)
    wrong = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if wrong:
        raise ValueError(f"the checkpoint does not run the configuration: {wrong} (loaded, configured)")
    return learned_frontend(fe)


def reference_load(cfg: dict, inputs: dict, device) -> dict:
    _, tree = read_checkpoint(os.path.join(inputs["root"], cfg["checkpoint"]))
    sg = tree["superglue"]["params"]
    n_layers = sum(1 for k in sg if k.startswith("self_"))
    return dict(sp=superpoint.load_weights(tree["superpoint"]["params"], device),
                sg=superglue.load_weights(sg, n_layers, device))


def reference_extract(images, net: dict, cfg: dict, prec):
    return superpoint.extract(images, net["sp"], cfg, prec)


def reference_match(a: dict, b: dict, net: dict, cfg: dict, image_shape, prec):
    return superglue.match(a, b, net["sg"], cfg, image_shape, prec)


def slot_groups(cfg: dict, K: int):
    return torch.zeros(K, dtype=torch.long)


def desc_gap(prog, ref) -> float:
    """Mean L2 distance of the unit descriptors of the keypoints both sides
    found."""
    d = prog.float() - ref.float()
    return float(torch.linalg.vector_norm(d, dim=-1).mean()) if d.numel() else 0.0


# ------------------------------------------------------------- roofline


def superpoint_convs(cfg: dict, H: int, W: int) -> list:
    """(c_in, c_out, k, h, w) of each SuperPoint convolution on one image."""
    s = cfg["stem_stride"]
    c1, c2, c3, c4 = cfg["channels"]
    h, w = H // s, W // s
    n_pools = 3 - {1: 0, 2: 1, 4: 2, 8: 3}[s]
    io = ((s * s, c1), (c1, c1), (c1, c2), (c2, c2), (c2, c3), (c3, c3), (c3, c4), (c4, c4))
    out = []
    for blk in range(4):
        out += [(ci, co, 3, h, w) for ci, co in io[2 * blk:2 * blk + 2]]
        if blk < n_pools:
            h, w = h // 2, w // 2
    return out + [(c4, 256, 3, h, w), (256, 65, 1, h, w), (c4, 256, 3, h, w), (256, cfg["descriptor_dim"], 1, h, w)]


def superglue_flops(cfg: dict, K: int) -> int:
    """One pair through SuperGlue: encoder, 4 layer-applies a layer index,
    projection, scores, softmax and LayerNorm work, Sinkhorn."""
    D, L, h = cfg["descriptor_dim"], cfg["gnn_layers"], cfg["num_heads"]
    dims = (3,) + tuple(cfg["keypoint_encoder_dims"]) + (D,)
    kenc = 2 * K * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    apply = 2 * (K + 2 * K) * D * D + 2 * K * D * D + 12 * K * D * D + 4 * K * K * D
    matrix = 2 * kenc + 4 * L * apply + 2 * 2 * K * D * D + 2 * K * K * D
    return matrix + 4 * L * (12 * K * K * h + 20 * K * D) + cfg["sinkhorn_iterations"] * 2 * K * K * 6


def superglue_weight_bytes(cfg: dict) -> int:
    D = cfg["descriptor_dim"]
    dims = (3,) + tuple(cfg["keypoint_encoder_dims"]) + (D,)
    dense = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + D * D + D
    return 2 * dense + 2 * cfg["gnn_layers"] * roofline.gnn_layer_weight_bytes(D) + 4


def costs(H: int, W: int, cfg: dict):
    """(frame FLOPs, pair FLOPs, bytes of a keypoint slot, extract weight
    bytes, pair weight bytes): SuperPoint's convolutions and selection a
    frame, SuperGlue a pair, each network's bf16 weights."""
    frame_flops = sum(2 * ci * co * k * k * h * w for ci, co, k, h, w in superpoint_convs(cfg, H, W))
    frame_flops += (4 * cfg["nms_radius"] + 4) * H * W
    s8 = 8 * cfg["stem_stride"]
    ex_w = sum(2 * (ci * co * k * k + co) for ci, co, k, _, _ in superpoint_convs(cfg, s8, s8))
    return (frame_flops, superglue_flops(cfg, keypoints(cfg)), 8 + 4 + 4 * cfg["descriptor_dim"] + 1, ex_w,
            superglue_weight_bytes(cfg))
