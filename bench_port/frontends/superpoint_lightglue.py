"""SuperPoint (arXiv:1712.07629) from the configuration's checkpoint, which
each side reads itself, and LightGlue (arXiv:2306.13643) with weights drawn
from the seed: the repository holds no trained LightGlue, and none can be
fetched.

The draw (``weights``), in LightGlue's state-dict layout, all float32 from
one generator of its own seeded from ``--seed``: ``posenc.Wr`` ~ N(0, 1)
(the published init, gamma 1); every other Linear nn.Linear's default
U(+-1/sqrt(fan_in)) for weight and bias, LayerNorm weight 1 and bias 0;
each FFN's last Linear (weight and bias) times ``residual_scale``;
``final_proj`` ``assign_scale`` times the orthogonal factor of a seeded
D x D Gaussian, bias 0; ``matchability`` the default weight and a bias of
``matchability_bias``. The three numbers are the configuration's
``assumed``. They change values only, so every operation of the model runs;
at nn.Linear's default init LightGlue at 2048 keypoints matches nothing
(both softmaxes are nearly flat), and with these the matches are the mutual
nearest neighbours of the descriptors carried through the layers, so the
odometry tracks and the check compares real matches."""

from __future__ import annotations

import os

import torch

from bench_port import manifest, roofline
from bench_port.reference import lightglue, superpoint
from bench_port.reference.msgpack import read_checkpoint

_sp = manifest.frontend("superpoint_superglue")
reference_extract, slot_groups, desc_gap = _sp.reference_extract, _sp.slot_groups, _sp.desc_gap
compares_obs = True  # refinement runs, so the refined observations are compared


def keypoints(cfg: dict) -> int:
    return cfg["max_keypoints"]


def weights(cfg: dict, root: str, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, L, h = cfg["descriptor_dim"], cfg["lightglue_layers"], cfg["num_heads"]
    a = cfg["assumed"]
    sd = {"posenc.Wr.weight": torch.randn((D // h // 2, 2), generator=gen, device=device)}

    def uniform(shape, fan_in):
        return (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) / fan_in ** 0.5

    def linear(name, n_out, n_in, scale=1.0):
        sd[name + ".weight"] = uniform((n_out, n_in), n_in) * scale
        sd[name + ".bias"] = uniform((n_out,), n_in) * scale

    def ffn(prefix):
        linear(prefix + "0", 2 * D, 2 * D)
        sd[prefix + "1.weight"] = torch.ones(2 * D, device=device)
        sd[prefix + "1.bias"] = torch.zeros(2 * D, device=device)
        linear(prefix + "3", D, 2 * D, a["residual_scale"])

    for i in range(L):
        pre = f"transformers.{i}.self_attn."
        linear(pre + "Wqkv", 3 * D, D)
        linear(pre + "out_proj", D, D)
        ffn(pre + "ffn.")
        pre = f"transformers.{i}.cross_attn."
        for name in ("to_qk", "to_v", "to_out"):
            linear(pre + name, D, D)
        ffn(pre + "ffn.")
    pre = f"log_assignment.{L - 1}."
    q, _ = torch.linalg.qr(torch.randn((D, D), generator=gen, device=device))
    sd[pre + "final_proj.weight"] = a["assign_scale"] * q
    sd[pre + "final_proj.bias"] = torch.zeros(D, device=device)
    linear(pre + "matchability", 1, D)
    sd[pre + "matchability.bias"] = torch.full((1,), float(a["matchability_bias"]), device=device)
    return sd


def program(cfg: dict, stereo_cfg, inputs: dict, root: str, device):
    """The port's front end: SuperPoint from the checkpoint at the
    configuration's keypoint budget, LightGlue from the drawn weights;
    refused where either does not run the configuration's settings."""
    from forest_slam_tpu_torch.frontend.base import lightglue_frontend
    from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend

    H, W = inputs["left"].shape[-2:]
    sp = load_learned_frontend(os.path.join(root, cfg["checkpoint"]), (H, W), cfg["max_keypoints"], device=device)
    lg = LightGlue(LightGlueConfig(descriptor_dim=cfg["descriptor_dim"], n_layers=cfg["lightglue_layers"],
                                   num_heads=cfg["num_heads"], filter_threshold=cfg["filter_threshold"],
                                   depth_confidence=cfg["depth_confidence"],
                                   width_confidence=cfg["width_confidence"]), inputs["weights"], device=device)
    got = dict(stem_stride=sp.cfg.superpoint.stem_stride, max_keypoints=sp.cfg.superpoint.max_keypoints,
               descriptor_dim=lg.cfg.descriptor_dim, lightglue_layers=lg.cfg.n_layers, num_heads=lg.cfg.num_heads,
               filter_threshold=lg.cfg.filter_threshold, depth_confidence=lg.cfg.depth_confidence,
               width_confidence=lg.cfg.width_confidence)
    wrong = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if wrong:
        raise ValueError(f"the port does not run the configuration: {wrong} (built, configured)")
    return lightglue_frontend(sp, lg)


def reference_load(cfg: dict, inputs: dict, device) -> dict:
    _, tree = read_checkpoint(os.path.join(inputs["root"], cfg["checkpoint"]))
    return dict(sp=superpoint.load_weights(tree["superpoint"]["params"], device),
                lg=lightglue.load_weights(inputs["weights"], device))


def reference_match(a: dict, b: dict, net: dict, cfg: dict, image_shape, prec):
    return lightglue.match(a, b, net["lg"], cfg, image_shape, prec)


# ------------------------------------------------------------- roofline


def self_layer_flops(P: int, K: int, D: int) -> int:
    """One self block on both sets of P pairs of K keypoints: Wqkv, q k^T,
    p v, out_proj and the FFN, each set."""
    return 2 * P * (2 * K * D * 3 * D + 2 * 2 * K * K * D + 2 * K * D * D + 2 * K * 2 * D * 2 * D + 2 * K * 2 * D * D)


def cross_layer_flops(P: int, K: int, D: int) -> int:
    """One cross block on P pairs: to_qk, to_v, to_out and the FFN on each
    set; S once a pair (LightGlue computes it once), and both products with
    v."""
    per_set = 2 * K * D * D * 3 + 2 * K * 2 * D * 2 * D + 2 * K * 2 * D * D
    return P * (2 * per_set + 3 * 2 * K * K * D)


def assign_flops(K: int, D: int) -> int:
    """The assignment's matrix products a pair: final_proj on each set and
    the similarity."""
    return 2 * 2 * K * D * D + 2 * K * K * D


def matcher_matrix_flops(cfg: dict, K: int) -> int:
    """The matrix products of one pair through LightGlue (arXiv:2306.13643
    Sec. 3 at fixed depth): every layer's self and cross block and the
    assignment; 229,780,750,336 at K=2048, D=256, 9 layers."""
    D, L = cfg["descriptor_dim"], cfg["lightglue_layers"]
    return L * (self_layer_flops(1, K, D) + cross_layer_flops(1, K, D)) + assign_flops(K, D)


def matcher_flops(cfg: dict, K: int) -> int:
    """One pair through LightGlue: the matrix products, then the
    element-wise work: the rotary encoding of q and k (3 operations an
    element), each attention's softmax (5 an entry: the self blocks' four
    maps and the cross blocks' two sweeps of S), LayerNorm and GELU (12 an
    FFN element), the matchability products, the assignment's two
    log-softmaxes and sums (10 an entry)."""
    D, L, h = cfg["descriptor_dim"], cfg["lightglue_layers"], cfg["num_heads"]
    elementwise = L * (2 * 2 * K * D * 3 + 5 * (2 * h * K * K + 2 * h * K * K) + 12 * 2 * (2 * K * 2 * D))
    return matcher_matrix_flops(cfg, K) + elementwise + 2 * 2 * K * D + 10 * K * K


def layer_cost(kind: str, P: int, K: int, D: int, heads: int) -> roofline.StageCost:
    """The least work of one fused-layer launch on P pairs (2P sequences of
    K tokens): the block's published operations (S once a cross block);
    the tokens read once (a cross block's other set holds the same tokens),
    the self block's float32 rotary table ((cos, sin) of dh/2 angles a
    token), the masks and the weights (the fused layer's layout, a cross
    block's to_qk read as q and as k), the output written once."""
    ops = self_layer_flops(P, K, D) if kind == "self" else cross_layer_flops(P, K, D)
    table = 2 * P * K * (D // heads) * 4 if kind == "self" else 0
    return roofline.StageCost(ops, 2 * (2 * 2 * P * K * D) + table + 2 * P * K + roofline.gnn_layer_weight_bytes(D))


def matcher_weight_bytes(cfg: dict) -> int:
    """bf16 layer, final_proj and matchability weights, float32 LayerNorm,
    Wr and matchability bias."""
    D = cfg["descriptor_dim"]
    return (2 * cfg["lightglue_layers"] * roofline.gnn_layer_weight_bytes(D) + 4 * (D // cfg["num_heads"])
            + 2 * (D * D + D) + 2 * D + 4)


def costs(H: int, W: int, cfg: dict):
    """(frame FLOPs, pair FLOPs, bytes of a keypoint slot, extract weight
    bytes, pair weight bytes): SuperPoint's convolutions and selection a
    frame (superpoint_superglue.py's count), LightGlue a pair, each
    network's bf16 weights."""
    frame_flops = sum(2 * ci * co * k * k * h * w for ci, co, k, h, w in _sp.superpoint_convs(cfg, H, W))
    frame_flops += (4 * cfg["nms_radius"] + 4) * H * W
    s8 = 8 * cfg["stem_stride"]
    ex_w = sum(2 * (ci * co * k * k + co) for ci, co, k, _, _ in _sp.superpoint_convs(cfg, s8, s8))
    return (frame_flops, matcher_flops(cfg, keypoints(cfg)), 8 + 4 + 4 * cfg["descriptor_dim"] + 1, ex_w,
            matcher_weight_bytes(cfg))
