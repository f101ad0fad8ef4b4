"""Load the repository's flax checkpoints into the port's modules (port of
frontend/weights.py).

Checkpoints under ``weights/`` are flax msgpack files: either
``{"__meta__": {...}, "params": tree}`` or a bare tree (the training
layout). ``tree`` holds ``superpoint`` and ``superglue`` subtrees of numpy
arrays, with the SuperPoint network either bare or nested under ``net``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from forest_slam_tpu_torch.frontend import _msgpack
from forest_slam_tpu_torch.frontend.gnn_kernel import split_layer_params
from forest_slam_tpu_torch.frontend.learned import LearnedFrontend, LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import GnnLayer, SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import _CONVS, SuperPointConfig, SuperPointNet

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights")
# the flagship inference checkpoint (stem-4, 9 GNN layers, 20 Sinkhorn iterations)
FLAGSHIP_PATH = os.path.join(WEIGHTS_DIR, "learned_frontend_stem4_wb_blur2.msgpack")


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(meta, params tree) of a checkpoint; meta is {} for bare files."""
    with open(path, "rb") as f:
        state = _msgpack.unpackb(f.read())
    if isinstance(state, dict) and "__meta__" in state:
        meta = {k: (v.item() if isinstance(v, np.generic) else v) for k, v in state["__meta__"].items()}
        return meta, state["params"]
    return {}, state


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


def superpoint_from_jax(sp_params: dict, cfg: SuperPointConfig) -> SuperPointNet:
    """SuperPoint params (bare or nested under "net") -> SuperPointNet.
    Conv kernels HWIO -> OIHW."""
    p = sp_params.get("net", sp_params)
    net = SuperPointNet(cfg)
    with torch.no_grad():
        for name in _CONVS:
            conv = net.convs[name]
            conv.weight.copy_(_t(p[name]["kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(_t(p[name]["bias"]))
    return net


def superglue_from_jax(sg_params: dict, cfg: SuperGlueConfig) -> SuperGlue:
    """SuperGlue params -> SuperGlue. Dense (in, out) -> Linear.weight
    (out, in); GNN layers pre-split per head (split_layer_params)."""
    layers = {}
    for i in range(cfg.gnn_layers):
        for kind in ("self", "cross"):
            name = f"{kind}_{i}"
            layers[name] = GnnLayer(split_layer_params(sg_params[name], cfg.num_heads), cfg)
    sg = SuperGlue(cfg, layers)

    def dense(lin, dp):
        lin.weight.copy_(_t(dp["kernel"]).t())
        lin.bias.copy_(_t(dp["bias"]))

    with torch.no_grad():
        for j, lin in enumerate(sg.kenc.mlp):
            dense(lin, sg_params["kenc"][f"mlp_{j}"])
        dense(sg.kenc.mlp_out, sg_params["kenc"]["mlp_out"])
        dense(sg.final_proj, sg_params["final_proj"])
        sg.bin_score.copy_(_t(sg_params["bin_score"]))
    return sg


def params_from_jax(tree: dict, cfg: LearnedFrontendConfig) -> LearnedFrontend:
    """A JAX parameter tree of numpy arrays ({"superpoint": {"params": ...},
    "superglue": {"params": ...}}) -> the port's LearnedFrontend."""
    sp = superpoint_from_jax(tree["superpoint"]["params"], cfg.superpoint)
    sg = superglue_from_jax(tree["superglue"]["params"], cfg.superglue)
    return LearnedFrontend(cfg, sp, sg)


def load_learned_frontend(path: str = FLAGSHIP_PATH, image_shape=(600, 960), max_keypoints: int = 1024,
                          device="cuda", superpoint_overrides: dict | None = None,
                          superglue_overrides: dict | None = None, scales=(1.0,)) -> LearnedFrontend:
    """Build a LearnedFrontend matching a checkpoint's ``__meta__`` (stem
    stride, GNN depth, Sinkhorn iterations, sub-pixel readout) and load its
    weights onto ``device``. ``superglue_overrides`` take SuperGlueConfig
    fields (gnn_impl, attention_impl, softmax_dtype, ...; a smaller
    gnn_layers loads the first layer pairs); ``scales`` are the extraction
    octaves."""
    meta, tree = read_checkpoint(path)
    stride = int(meta.get("stem_stride", 1))
    H, W = image_shape
    if H % 8 or W % 8:
        raise ValueError(f"image shape {image_shape} must be a multiple of 8")
    sp = SuperPointConfig(
        stem_stride=stride, max_keypoints=max_keypoints,
        subpixel=str(meta.get("subpixel", "none")), **(superpoint_overrides or {}),
    )
    sg = SuperGlueConfig(**{
        "gnn_layers": int(meta.get("gnn_layers", 9)),
        "sinkhorn_iterations": int(meta.get("sinkhorn_iterations", 20)),
        **(superglue_overrides or {}),
    })
    fe = params_from_jax(tree, LearnedFrontendConfig(superpoint=sp, superglue=sg, scales=tuple(scales)))
    return fe.to(device)
