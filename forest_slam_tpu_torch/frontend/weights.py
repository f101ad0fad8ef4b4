"""The repository's flax checkpoints and the port's modules, both ways
(port of frontend/weights.py).

Checkpoints under ``weights/`` are flax msgpack files: either
``{"__meta__": {...}, "params": tree}`` or a bare tree (the training
layout). ``tree`` holds ``superpoint`` and ``superglue`` subtrees of numpy
arrays, with the SuperPoint network either bare or nested under ``net``.
:func:`params_from_jax` loads a tree into float32 parameters;
:func:`params_to_jax` gives the tree back (bare SuperPoint, the trainer's
layout) and :func:`save_params` writes it as ``flax.serialization.to_bytes``
does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from forest_slam_tpu_torch.frontend import _msgpack
from forest_slam_tpu_torch.frontend.learned import LearnedFrontend, LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import _CONVS, SuperPointConfig, SuperPointNet
from forest_slam_tpu_torch.utils import trace

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights")
# the flagship inference checkpoint (stem-4, 9 GNN layers, 20 Sinkhorn iterations)
FLAGSHIP_PATH = os.path.join(WEIGHTS_DIR, "learned_frontend_stem4_wb_blur2.msgpack")
# the plain gates' checkpoint (frontend/weights.py:66-82): stem 2, com3
# sub-pixel readout, continued on wide frame gaps
PLAIN_WB_PATH = os.path.join(WEIGHTS_DIR, "learned_frontend_stem2_subpix_wide.msgpack")


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(meta, params tree) of a checkpoint; meta is {} for bare files."""
    with open(path, "rb") as f:
        state = _msgpack.unpackb(f.read())
    if isinstance(state, dict) and "__meta__" in state:
        meta = {k: (v.item() if isinstance(v, np.generic) else v) for k, v in state["__meta__"].items()}
        return meta, state["params"]
    return {}, state


def _copy(param: torch.Tensor, a, name: str) -> None:
    """param <- the float32 array ``a``, whose shape must be param's."""
    t = torch.as_tensor(np.array(a, np.float32))
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"checkpoint {name}: shape {tuple(t.shape)}, the module's {tuple(param.shape)}")
    param.copy_(t)


def _np(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().float().cpu().numpy(), order="C")


def _linears(sg: SuperGlue) -> dict:
    """Flax Dense name -> the port's nn.Linear, in Flax's order."""
    return {**{f"kenc.mlp_{j}": lin for j, lin in enumerate(sg.kenc.mlp)}, "kenc.mlp_out": sg.kenc.mlp_out,
            "final_proj": sg.final_proj}


def superpoint_from_jax(sp_params: dict, cfg: SuperPointConfig, net: SuperPointNet | None = None) -> SuperPointNet:
    """SuperPoint params (bare or nested under "net") -> SuperPointNet (a
    new one, or ``net`` loaded in place). Conv kernels HWIO -> OIHW."""
    p = sp_params.get("net", sp_params)
    net = SuperPointNet(cfg) if net is None else net
    with torch.no_grad():
        for name in _CONVS:
            conv = net.convs[name]
            _copy(conv.weight, np.transpose(np.asarray(p[name]["kernel"], np.float32), (3, 2, 0, 1)), name)
            _copy(conv.bias, p[name]["bias"], name)
    return net


def superglue_from_jax(sg_params: dict, cfg: SuperGlueConfig, sg: SuperGlue | None = None) -> SuperGlue:
    """SuperGlue params -> SuperGlue (a new one, or ``sg`` loaded in place).
    Dense (in, out) -> Linear.weight (out, in); the GNN layers' parameters
    are the Flax subtree's as they are."""
    sg = SuperGlue(cfg) if sg is None else sg

    def load(params: dict, tree: dict, path: str):
        for k, v in params.items():
            if isinstance(v, dict):
                load(v, tree[k], f"{path}.{k}")
            else:
                _copy(v, tree[k], f"{path}.{k}")

    with torch.no_grad():
        for name, layer in sg.layers.items():
            load(layer.flax_params(), sg_params[name], name)
        for name, lin in _linears(sg).items():
            dp = sg_params
            for part in name.split("."):
                dp = dp[part]
            _copy(lin.weight, np.asarray(dp["kernel"], np.float32).T, name)
            _copy(lin.bias, dp["bias"], name)
        _copy(sg.bin_score, sg_params["bin_score"], "bin_score")
    return sg


def params_from_jax(tree: dict, cfg: LearnedFrontendConfig) -> LearnedFrontend:
    """A JAX parameter tree of numpy arrays ({"superpoint": {"params": ...},
    "superglue": {"params": ...}}) -> the port's LearnedFrontend."""
    sp = superpoint_from_jax(tree["superpoint"]["params"], cfg.superpoint)
    sg = superglue_from_jax(tree["superglue"]["params"], cfg.superglue)
    return LearnedFrontend(cfg, sp, sg)


def superpoint_to_jax(net: SuperPointNet) -> dict:
    """SuperPointNet -> bare Flax params {conv: {kernel HWIO, bias}}."""
    return {name: {"kernel": _np(net.convs[name].weight.permute(2, 3, 1, 0)), "bias": _np(net.convs[name].bias)}
            for name in _CONVS}


def superglue_to_jax(sg: SuperGlue) -> dict:
    """SuperGlue -> Flax params, keys in the order Flax creates them."""
    lin = _linears(sg)

    def dense(name):
        return {"kernel": _np(lin[name].weight.t()), "bias": _np(lin[name].bias)}

    def tree(params):
        return {k: tree(v) if isinstance(v, dict) else _np(v) for k, v in params.items()}

    out = {"kenc": {name.split(".")[1]: dense(name) for name in lin if name.startswith("kenc.")}}
    out.update({name: tree(layer.flax_params()) for name, layer in sg.layers.items()})
    out["final_proj"] = dense("final_proj")
    out["bin_score"] = _np(sg.bin_score)
    return out


def params_to_jax(fe: LearnedFrontend) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX parameter tree of
    numpy float32 arrays, SuperPoint bare (the trainer's layout)."""
    return {"superpoint": {"params": superpoint_to_jax(fe.superpoint)},
            "superglue": {"params": superglue_to_jax(fe.superglue)}}


def save_params(params: dict, path: str, meta: dict | None = None) -> None:
    """Write a checkpoint as frontend/weights.py:save_params does:
    ``{"__meta__": meta, "params": params}``, or the bare tree without
    ``meta``; ``meta`` holds Python ints, floats and strings."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = params if meta is None else {"__meta__": meta, "params": params}
    with open(path, "wb") as f:
        f.write(_msgpack.packb(payload))


def load_learned_frontend(path: str = FLAGSHIP_PATH, image_shape=(600, 960), max_keypoints: int = 1024,
                          device="cuda", superpoint_overrides: dict | None = None,
                          superglue_overrides: dict | None = None, scales=(1.0,)) -> LearnedFrontend:
    """Build a LearnedFrontend matching a checkpoint's ``__meta__`` (stem
    stride, GNN depth, Sinkhorn iterations, sub-pixel readout) and load its
    weights onto ``device``. ``superglue_overrides`` take SuperGlueConfig
    fields (gnn_impl, attention_impl, softmax_dtype, ...; a smaller
    gnn_layers loads the first layer pairs); ``scales`` are the extraction
    octaves. Loads in the one-shot span ``fs.setup.checkpoint`` (children
    ``.read``, ``.convert``, ``.to_device``; utils/trace.py)."""
    with trace.setup_span("fs.setup.checkpoint"):
        with trace.span("fs.setup.checkpoint.read"):
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
        with trace.span("fs.setup.checkpoint.convert"):
            fe = params_from_jax(tree, LearnedFrontendConfig(superpoint=sp, superglue=sg, scales=tuple(scales)))
        with trace.span("fs.setup.checkpoint.to_device"):
            return fe.to(device)
