"""The port's msgpack reader and weight loader against flax.

Every checkpoint under weights/ must decode leaf for leaf (``__meta__``
included) exactly as ``flax.serialization.msgpack_restore`` decodes it, and
``params_from_jax`` must carry each flax leaf into the port's modules with
only the documented layout changes (HWIO -> OIHW, (in, out) -> (out, in),
per-head splits). Tolerance: exact (0) in float32; the GNN layers' float32
parameters are the flax leaves, and the bf16 kernel-layout weights derived
from them must equal the bf16 rounding of the flax leaves.
"""

import glob
import os

import numpy as np
import pytest
import torch
from flax import serialization

from forest_slam_tpu_torch.frontend import _msgpack
from forest_slam_tpu_torch.frontend.learned import LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
from forest_slam_tpu_torch.frontend.weights import (
    FLAGSHIP_PATH,
    WEIGHTS_DIR,
    load_learned_frontend,
    params_from_jax,
    read_checkpoint,
)

CHECKPOINTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(WEIGHTS_DIR, "*.msgpack")))


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


def test_all_six_checkpoints_present():
    assert len(CHECKPOINTS) == 6


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_msgpack_reader_matches_flax(name):
    with open(os.path.join(WEIGHTS_DIR, name), "rb") as f:
        raw = f.read()
    _assert_same_tree(_msgpack.unpackb(raw), serialization.msgpack_restore(raw))


def test_msgpack_reader_ints_floats_strings():
    tree = {"a": 1, "b": -3, "c": 2.5, "d": "text", "e": -(2 ** 40), "f": 70000, "g": [1, "x", 0.25],
            "h": np.arange(6, dtype=np.int32).reshape(2, 3), "i": {"j": np.zeros((), np.float32)}}
    raw = serialization.msgpack_serialize(tree)
    _assert_same_tree(_msgpack.unpackb(raw), serialization.msgpack_restore(raw))


def test_msgpack_reader_rejects_unsupported_types():
    with pytest.raises(ValueError, match="extension type 3"):
        _msgpack.unpackb(serialization.msgpack_serialize({"s": np.float32(1.5)}))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(serialization.msgpack_serialize({"a": np.ones(4, np.float32)})[:-3])


def test_params_from_jax_matches_flax_tree():
    state = serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())
    meta, tree = read_checkpoint(FLAGSHIP_PATH)
    assert meta == {k: v.item() if hasattr(v, "item") else v for k, v in state["__meta__"].items()}
    p = state["params"]
    cfg = LearnedFrontendConfig(
        superpoint=SuperPointConfig(stem_stride=4, dtype=torch.float32),
        superglue=SuperGlueConfig(gnn_layers=9),
    )
    fe = params_from_jax(tree, cfg)
    sp = p["superpoint"]["params"]
    for name, conv in fe.superpoint.convs.items():
        np.testing.assert_array_equal(conv.weight.detach().numpy(), sp[name]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.detach().numpy(), sp[name]["bias"])
    sg = p["superglue"]["params"]
    np.testing.assert_array_equal(fe.superglue.final_proj.weight.detach().numpy(), sg["final_proj"]["kernel"].T)
    np.testing.assert_array_equal(fe.superglue.kenc.mlp[2].weight.detach().numpy(), sg["kenc"]["mlp_2"]["kernel"].T)
    np.testing.assert_array_equal(fe.superglue.kenc.mlp_out.bias.detach().numpy(), sg["kenc"]["mlp_out"]["bias"])
    assert float(fe.superglue.bin_score) == float(sg["bin_score"])
    bf = lambda a: torch.as_tensor(np.array(a, np.float32)).to(torch.bfloat16).float().numpy()
    layer = fe.superglue.layers["cross_4"]
    lp = sg["cross_4"]
    D, h = 256, 4
    np.testing.assert_array_equal(layer.attn["v"].kernel.detach().numpy(), lp["attn"]["v"]["kernel"])
    np.testing.assert_array_equal(layer.ln.bias.detach().numpy(), lp["ln"]["bias"])
    with torch.no_grad():
        wq, _, _, _, _, _, wm, _, w0a, w0b, _, lns, _, _, _ = layer.weights()
    np.testing.assert_array_equal(wq.float().numpy(), bf(lp["attn"]["q"]["kernel"]).reshape(D, h, D // h).transpose(1, 0, 2))
    np.testing.assert_array_equal(wm.float().numpy().reshape(D, D), bf(lp["attn"]["merge"]["kernel"]))
    w0 = bf(lp["mlp0"]["kernel"])
    np.testing.assert_array_equal(w0a.float().numpy(), w0[:D])
    np.testing.assert_array_equal(w0b.float().numpy(), w0[D:])
    np.testing.assert_array_equal(lns.numpy()[0], lp["ln"]["scale"])


def test_load_learned_frontend_reads_meta():
    fe = load_learned_frontend(FLAGSHIP_PATH, (160, 224), max_keypoints=128, device="cpu")
    assert fe.cfg.superpoint.stem_stride == 4
    assert fe.cfg.superglue.gnn_layers == 9 and fe.cfg.superglue.sinkhorn_iterations == 20
    assert fe.cfg.superpoint.max_keypoints == 128 and fe.cfg.superpoint.subpixel == "none"
    assert fe.superpoint.convs["enc1_0"].weight.shape == (64, 16, 3, 3)


def test_load_bare_layout_checkpoint():
    """The stride-1 training checkpoint has no __meta__ (the bare layout)."""
    path = os.path.join(WEIGHTS_DIR, "learned_frontend.msgpack")
    meta, _ = read_checkpoint(path)
    assert meta == {}
    fe = load_learned_frontend(path, (160, 224), max_keypoints=64, device="cpu")
    assert fe.cfg.superpoint.stem_stride == 1
    assert fe.superpoint.convs["enc1_0"].weight.shape == (64, 1, 3, 3)
