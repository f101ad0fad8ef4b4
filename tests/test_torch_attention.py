"""Masked attention and the unfused GNN layer of the port against the JAX
package.

- The attention Function's forward (the kernel's plain version on the CPU)
  against ``fused_attention(interpret=True)`` at B=2, h=4, K=S=128, dh=64,
  with masked sources and one batch whose sources are all masked. Both cast
  the normalised probabilities and the output to bf16 at the same points;
  float32 sums in another order may flip a rounding, so the bound is bf16's:
  max error <= 2^-7 * max|out|, mean <= 1e-3. Its gradients (a dense
  recompute on both sides) against ``jax.grad`` through ``fused_attention``,
  to the same bf16 bound relative to each gradient's largest entry.
- One unfused layer (``gnn_impl="xla"``) against the Flax ``GnnLayer`` with
  the flagship's weights, for ``attention_impl`` "auto" (JAX
  "fused_interpret") and "xla" at both ``softmax_dtype`` values: bf16
  outputs within 2% of the output range, mean within 1e-3, as the fused
  layer is held in test_torch_superglue.py.
- The whole unfused matcher (2 of the flagship's 9 layer pairs, K=128)
  against ``SuperGlue.apply(attention_impl="fused_interpret")``: at least 97%
  of ``matches0`` equal (bf16 roundings may flip near-tie assignments).
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.pallas_attention import fused_attention
from forest_slam_tpu.frontend.superglue import GnnLayer as JGnnLayer
from forest_slam_tpu.frontend.superglue import SuperGlue as JSuperGlue
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward, masked_attention, masked_attention_plain
from forest_slam_tpu_torch.frontend.gnn_kernel import split_layer_params
from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig, gnn_layer_unfused
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, read_checkpoint, superglue_from_jax
from _torch_threads import one_torch_thread  # noqa: F401

B, HEADS, K, DH = 2, 4, 128, 64
SCALE = 1.0 / DH ** 0.5
BF16_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def sg_params():
    return serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())["params"]["superglue"]["params"]


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(B, HEADS, K, DH)).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    mask = rng.random((B, K)) < 0.7
    mask[1] = False  # every source of batch 1 masked: its queries average v
    g = rng.normal(size=(B, HEADS, K, DH)).astype(np.float32)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return bf(q), bf(k), bf(v), mask, g


def _bf(a):
    return torch.as_tensor(a).to(torch.bfloat16)


def _within_bf16(got, ref):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= BF16_REL * scale, (np.abs(got - ref).max(), scale)
    assert np.abs(got - ref).mean() <= 1e-3 * max(scale, 1.0)


def test_attention_forward_matches_fused_interpret(qkv):
    q, k, v, mask, _ = qkv
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = np.asarray(fused_attention(j(q), j(k), j(v), jnp.asarray(mask), SCALE, interpret=True), np.float32)
    n = attention_forward.launches
    got = masked_attention(_bf(q), _bf(k), _bf(v), torch.as_tensor(mask), SCALE)
    assert attention_forward.launches == n  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _within_bf16(got, ref)
    # the fully masked batch averages v over all sources, with no NaN
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), got[1].shape),
                               atol=BF16_REL * np.abs(v[1]).max())
    np.testing.assert_array_equal(got, masked_attention_plain(_bf(q), _bf(k), _bf(v), torch.as_tensor(mask),
                                                              SCALE).float().numpy())


def test_attention_gradients_match_jax(qkv):
    q, k, v, mask, g = qkv

    def loss(q_, k_, v_):
        out = fused_attention(q_, k_, v_, jnp.asarray(mask), SCALE, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    refs = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    ts = [_bf(a).requires_grad_() for a in (q, k, v)]
    out = masked_attention(*ts, torch.as_tensor(mask), SCALE)
    (out.float() * torch.as_tensor(g)).sum().backward()
    for t, r in zip(ts, refs):
        assert t.grad.dtype == torch.bfloat16
        _within_bf16(t.grad.float().numpy(), np.asarray(r, np.float32))


def _layer_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, K, 256)).astype(np.float32)
    src = rng.normal(size=(B, K, 256)).astype(np.float32)
    mask = rng.random((B, K)) > 0.3
    return x, src, mask


@pytest.mark.parametrize("impl,softmax_dtype", [("auto", "float32"), ("xla", "float32"), ("xla", "bfloat16")])
def test_unfused_layer_matches_flax(sg_params, impl, softmax_dtype):
    x, src, mask = _layer_inputs()
    jimpl = "fused_interpret" if impl == "auto" else "xla"
    jcfg = JSGConfig(attention_impl=jimpl, softmax_dtype=softmax_dtype)
    ref = JGnnLayer(jcfg).apply({"params": sg_params["self_2"]}, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(src, jnp.bfloat16), jnp.asarray(mask))
    ref = np.asarray(ref, np.float32)
    ws = split_layer_params(sg_params["self_2"], 4)
    got = gnn_layer_unfused(_bf(x), _bf(src), torch.as_tensor(mask), ws, 4, impl, softmax_dtype)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() / scale < 0.02, np.abs(got - ref).max()
    assert np.abs(got - ref).mean() < 1e-3


def test_unfused_matcher_matches_superglue_apply(sg_params):
    """Flagship matcher, 2 layer pairs, on SuperPoint features of two
    rendered frames."""
    from forest_slam_tpu.io.synthetic import render_sequence
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, select_keypoints
    from forest_slam_tpu_torch.frontend.weights import superpoint_from_jax

    H, W = 160, 224
    seq = render_sequence(n_frames=2, height=H, width=W, seed=3, speed=0.15)
    imgs = torch.as_tensor(np.array(seq.images_left, np.float32))
    _, tree = read_checkpoint(FLAGSHIP_PATH)
    spcfg = SuperPointConfig(stem_stride=4, max_keypoints=K, dtype=torch.float32)
    with torch.no_grad():
        raw = superpoint_from_jax(tree["superpoint"]["params"], spcfg)(imgs / 255.0)
        f = select_keypoints(raw.heat, raw.coarse_desc, spcfg)
    args = [a[i:i + 1].numpy() for i in (0, 1) for a in f]
    jcfg = JSGConfig(gnn_layers=2, attention_impl="fused_interpret", sinkhorn_impl="xla", gnn_impl="xla")
    ref = JSuperGlue(jcfg).apply({"params": sg_params}, *map(jnp.asarray, args), (H, W))
    sg = superglue_from_jax(sg_params, SuperGlueConfig(gnn_layers=2, gnn_impl="xla"))
    with torch.no_grad():
        got = sg(*map(torch.as_tensor, args), (H, W))
    jm = np.asarray(ref.matches0)
    assert (jm >= 0).sum() > 50
    assert (got.matches0.numpy() == jm).mean() >= 0.97
    ok = (got.matches0.numpy() == jm) & (jm >= 0)
    np.testing.assert_allclose(got.matching_scores0.numpy()[ok], np.asarray(ref.matching_scores0)[ok], atol=0.05)


def test_unknown_impls_raise():
    x = torch.zeros((1, 8, 256), dtype=torch.bfloat16)
    ws = split_layer_params({
        "attn": {n: {"kernel": np.zeros((256, 256)), "bias": np.zeros(256)} for n in ("q", "k", "v", "merge")},
        "mlp0": {"kernel": np.zeros((512, 512)), "bias": np.zeros(512)},
        "ln": {"scale": np.ones(512), "bias": np.zeros(512)},
        "mlp1": {"kernel": np.zeros((512, 256)), "bias": np.zeros(256)},
    }, 4)
    with pytest.raises(ValueError, match="attention_impl"):
        gnn_layer_unfused(x, x, torch.ones((1, 8), dtype=torch.bool), ws, 4, "stock")
    with pytest.raises(ValueError, match="source_mask"):
        attention_forward(*(torch.zeros((1, 4, 8, 64)),) * 3, torch.ones((1, 9), dtype=torch.bool), SCALE)
