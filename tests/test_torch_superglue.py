"""SuperGlue pieces of the port against the JAX package.

- GNN layer: the plain version against ``fused_gnn_layer(interpret=True)``
  at K=S=128, at a ragged K=40, S=56 and with a fully masked sequence, with
  the flagship's weights. Both cast to bf16 at the same points; sums differ
  in order, so a bf16 output may differ by a rounding: max error within 2%
  of the output range, mean within 1e-3. Its attention equals
  ``masked_attention_plain`` on the head-split projections bit for bit.
- Sinkhorn: the plain exp-domain decode against
  ``sinkhorn_decode(interpret=True)`` at 0, 1 and 20 iterations, K0 = K1
  and ragged K0 != K1: indices equal, scores within 1e-5
  (float32 sums in another order); the port's log-domain pair against the
  JAX log_sinkhorn + match_from_couplings likewise.
- The whole matcher forward (2 of the flagship's 9 layer pairs, K=128)
  against ``superglue_forward_fused(interpret=True)``: at least 97% of
  ``matches0`` equal (bf16 roundings may flip near-tie assignments).
- ``return_couplings=True`` (training's output: the unfused layers and the
  log-domain Sinkhorn) against ``SuperGlue.apply(return_couplings=True)``
  with 2 of the flagship's layer pairs at K=48 on both attention routes:
  log-couplings within 0.1 (mean 0.01) where both keypoints are valid,
  values up to 13 in size; the best column of 97% of the rows that have a
  true match the same.
- The fused layer under autograd: it has no backward, so with a weight
  that requires grad it raises, on the CPU too (its plain version there);
  the unfused layer carries gradients to the float32 masters. The bf16
  weight copies are made once per parameter version outside autograd.
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.pallas_gnn import fused_gnn_layer, split_layer_params as jsplit
from forest_slam_tpu.frontend.pallas_gnn import superglue_forward_fused
from forest_slam_tpu.frontend.pallas_sinkhorn import sinkhorn_decode as jsinkhorn_decode
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu.frontend.superglue import log_sinkhorn as jlog_sinkhorn
from forest_slam_tpu.frontend.superglue import match_from_couplings as jmatch_from_couplings
from forest_slam_tpu_torch.frontend.attention_kernel import masked_attention_plain
from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain, project_heads, split_layer_params
from forest_slam_tpu_torch.frontend.sinkhorn_kernel import sinkhorn_decode, sinkhorn_decode_plain
from forest_slam_tpu_torch.frontend.superglue import SuperGlueConfig, log_sinkhorn, match_decode, match_from_couplings
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, read_checkpoint, superglue_from_jax

K = 128


@pytest.fixture(scope="module")
def sg_params():
    return serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())["params"]["superglue"]["params"]


# (K, S, all_masked): the matcher's K = S, a ragged K != S, and a sequence
# whose sources are all masked (its queries average v)
@pytest.mark.parametrize("k, s, all_masked", [(K, K, False), (40, 56, False), (K, K, True)])
def test_gnn_layer_plain_matches_pallas_interpret(sg_params, rng, k, s, all_masked):
    B, D = 2, 256
    x = rng.normal(size=(B, k, D)).astype(np.float32)
    src = rng.normal(size=(B, s, D)).astype(np.float32)
    mask = rng.random((B, s)) > 0.3
    if all_masked:
        mask[-1] = False
    lp = sg_params["cross_3"]
    ref = np.asarray(fused_gnn_layer(jnp.asarray(x, jnp.bfloat16), jnp.asarray(src, jnp.bfloat16),
                                     jnp.asarray(mask), jsplit(lp, 4), 4, interpret=True), np.float32)
    ws = split_layer_params(lp, 4)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    ts = torch.as_tensor(src).to(torch.bfloat16)
    got = gnn_layer_plain(tx, ts, torch.as_tensor(mask), ws, 4).float().numpy()
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() / scale < 0.02, np.abs(got - ref).max()
    assert np.abs(got - ref).mean() < 1e-3
    wrapped = gnn_layer(tx, ts, torch.as_tensor(mask), ws, 4).float().numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_gnn_layer_attention_is_masked_attention_plain(sg_params, rng):
    """The layer's attention, head by head as pallas_gnn.py:114-125 writes it
    (a float 0/1 mask tested > 0.5, one (N, K, S) logits block per head),
    equals masked_attention_plain on the head-split q, k, v bit for bit: the
    claim that lets one attention core serve both CUDA kernels. The ragged
    K != S and a fully masked sequence are in it."""
    N, k, s, D, heads = 2, 40, 56, 256, 4
    ws = split_layer_params(sg_params["self_1"], heads)
    wq, bq, wk, bk, wv, bv = ws[:6]
    x = torch.as_tensor(rng.normal(size=(N, k, D)).astype(np.float32)).to(torch.bfloat16)
    src = torch.as_tensor(rng.normal(size=(N, s, D)).astype(np.float32)).to(torch.bfloat16)
    mask = torch.as_tensor(rng.random((N, s)) > 0.3)
    mask[-1] = False
    q, kk, v = project_heads(x, wq, bq), project_heads(src, wk, bk), project_heads(src, wv, bv)
    scale = 1.0 / (D // heads) ** 0.5
    got = masked_attention_plain(q, kk, v, mask, scale)
    m = mask.float()[:, None, :]
    for h in range(heads):
        logits = (q[:, h].float() @ kk[:, h].float().transpose(-1, -2)) * scale
        logits = torch.where(m > 0.5, logits, torch.full_like(logits, -1e9))
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        ref = (p.to(torch.bfloat16).float() @ v[:, h].float()).to(torch.bfloat16)
        assert torch.equal(got[:, h], ref), h
    # the fully masked sequence averages v
    torch.testing.assert_close(got[-1].float(), v[-1].float().mean(dim=1, keepdim=True).expand(-1, k, -1),
                               rtol=0, atol=2.0 ** -8)


def _scores(rng, B=2, K0=K, K1=K):
    s = rng.normal(size=(B, K0, K1)).astype(np.float32) * 1.5 + 6.0 * np.eye(K0, K1, dtype=np.float32)
    v0 = np.arange(K0)[None] < np.array([100, K0])[:, None]
    v1 = np.arange(K1)[None] < np.array([90, K1])[:, None]
    return s, v0, v1, np.float32(1.3)


# iters 0 decodes from A = V = 1 (the TPU kernel's start); K0 != K1 both ways
@pytest.mark.parametrize("iters", [0, 1, 20])
@pytest.mark.parametrize("k0, k1", [(K, K), (K, 96), (72, K)])
def test_sinkhorn_plain_matches_pallas_interpret(rng, iters, k0, k1):
    s, v0, v1, alpha = _scores(rng, K0=k0, K1=k1)
    ref = jsinkhorn_decode(jnp.asarray(s), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(alpha), iters, True)
    args = (torch.as_tensor(s), torch.as_tensor(v0), torch.as_tensor(v1), torch.tensor(alpha), iters)
    got = sinkhorn_decode_plain(*args)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5)
    for g, w in zip(got, sinkhorn_decode(*args)):
        np.testing.assert_array_equal(w.numpy(), g.numpy())


def test_log_sinkhorn_and_decode_match(rng):
    s, v0, v1, alpha = _scores(rng)
    jl = jlog_sinkhorn(jnp.asarray(s), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(alpha), 20)
    tl = log_sinkhorn(torch.as_tensor(s), torch.as_tensor(v0), torch.as_tensor(v1), torch.tensor(alpha), 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=1e-5)
    jm = jmatch_from_couplings(jl, jnp.asarray(v0), jnp.asarray(v1), 0.2)
    tm = match_from_couplings(tl, torch.as_tensor(v0), torch.as_tensor(v1), 0.2)
    np.testing.assert_array_equal(tm.matches0.numpy(), np.asarray(jm.matches0))
    np.testing.assert_array_equal(tm.matches1.numpy(), np.asarray(jm.matches1))
    np.testing.assert_allclose(tm.matching_scores0.numpy(), np.asarray(jm.matching_scores0), atol=1e-5)
    # the exp-domain decode reaches the same matches
    te = match_decode(torch.as_tensor(s), torch.as_tensor(v0), torch.as_tensor(v1), torch.tensor(alpha), 20, 0.2)
    np.testing.assert_array_equal(te.matches0.numpy(), np.asarray(jm.matches0))
    np.testing.assert_allclose(te.matching_scores1.numpy(), np.asarray(jm.matching_scores1), atol=1e-5)


def test_superglue_forward_matches_fused_interpret(sg_params):
    """Flagship matcher on SuperPoint features of two rendered frames."""
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
    ref = superglue_forward_fused({"params": sg_params}, JSGConfig(sinkhorn_impl="xla"),
                                  *map(jnp.asarray, args), (H, W), interpret=True)
    sg = superglue_from_jax(sg_params, SuperGlueConfig())
    with torch.no_grad():
        got = sg(*map(torch.as_tensor, args), (H, W))
    jm = np.asarray(ref.matches0)
    assert (jm >= 0).sum() > 50
    assert (got.matches0.numpy() == jm).mean() >= 0.97
    ok = (got.matches0.numpy() == jm) & (jm >= 0)
    np.testing.assert_allclose(got.matching_scores0.numpy()[ok], np.asarray(ref.matching_scores0)[ok], atol=0.05)


def _features(rng, B, K, H, W, like=None):
    xy = rng.uniform([0, 0], [W, H], size=(B, K, 2)).astype(np.float32)
    d = rng.normal(size=(B, K, 256)).astype(np.float32)
    if like is not None:  # 30 true matches: the other set's descriptors, noise of norm 0.1
        d[:, :30] = like[:, :30] + 0.1 * d[:, :30] / 16.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [xy, np.ones((B, K), np.float32), d, rng.random((B, K)) < 0.8]


@pytest.mark.parametrize("jax_impl, impl", [("xla", "xla"), ("fused_interpret", "auto")])
def test_return_couplings_match_jax(sg_params, jax_impl, impl):
    from forest_slam_tpu.frontend.superglue import SuperGlue as JSuperGlue

    rng = np.random.default_rng(0)
    B, Kc, H, W = 2, 48, 120, 160
    f0 = _features(rng, B, Kc, H, W)
    f1 = _features(rng, B, Kc, H, W, like=f0[2])
    run = lambda *a: JSuperGlue(JSGConfig(gnn_layers=2, attention_impl=jax_impl)).apply(
        {"params": sg_params}, *a, (H, W), return_couplings=True)
    ref = np.asarray(jax.jit(run)(*map(jnp.asarray, f0 + f1)))
    sg = superglue_from_jax(sg_params, SuperGlueConfig(gnn_layers=2, attention_impl=impl))
    got = sg(*map(torch.as_tensor, f0 + f1), (H, W), return_couplings=True)
    assert got.shape == (B, Kc + 1, Kc + 1) and got.requires_grad
    got = got.detach().numpy()
    both = (np.concatenate([f0[3], np.ones((B, 1), bool)], 1)[:, :, None]
            & np.concatenate([f1[3], np.ones((B, 1), bool)], 1)[:, None, :])
    err = np.abs(got - ref)[both]
    assert err.max() <= 0.1 and err.mean() <= 0.01, (err.max(), err.mean())
    np.testing.assert_array_equal(got[~both], ref[~both])  # the NEG-masked entries
    rows = f0[3] & f1[3] & (np.arange(Kc) < 30)  # rows with a true match
    assert (got[:, :-1, :-1].argmax(2) == ref[:, :-1, :-1].argmax(2))[rows].mean() >= 0.97


def test_fused_layer_refuses_autograd(sg_params, rng):
    sg = superglue_from_jax(sg_params, SuperGlueConfig(gnn_layers=1))
    layer = sg.layers["self_0"]
    x = torch.as_tensor(rng.normal(size=(2, 16, 256)).astype(np.float32)).to(torch.bfloat16)
    mask = torch.as_tensor(rng.random((2, 16)) < 0.8)
    with pytest.raises(RuntimeError, match="no backward"):
        layer(x, x, mask)  # gnn_impl "auto": on CPU tensors the plain version, under the same check
    with pytest.raises(RuntimeError, match="no backward"):
        gnn_layer(x, x, mask, layer.weights(), 4)
    with torch.no_grad():
        out = layer(x, x, mask)
        assert torch.equal(out, gnn_layer_plain(x, x, mask, layer.weights(), 4))
    y = layer(x, x, mask, unfused=True)
    y.float().square().sum().backward()
    for p in (layer.attn["q"].kernel, layer.attn["merge"].bias, layer.mlp0.kernel, layer.ln.scale, layer.mlp1.bias):
        assert p.grad is not None and p.grad.abs().sum() > 0


def test_weight_copies_made_once_per_parameter_version(sg_params):
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig
    from forest_slam_tpu_torch.frontend.weights import superpoint_from_jax

    layer = superglue_from_jax(sg_params, SuperGlueConfig(gnn_layers=1)).layers["cross_0"]
    with torch.no_grad():
        a = layer.weights()
        assert layer.weights() is a and not any(t.requires_grad for t in a)
        layer.mlp1.bias.add_(1.0)
        b = layer.weights()
    assert b is not a
    assert torch.equal(b[-1], layer.mlp1.bias.detach().to(torch.bfloat16).reshape(1, -1))
    assert torch.equal(b[0], a[0])
    fresh = layer.weights()  # grad mode, masters require grad: a new differentiable copy
    assert fresh is not b and fresh[0].requires_grad
    _, tree = read_checkpoint(FLAGSHIP_PATH)
    net = superpoint_from_jax(tree["superpoint"]["params"], SuperPointConfig(stem_stride=4))
    with torch.no_grad():
        w = net.conv_weights()
        assert net.conv_weights() is w and w["enc1_0"][0].dtype == torch.bfloat16
        net.convs["det_out"].weight.mul_(2.0)
        assert net.conv_weights() is not w
