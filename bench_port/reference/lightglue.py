"""LightGlue (arXiv:2306.13643, github.com/cvg/LightGlue, its ``superpoint``
features) in plain PyTorch, one pair at a time on that pair's valid
keypoints alone: batch 1, no padding.

For keypoints p (pixels) and unit descriptors d of sets 0 and 1 in a W x H
image: p' = (p - (W/2, H/2)) / (max(W, H) / 2) and x = d; the rotary table
of a token is cos and sin of u = p' Wr^T, each angle repeated for its column
pair; then ``n_layers`` layers of a self block (``Wqkv`` unflattened to
(heads, dh, 3), q and k rotated by t c + rot(t) s, softmax(q k^T / sqrt dh)
v, ``out_proj``, x + FFN([x | m])) and a cross block (q and k of both sets
from ``to_qk``, one similarity S per head softmaxed along each axis, x +
FFN([x | to_out(m)])), FFN = Linear, LayerNorm (eps 1e-5), exact GELU,
Linear; then the last layer's assignment (``final_proj`` / D^(1/4), sim,
log-softmax along each axis plus the log-sigmoids of ``matchability``) and
the filter (mutual argmax, exp(score) > ``filter_threshold``).

Rounding, at the configuration's precision: bf16 products with float32
sums, each Linear's output and bias in bf16 and its sum rounded to bf16,
activations bf16 between blocks; the rotary encoding, the attention's
logits and softmax, LayerNorm, GELU, the similarity, log-softmaxes and
log-sigmoids in float32, the attention's probabilities in bf16. Each pair
runs with TF32 off for matrix products and cuDNN, so a float32 product is
one on the card too.
``Precision(lower=True)`` is the control (fp8 operands, float32 stages
rounded to bf16); :class:`Float32` rounds nothing (the tests' comparison of
the algorithm).

Departures from github.com/cvg/LightGlue: no confidence heads, early exit
or point pruning (``depth_confidence`` = ``width_confidence`` = -1, which
turns them off there too); the keypoints' padding is a mask in the program,
and here each pair runs on its valid keypoints alone; u is written as two
products and a sum, not as a Linear; the precision above in place of
float32 throughout (``mp=False``); S is computed once and transposed, as
the non-flash path there does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from bench_port.reference.common import SOUND, Precision

LN_EPS = 1e-5


class Float32(Precision):
    """No rounding: every operand, activation and stage in float32."""

    def net(self, x):
        return x.float()

    def f32(self, x):
        return x


def _act(prec: Precision):
    """The activations' type: float32 for :class:`Float32`, else bf16."""
    return torch.float32 if isinstance(prec, Float32) else torch.bfloat16


def load_weights(state_dict: dict, device) -> dict:
    """The state dict as float32 tensors on ``device``."""
    return {k: v.detach().float().to(device) for k, v in state_dict.items()}


def _linear(x, w, b, prec: Precision):
    """nn.Linear(x) with a (out, in) weight: rd(rd(x @ w^T) + rd(b))."""
    dt = _act(prec)
    y = (prec.net(x).float() @ prec.net(w).float().t()).to(dt)
    return (y.float() + b.to(dt).float()).to(dt)


def _ffn(z, net: dict, prefix: str, prec: Precision):
    """Linear, LayerNorm, GELU, Linear on [x | m]."""
    dt = _act(prec)
    y = _linear(z, net[prefix + "0.weight"], net[prefix + "0.bias"], prec).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) * (y - mu)).mean(-1, keepdim=True)
    yn = prec.f32((y - mu) * torch.rsqrt(var + LN_EPS) * net[prefix + "1.weight"] + net[prefix + "1.bias"])
    g = prec.f32(F.gelu(yn)).to(dt)
    return _linear(g, net[prefix + "3.weight"], net[prefix + "3.bias"], prec)


def _attend(q, k, v, prec: Precision):
    """softmax(q k^T / sqrt dh) v for (h, n, dh) heads: float32 logits and
    softmax, probabilities and output in the activations' type."""
    dt = _act(prec)
    logits = prec.f32((prec.net(q).float() @ prec.net(k).float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5))
    return _softmax_v(logits, v, prec).to(dt)


def _softmax_v(logits, v, prec: Precision):
    p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return prec.net(p.to(_act(prec))).float() @ prec.net(v).float()


def rope(t, cs):
    """t (h, n, dh) float32 rotated by cs (n, dh/2, 2) of (cos, sin)."""
    c = cs[..., 0].repeat_interleave(2, dim=-1)
    s = cs[..., 1].repeat_interleave(2, dim=-1)
    x = t.unflatten(-1, (-1, 2))
    rot = torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)
    return t * c + rot * s


def encode(xy, desc, net: dict, image_shape, prec: Precision):
    """(x (n, D) in the activations' type, rotary table (n, dh/2, 2))."""
    H, W = image_shape
    xy = xy.float()
    p = torch.stack([xy[..., 0] - W / 2.0, xy[..., 1] - H / 2.0], dim=-1) / (max(W, H) / 2.0)
    wr = net["posenc.Wr.weight"]
    u = p[..., 0:1] * wr[:, 0] + p[..., 1:2] * wr[:, 1]
    return desc.to(_act(prec)), prec.f32(torch.stack([torch.cos(u), torch.sin(u)], dim=-1))


def self_block(x, cs, net: dict, i: int, heads: int, prec: Precision):
    dt = _act(prec)
    pre = f"transformers.{i}.self_attn."
    n, D = x.shape
    qkv = _linear(x, net[pre + "Wqkv.weight"], net[pre + "Wqkv.bias"], prec)
    qkv = qkv.unflatten(-1, (heads, -1, 3)).transpose(0, 1)  # (h, n, dh, 3)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q, k = rope(q.float(), cs).to(dt), rope(k.float(), cs).to(dt)
    ctx = _attend(q, k, v, prec).transpose(0, 1).reshape(n, D)
    m = _linear(ctx, net[pre + "out_proj.weight"], net[pre + "out_proj.bias"], prec)
    return (x.float() + _ffn(torch.cat([x, m], -1), net, pre + "ffn.", prec).float()).to(dt)


def cross_block(x0, x1, net: dict, i: int, heads: int, prec: Precision):
    dt = _act(prec)
    pre = f"transformers.{i}.cross_attn."
    heads_of = lambda t: t.unflatten(-1, (heads, -1)).transpose(0, 1)  # noqa: E731  (h, n, dh)
    qk0, qk1 = (heads_of(_linear(x, net[pre + "to_qk.weight"], net[pre + "to_qk.bias"], prec)) for x in (x0, x1))
    v0, v1 = (heads_of(_linear(x, net[pre + "to_v.weight"], net[pre + "to_v.bias"], prec)) for x in (x0, x1))
    sim = prec.f32((prec.net(qk0).float() @ prec.net(qk1).float().transpose(-1, -2)) * (1.0 / qk0.shape[-1] ** 0.5))
    m0 = _softmax_v(sim, v1, prec).to(dt)
    m1 = _softmax_v(sim.transpose(-1, -2), v0, prec).to(dt)
    out = []
    for x, m in ((x0, m0), (x1, m1)):
        m = _linear(m.transpose(0, 1).reshape(x.shape), net[pre + "to_out.weight"], net[pre + "to_out.bias"], prec)
        out.append((x.float() + _ffn(torch.cat([x, m], -1), net, pre + "ffn.", prec).float()).to(dt))
    return out


def log_assignment(x0, x1, net: dict, n_layers: int, prec: Precision):
    """(n0, n1) float32 scores of the last layer's assignment."""
    pre = f"log_assignment.{n_layers - 1}."
    D = x0.shape[-1]
    md0, md1 = (_linear(x, net[pre + "final_proj.weight"], net[pre + "final_proj.bias"], prec).float() / D ** 0.25
                for x in (x0, x1))
    sim = prec.f32(prec.net(md0).float() @ prec.net(md1).float().t())
    z0, z1 = ((prec.net(x).float() @ prec.net(net[pre + "matchability.weight"]).float().t())[:, 0]
              + net[pre + "matchability.bias"] for x in (x0, x1))
    cert = F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :]
    return prec.f32(F.log_softmax(sim, dim=1) + F.log_softmax(sim, dim=0) + cert)


def filter_matches(scores, threshold: float):
    """(n0,) matches of set 0 into set 1, -1 where not kept: the mutual
    argmax with exp(score) above ``threshold``."""
    best0, m0 = scores.max(dim=1)
    m1 = scores.argmax(dim=0)
    keep = (m1[m0] == torch.arange(m0.shape[0], device=m0.device)) & (torch.exp(best0) > threshold)
    return torch.where(keep, m0, torch.full_like(m0, -1))


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def forward_pair(xy0, d0, xy1, d1, net: dict, cfg: dict, image_shape, prec: Precision = SOUND, keep=None):
    """(scores (n0, n1), matches (n0,)) of one pair's valid keypoints.
    ``keep``, where given, receives (x0, x1) after every block."""
    with _no_tf32():
        return _forward_pair(xy0, d0, xy1, d1, net, cfg, image_shape, prec, keep)


def _forward_pair(xy0, d0, xy1, d1, net, cfg, image_shape, prec, keep):
    heads, L = cfg["num_heads"], cfg["lightglue_layers"]
    x0, c0 = encode(xy0, d0, net, image_shape, prec)
    x1, c1 = encode(xy1, d1, net, image_shape, prec)
    for i in range(L):
        x0, x1 = self_block(x0, c0, net, i, heads, prec), self_block(x1, c1, net, i, heads, prec)
        if keep is not None:
            keep.append((x0, x1))
        x0, x1 = cross_block(x0, x1, net, i, heads, prec)
        if keep is not None:
            keep.append((x0, x1))
    scores = log_assignment(x0, x1, net, L, prec)
    return scores, filter_matches(scores, cfg["filter_threshold"])


def match(f0: dict, f1: dict, net: dict, cfg: dict, image_shape, prec: Precision = SOUND):
    """(B, K) matches of f0's keypoints into f1's slots, or -1: each pair on
    its valid keypoints alone."""
    B, K = f0["valid"].shape
    out = torch.full((B, K), -1, dtype=torch.long, device=f0["xy"].device)
    for b in range(B):
        i0 = torch.nonzero(f0["valid"][b])[:, 0]
        i1 = torch.nonzero(f1["valid"][b])[:, 0]
        if i0.numel() == 0 or i1.numel() == 0:
            continue
        _, m = forward_pair(f0["xy"][b, i0], f0["desc"][b, i0], f1["xy"][b, i1], f1["desc"][b, i1], net, cfg,
                            image_shape, prec)
        ok = m >= 0
        out[b, i0[ok]] = i1[m[ok]]
    return out
