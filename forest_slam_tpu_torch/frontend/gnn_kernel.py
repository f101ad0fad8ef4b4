"""One SuperGlue or LightGlue GNN layer for inference: the CUDA kernel and
its plain version.

Counterpart of frontend/pallas_gnn.py (``fused_gnn_layer``,
``split_layer_params``). The kernel is ``csrc/gnn_layer.cu``;
:func:`gnn_layer_plain` computes the same layer with tensor ops, casting to
bf16 at the same points. :func:`gnn_layer` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors.

Weights come as the tuple :func:`split_layer_params` builds, the layout of
the TPU kernel: per-head q/k/v kernels (h, D, dh) and biases (h, 1, dh),
the merge kernel grouped by head (h, dh, D), MLP0 split into the rows acting
on x and on the message (D, 2D) each, LayerNorm scale and bias in float32.

LightGlue's layers (frontend/lightglue.py) take the same weights in the same
layout and three options: ``rope``, a per-token (cos, sin) table that
rotates q and k after their bf16 projection (a self layer), ``gelu`` (exact
erf GELU after the LayerNorm, in place of ReLU) and ``ln_eps``. The plain version also
takes ``dtype``: its activations' type, bf16 as the kernel rounds, or
float32 for tests of the algorithm.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from forest_slam_tpu_torch import _build
from forest_slam_tpu_torch.frontend.attention_kernel import masked_attention_plain

LN_EPS = 1e-6  # flax.linen.LayerNorm default

_BF = torch.bfloat16


def split_layer_params(lp: dict, num_heads: int, device=None) -> tuple:
    """GnnLayer parameters in the Flax subtree's layout ({attn: {q, k, v,
    merge}, mlp0, ln, mlp1}, leaves numpy arrays or float32 tensors) ->
    kernel-layout tuple, on ``device`` (default: the tensors' own, the CPU
    for numpy). Differentiable in tensor leaves: the trainer's graph runs
    through it to the float32 masters."""

    def f32(a):
        t = a.float() if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a, np.float32))
        return t if device is None else t.to(device)

    def bf(a):
        return f32(a).to(_BF)

    D = lp["attn"]["q"]["kernel"].shape[0]
    dh = D // num_heads

    def qkv(name):
        w = bf(lp["attn"][name]["kernel"]).reshape(D, num_heads, dh).permute(1, 0, 2)
        b = bf(lp["attn"][name]["bias"]).reshape(num_heads, 1, dh)
        return w.contiguous(), b.contiguous()

    wq, bq = qkv("q")
    wk, bk = qkv("k")
    wv, bv = qkv("v")
    wm = bf(lp["attn"]["merge"]["kernel"]).reshape(num_heads, dh, D).contiguous()
    bm = bf(lp["attn"]["merge"]["bias"]).reshape(1, D)
    w0 = bf(lp["mlp0"]["kernel"])  # (2D, 2D)
    w0a, w0b = w0[:D].contiguous(), w0[D:].contiguous()
    b0 = bf(lp["mlp0"]["bias"]).reshape(1, 2 * D)
    lns = f32(lp["ln"]["scale"]).reshape(1, 2 * D).contiguous()
    lnb = f32(lp["ln"]["bias"]).reshape(1, 2 * D).contiguous()
    w1 = bf(lp["mlp1"]["kernel"])  # (2D, D)
    b1 = bf(lp["mlp1"]["bias"]).reshape(1, D)
    return (wq, bq, wk, bk, wv, bv, wm, bm, w0a, w0b, b0, lns, lnb, w1, b1)


def _mm(a, b):
    """float32 product of bf16 operands (exact products, float32 sums)."""
    return a.float() @ b.float()


def _bf(x):
    return x.to(_BF)


def project_heads(a, w, b, dtype=_BF):
    """(N, L, D) @ per-head (h, D, dh) weights + (h, 1, dh) biases ->
    (N, h, L, dh), rounded as Dense(bf16) rounds: bf16(bf16(a @ w) + b)
    (``dtype`` in place of bf16)."""
    return (((a[:, None].float() @ w.float()).to(dtype)).float() + b.float()).to(dtype)


def rope_rotate(t, rope):
    """LightGlue's rotary encoding of (N, h, L, 64) float32 heads by a
    per-token (N, L, 32, 2) table of (cos u_i, sin u_i): t c + rot(t) s,
    c and s each angle repeated for its column pair, rot(t)[2i] = -t[2i+1],
    rot(t)[2i+1] = t[2i]; float32 products and sum, as the kernel's
    epilogue rounds them."""
    c = rope[..., 0].repeat_interleave(2, dim=-1)[:, None]
    s = rope[..., 1].repeat_interleave(2, dim=-1)[:, None]
    pairs = t.unflatten(-1, (-1, 2))
    rot = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return t * c + rot * s


def gnn_layer_plain(x, src, src_mask, weights: tuple, num_heads: int, rope=None, ln_eps: float = LN_EPS,
                    gelu: bool = False, dtype=_BF):
    """(N, K, D) -> (N, K, D) in ``dtype``: one GNN layer, the TPU kernel's
    numerics (f32 logits and softmax, bf16 probabilities and messages). Its
    attention is :func:`masked_attention_plain` on the head-split
    projections, as the kernel's is the attention kernel's core. ``rope``
    ((N, K, 32, 2) float32, src holding x's tokens) rotates q and k;
    ``gelu`` takes GELU in place of ReLU; ``dtype`` float32 rounds nothing."""
    wq, bq, wk, bk, wv, bv, wm, bm, w0a, w0b, b0, lns, lnb, w1, b1 = weights

    def rd(t):
        return t.to(dtype)

    x = rd(x)
    src = rd(src)
    dh = x.shape[-1] // num_heads
    q, k = project_heads(x, wq, bq, dtype), project_heads(src, wk, bk, dtype)
    if rope is not None:
        q, k = rd(rope_rotate(q.float(), rope)), rd(rope_rotate(k.float(), rope))
    msg = masked_attention_plain(q, k, project_heads(src, wv, bv, dtype), src_mask.bool(),
                                 1.0 / dh ** 0.5)  # (N, h, K, dh)
    merged = torch.zeros_like(x, dtype=torch.float32)
    for h in range(num_heads):  # the merge accumulated head by head, as the TPU kernel does
        merged = merged + _mm(msg[:, h], wm[h])
    merged = rd(rd(merged).float() + bm.float())
    y = rd(rd(_mm(x, w0a) + _mm(merged, w0b)).float() + b0.float())
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = ((yf - mu) * (yf - mu)).mean(dim=-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + ln_eps) * lns + lnb
    yr = rd(F.gelu(yn) if gelu else torch.clamp(yn, min=0.0))
    delta = rd(rd(_mm(yr, w1)).float() + b1.float())
    return rd(x.float() + delta.float())


def gnn_layer(x, src, src_mask, weights: tuple, num_heads: int, rope=None, ln_eps: float = LN_EPS,
              gelu: bool = False):
    """One GNN layer on (N, K, D) bf16 queries and (N, S, D) bf16 sources
    with an (N, S) bool source mask: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``rope``, ``ln_eps`` and ``gelu`` as
    :func:`gnn_layer_plain` takes them. The kernel has no backward, so under
    autograd with an input or weight that requires grad it raises, on every
    device (the trainer takes the unfused layer)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, src, *weights)):
        raise RuntimeError("gnn_layer (the fused GNN layer kernel) has no backward: run it under torch.no_grad, "
                           "or differentiate the unfused layer (gnn_impl='xla')")
    if x.device.type == "cpu":
        return gnn_layer_plain(x, src, src_mask, weights, num_heads, rope, ln_eps, gelu)
    if x.dim() != 3 or src.dim() != 3 or x.shape[0] != src.shape[0] or x.shape[2] != src.shape[2]:
        raise ValueError(f"gnn_layer needs (N, K, D) and (N, S, D); got {tuple(x.shape)}, {tuple(src.shape)}")
    N, K, D = x.shape
    S = src.shape[1]
    if D % num_heads or D // num_heads != 64:
        raise ValueError(f"the gnn_layer kernel takes 64-wide heads; got D={D}, heads={num_heads}")
    if src_mask.shape != (N, S) or src_mask.dtype != torch.bool:
        raise ValueError(f"src_mask must be (N, S) bool; got {tuple(src_mask.shape)} {src_mask.dtype}")
    dev = x.device
    mask = src_mask.contiguous()
    for t in (x, src, mask, *weights):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gnn_layer inputs and weights must be contiguous on one device")
        if t is not mask and t.data_ptr() % 16:
            raise ValueError("gnn_layer inputs and weights must be 16-byte aligned")
    if x.dtype != _BF or src.dtype != _BF:
        raise ValueError(f"gnn_layer takes bf16 activations; got {x.dtype}, {src.dtype}")
    if rope is not None:
        if src.shape != x.shape or tuple(rope.shape) != (N, K, D // num_heads // 2, 2):
            raise ValueError(f"rope takes a self layer's (N, K, {D // num_heads // 2}, 2) table; got "
                             f"{tuple(rope.shape)} for x {tuple(x.shape)}, src {tuple(src.shape)}")
        if rope.dtype != torch.float32 or rope.device != dev or not rope.is_contiguous() or rope.data_ptr() % 16:
            raise ValueError("rope must be a contiguous, 16-byte aligned float32 table on the inputs' device")
    wq, bq, wk, bk, wv, bv, wm, bm, w0a, w0b, b0, lns, lnb, w1, b1 = weights
    # the kernel's intermediates in one allocation (each piece a multiple of
    # 64 bf16 rows wide, so every piece stays 16-byte aligned)
    rows = (N * K, N * S, N * S, N * K, N * K, 2 * N * K, 2 * N * K)
    qs, ks, vs, os_, ms, ys, yr = torch.empty((sum(rows), D), dtype=_BF, device=dev).split(rows)
    out = torch.empty((N, K, D), dtype=_BF, device=dev)
    ptrs = [t.data_ptr() for t in (x, src, mask, wq, bq, wk, bk, wv, bv, wm, bm, w0a, w0b, b0,
                                   lns, lnb, w1, b1, qs, ks, vs, os_, ms, ys, yr, out)]
    fn = _build.function("fs_gnn_layer", *[_build.P] * 26, *[_build.I] * 5, _build.P, ctypes.c_float, _build.I,
                         _build.P)
    rc = fn(*ptrs, N, K, S, D, num_heads, None if rope is None else rope.data_ptr(), float(ln_eps),
            int(gelu), _build.stream_ptr(dev))
    _build.check("fs_gnn_layer", rc)
    gnn_layer.launches += 1
    return out


gnn_layer.launches = 0
