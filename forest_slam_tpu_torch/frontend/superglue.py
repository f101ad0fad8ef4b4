"""SuperGlue-style attentional graph matcher (port of frontend/superglue.py
and the fused forward of frontend/pallas_gnn.py).

Keypoint-position encoder, 2 x gnn_layers alternating self/cross GNN layers,
final projection, and Sinkhorn with a dustbin decoded into the ``matches0`` /
``matching_scores0`` contract, or, with ``return_couplings=True`` (training),
the log-domain Sinkhorn's log-couplings. Both keypoint sets are fixed-size
masked tensors. A GNN layer runs either whole in the fused kernel's numerics
(``gnn_impl="auto"``/``"plain"``: f32 softmax, bf16 probabilities) or as the
Flax module's unfused per-op layer (``gnn_impl="xla"``, and always under
``return_couplings``: bf16 Dense projections, the masked attention of
``attention_impl``, the merge, the MLP with Flax's LayerNorm, the residual).

Every weight is a float32 parameter cast to bf16 where Flax casts it: the
GNN layers hold the Flax subtree's Dense and LayerNorm parameters
(``params.Dense``, ``params.LayerNorm``) and derive the kernel-layout bf16
tuple from them once per parameter version outside autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from forest_slam_tpu_torch.frontend.attention_kernel import masked_attention, masked_attention_plain
from forest_slam_tpu_torch.frontend.gnn_kernel import (
    LN_EPS,
    _bf,
    gnn_layer,
    gnn_layer_plain,
    project_heads,
    split_layer_params,
)
from forest_slam_tpu_torch.frontend.params import Dense, LayerNorm, cached_copy
from forest_slam_tpu_torch.frontend.sinkhorn_kernel import (
    sinkhorn_decode,
    sinkhorn_decode_plain,
)

NEG = -1e9


class SuperGlueConfig(NamedTuple):
    descriptor_dim: int = 256
    keypoint_encoder_dims: tuple = (32, 64, 128, 256)
    gnn_layers: int = 9  # 9 x (self + cross)
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    # "auto" (or the JAX name "fused"): the CUDA kernels for CUDA tensors
    # (their plain versions on CPU); "plain": the plain versions on any
    # device. gnn_impl "xla" runs the unfused per-op layer (bench.py
    # --sg-gnn xla) with attention_impl.
    gnn_impl: str = "auto"
    sinkhorn_impl: str = "auto"
    # attention of the unfused layer: "auto" (or "fused") the differentiable
    # attention Function (the kernel for CUDA tensors), "plain" its plain
    # version on any device, "xla" the dense einsum + softmax in
    # softmax_dtype (bench.py --sg-attention xla), "flash" the stock library
    # op, torch's scaled_dot_product_attention (bench.py --sg-attention
    # flash: the stock Pallas flash op there); training takes the one
    # configured
    attention_impl: str = "auto"
    softmax_dtype: str = "float32"  # or "bfloat16"


class MatchResult(NamedTuple):
    matches0: torch.Tensor  # (B, K) int32: index into kpts1 or -1
    matches1: torch.Tensor  # (B, K) int32: index into kpts0 or -1
    matching_scores0: torch.Tensor  # (B, K) float32
    matching_scores1: torch.Tensor  # (B, K) float32


def _dense(x, lin: nn.Linear):
    """nn.Dense(dtype=bf16) numerics: bf16 operands, float32 sums, bf16
    result, bf16 bias add."""
    bf = torch.bfloat16
    y = (x.to(bf).float() @ lin.weight.to(bf).float().t()).to(bf)
    return (y.float() + lin.bias.to(bf).float()).to(bf)


class KeypointEncoder(nn.Module):
    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        dims = (3,) + tuple(cfg.keypoint_encoder_dims)
        self.mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.mlp_out = nn.Linear(dims[-1], cfg.descriptor_dim)

    def forward(self, xy_norm, score):
        x = torch.cat([xy_norm, score[..., None]], dim=-1).to(torch.bfloat16)
        for lin in self.mlp:
            x = torch.relu(_dense(x, lin))
        return _dense(x, self.mlp_out)


def dense_attention(q, k, v, source_mask, softmax_dtype: str = "float32"):
    """The Flax module's dense attention path (superglue.py:205-218) on
    (B, h, K, dh) bf16 heads: bf16 logits, softmax in ``softmax_dtype``
    rounding after each op as XLA does, bf16 probabilities and output."""
    if softmax_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown softmax_dtype {softmax_dtype!r}")
    sdt = getattr(torch, softmax_dtype)
    dh = q.shape[-1]
    logits = _bf(q.float() @ k.float().transpose(-1, -2)).to(sdt)
    logits = logits / torch.tensor(dh ** 0.5, dtype=sdt, device=q.device)
    logits = torch.where(source_mask[:, None, None, :], logits, torch.tensor(NEG, dtype=sdt, device=q.device))
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    attn = _bf(e / e.float().sum(dim=-1, keepdim=True).to(sdt))
    return _bf(attn.float() @ v.float())


def flash_attention(q, k, v, source_mask):
    """The stock library op on (B, h, K, dh) bf16 heads:
    ``scaled_dot_product_attention`` over the valid sources. A sequence
    whose sources are all masked averages v over all of them, as the dense
    path's finite NEG mask makes it do (the library op gives NaN there):
    it attends with zero queries over every source."""
    import torch.nn.functional as F

    dead = ~source_mask.any(dim=-1, keepdim=True)  # (B, 1)
    q = torch.where(dead[:, :, None, None], torch.zeros_like(q), q)
    mask = (source_mask | dead)[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0 / q.shape[-1] ** 0.5)


def attention(q, k, v, source_mask, impl: str = "auto", softmax_dtype: str = "float32"):
    """Masked multi-head attention of (B, h, K, dh) bf16 heads by
    ``attention_impl``."""
    if impl == "xla":
        return dense_attention(q, k, v, source_mask, softmax_dtype)
    if impl == "flash":
        return flash_attention(q, k, v, source_mask)
    scale = 1.0 / q.shape[-1] ** 0.5
    if impl in ("auto", "fused"):
        return masked_attention(q, k, v, source_mask, scale)
    if impl == "plain":
        return masked_attention_plain(q, k, v, source_mask, scale)
    raise ValueError(f"unknown attention_impl {impl!r}")


def gnn_layer_unfused(x, src, src_mask, weights: tuple, num_heads: int, attention_impl: str = "auto",
                      softmax_dtype: str = "float32"):
    """(N, K, D) bf16 -> (N, K, D) bf16: the Flax GnnLayer op by op
    (superglue.py:151-235). Takes the fused kernel's split weights
    (gnn_kernel.split_layer_params), which hold the same values as the Flax
    Dense kernels: per-head q/k/v columns, merge rows grouped by head, MLP0
    split into the rows acting on x and on the message."""
    wq, bq, wk, bk, wv, bv, wm, bm, w0a, w0b, b0, lns, lnb, w1, b1 = weights
    x = _bf(x)
    src = _bf(src)
    msg = attention(project_heads(x, wq, bq), project_heads(src, wk, bk), project_heads(src, wv, bv), src_mask,
                    attention_impl, softmax_dtype)
    merged = _bf(_bf(torch.einsum("nhkd,hde->nke", msg.float(), wm.float())).float() + bm.float())
    y = _bf(_bf(x.float() @ w0a.float() + merged.float() @ w0b.float()).float() + b0.float())
    # flax.linen.LayerNorm(dtype=bf16): float32 statistics with the fast
    # variance E[y^2] - E[y]^2, then (y - mean) * (rsqrt(var + eps) * scale)
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = torch.clamp((yf * yf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    yr = torch.relu(_bf((yf - mu) * (torch.rsqrt(var + LN_EPS) * lns) + lnb))
    delta = _bf(_bf(yr.float() @ w1.float()).float() + b1.float())
    return _bf(x.float() + delta.float())


class GnnLayer(nn.Module):
    """One self or cross layer. Its float32 parameters are the Flax
    subtree's, one to one (``attn.{q,k,v,merge}``, ``mlp0``, ``ln``,
    ``mlp1``); :meth:`weights` derives gnn_kernel.split_layer_params' bf16
    tuple from them, used by the fused kernel, its plain version and the
    unfused layer alike."""

    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        D = cfg.descriptor_dim
        self.attn = nn.ModuleDict({n: Dense(D, D) for n in ("q", "k", "v", "merge")})
        self.mlp0 = Dense(2 * D, 2 * D)
        self.ln = LayerNorm(2 * D)
        self.mlp1 = Dense(2 * D, D)
        self.num_heads = cfg.num_heads
        self.cfg = cfg

    def flax_params(self) -> dict:
        """The parameters as the Flax subtree's nested dict of tensors."""
        def tree(m):
            return {n: p for n, p in m.named_parameters(recurse=False)} or {n: tree(c) for n, c in m.named_children()}

        return tree(self)

    def weights(self) -> tuple:
        return cached_copy(self, lambda: split_layer_params(self.flax_params(), self.num_heads))

    def forward(self, x, src, src_mask, unfused: bool = False):
        impl = "xla" if unfused else self.cfg.gnn_impl
        if impl == "xla":
            return gnn_layer_unfused(x, src, src_mask, self.weights(), self.num_heads, self.cfg.attention_impl,
                                     self.cfg.softmax_dtype)
        if impl == "plain":
            return gnn_layer_plain(x, src, src_mask, self.weights(), self.num_heads)
        if impl not in ("auto", "fused"):
            raise ValueError(f"unknown gnn_impl {impl!r}")
        return gnn_layer(x, src, src_mask, self.weights(), self.num_heads)


def log_sinkhorn(scores, valid0, valid1, alpha, iters: int):
    """Masked log-domain Sinkhorn with a dustbin row and column; returns
    (B, K0+1, K1+1) log-couplings."""
    B, K0, K1 = scores.shape
    dev = scores.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    pair = valid0[:, :, None] & valid1[:, None, :]
    s = torch.where(pair, scores, neg)
    bin0 = torch.where(valid0, alpha, neg)[:, :, None]
    bin1 = torch.where(valid1, alpha, neg)[:, None, :]
    corner = alpha.expand(B, 1, 1)
    couplings = torch.cat([torch.cat([s, bin0], 2), torch.cat([bin1, corner], 2)], 1)
    n0 = valid0.sum(1).float()
    n1 = valid1.sum(1).float()
    norm = torch.log(torch.clamp(n0 + n1, min=1.0))[:, None]
    zero = torch.zeros((), device=dev)
    log_mu = torch.cat([torch.where(valid0, zero, neg), torch.log(torch.clamp(n1, min=1.0))[:, None]], 1) - norm
    log_nu = torch.cat([torch.where(valid1, zero, neg), torch.log(torch.clamp(n0, min=1.0))[:, None]], 1) - norm
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] + norm[:, :, None]


def _mutual_decode(best1, sc0, best0, sc1, valid0, valid1, threshold: float) -> MatchResult:
    K0 = best1.shape[1]
    K1 = best0.shape[1]
    best1 = best1.long()
    best0 = best0.long()
    i0 = torch.arange(K0, device=best1.device)[None, :]
    i1 = torch.arange(K1, device=best1.device)[None, :]
    mutual0 = best0.gather(1, best1) == i0
    mutual1 = best1.gather(1, best0) == i1
    ok0 = mutual0 & (sc0 > threshold) & valid0
    ok1 = mutual1 & (sc1 > threshold) & valid1
    minus = torch.full_like(best1, -1)
    return MatchResult(
        matches0=torch.where(ok0, best1, minus).to(torch.int32),
        matches1=torch.where(ok1, best0, torch.full_like(best0, -1)).to(torch.int32),
        matching_scores0=torch.where(valid0, sc0, torch.zeros_like(sc0)),
        matching_scores1=torch.where(valid1, sc1, torch.zeros_like(sc1)),
    )


def match_from_couplings(log_p, valid0, valid1, threshold: float) -> MatchResult:
    """Mutual-argmax + threshold decoding of Sinkhorn log-couplings."""
    p = log_p[:, :-1, :-1]
    best1 = torch.argmax(p, dim=2)
    best0 = torch.argmax(p, dim=1)
    sc0 = torch.exp(p.max(dim=2).values)
    sc1 = torch.exp(p.max(dim=1).values)
    return _mutual_decode(best1, sc0, best0, sc1, valid0, valid1, threshold)


def match_decode(scores, valid0, valid1, alpha, iters: int, threshold: float, impl: str = "auto") -> MatchResult:
    """Exp-domain Sinkhorn decode (kernel or plain) -> MatchResult."""
    if impl == "plain":
        out = sinkhorn_decode_plain(scores, valid0, valid1, alpha, iters)
    elif impl == "auto":
        out = sinkhorn_decode(scores, valid0, valid1, alpha, iters)
    else:
        raise ValueError(f"unknown sinkhorn_impl {impl!r}")
    return _mutual_decode(*out, valid0, valid1, threshold)


class SuperGlue(nn.Module):
    """Match two fixed-size keypoint sets."""

    def __init__(self, cfg: SuperGlueConfig):
        super().__init__()
        self.cfg = cfg
        self.kenc = KeypointEncoder(cfg)
        self.layers = nn.ModuleDict({f"{kind}_{i}": GnnLayer(cfg) for i in range(cfg.gnn_layers)
                                     for kind in ("self", "cross")})
        self.final_proj = nn.Linear(cfg.descriptor_dim, cfg.descriptor_dim)
        self.bin_score = nn.Parameter(torch.ones(()))

    def forward(self, xy0, score0, desc0, valid0, xy1, score1, desc1, valid1, image_shape,
                return_couplings: bool = False):
        """MatchResult, or with ``return_couplings`` the (B, K0+1, K1+1)
        log-couplings of the log-domain Sinkhorn, through the unfused GNN
        layers (superglue.py:327-345: training takes the Flax module)."""
        cfg = self.cfg
        H, W = image_shape
        scale = torch.tensor([W, H], dtype=torch.float32, device=xy0.device)

        def norm_xy(xy):
            return (2.0 * xy - scale) / float(max(W, H))

        bf = torch.bfloat16
        x0 = (desc0.to(bf).float() + self.kenc(norm_xy(xy0), score0).float()).to(bf)
        x1 = (desc1.to(bf).float() + self.kenc(norm_xy(xy1), score1).float()).to(bf)
        B = x0.shape[0]
        for i in range(cfg.gnn_layers):
            xs = torch.cat([x0, x1]).contiguous()
            vs = torch.cat([valid0, valid1])
            xs = self.layers[f"self_{i}"](xs, xs, vs, return_couplings)
            x0, x1 = xs[:B], xs[B:]
            xq = torch.cat([x0, x1]).contiguous()
            xsrc = torch.cat([x1, x0]).contiguous()
            vsrc = torch.cat([valid1, valid0])
            xc = self.layers[f"cross_{i}"](xq, xsrc, vsrc, return_couplings)
            x0, x1 = xc[:B], xc[B:]
        f0 = _dense(x0, self.final_proj).float()
        f1 = _dense(x1, self.final_proj).float()
        scores = (f0 @ f1.transpose(1, 2)) / cfg.descriptor_dim ** 0.25
        if return_couplings:
            return log_sinkhorn(scores, valid0, valid1, self.bin_score, cfg.sinkhorn_iterations)
        return match_decode(
            scores.contiguous(), valid0, valid1, self.bin_score, cfg.sinkhorn_iterations,
            cfg.match_threshold, impl=cfg.sinkhorn_impl,
        )
