"""LightGlue (Lindenberger, Sarlin, Pollefeys, *LightGlue: Local Feature
Matching at Light Speed*, ICCV 2023, arXiv:2306.13643; github.com/cvg/LightGlue)
at fixed depth and width, on the port's fused GNN layer.

For each pair, keypoints p (pixels) and unit descriptors d of sets 0 and 1
in an image of W x H:

1. p' = (p - (W/2, H/2)) / (max(W, H) / 2); x = d (``input_proj`` is the
   identity at 256 -> 256).
2. u = p' Wr^T (Wr 32 x 2, written as two products and a sum); the rotary
   table of a token is (cos u_i, sin u_i), each angle shared by the column
   pair (2i, 2i+1) of every 64-wide head.
3. A self block: ``Wqkv`` (output channel 192 h + 3 j + w is head h, dim j,
   q/k/v for w = 0/1/2), q and k rotated, softmax(q k^T / 8) v over the set's
   valid tokens, ``out_proj``, x + FFN([x | m]) with FFN = W2 GELU(LN(W1 z +
   b1)) + b2, LayerNorm eps 1e-5.
4. A cross block: q and k of both sets from one ``to_qk``, v from ``to_v``;
   S = qk0 qk1^T / 8 softmaxed along each axis, m0 = softmax_rows(S) v1,
   m1 = softmax_rows(S^T) v0; x + FFN([x | to_out(m)]).
5. ``n_layers`` layers of a self then a cross block, each with its own
   weights.
6. The assignment of the last layer (``log_assignment.{n-1}``): md =
   final_proj(x) / D^(1/4), sim = md0 md1^T, z = matchability(x),
   score_ij = log_softmax_j(sim)_ij + log_softmax_i(sim)_ij + log sig(z0_i)
   + log sig(z1_j).
7. The filter: the mutual argmax of the scores, kept where exp(score) >
   ``filter_threshold``: ``matches0`` (B, K) int32, -1 elsewhere.

Both sets are fixed-size masked tensors; invalid slots are masked out of
every softmax (attention and both of the assignment's), so a pair's result
is LightGlue's on its valid keypoints alone. Adaptive depth and width (the
confidence heads, early exit, point pruning) are off: a configuration that
asks for them (``depth_confidence`` or ``width_confidence`` >= 0) is
refused, since the heads mean nothing without a trained checkpoint and a
per-pair exit needs a host read in every layer.

Numerics (the ``superpoint_lightglue`` configuration's): bf16 products
with float32 sums and bf16 activations, rounded where the fused layer
rounds (frontend/gnn_kernel.py); the rotary encoding, every softmax, the
LayerNorm, GELU, the assignment's log-softmaxes and log-sigmoids in float32.
The layers run the fused layer kernel for CUDA tensors and its plain
version for CPU tensors; ``dtype=torch.float32`` runs the plain version
rounding nothing, for tests of the algorithm. No function of the matcher reads a device value on the
host.

Weights come as a dict under LightGlue's own state-dict names
(``posenc.Wr.weight``, ``transformers.{i}.self_attn.Wqkv.*``, ``.out_proj.*``,
``.ffn.{0,1,3}.*``, ``transformers.{i}.cross_attn.to_qk.*``, ``.to_v.*``,
``.to_out.*``, ``.ffn.*``, ``log_assignment.{n-1}.final_proj.*``,
``.matchability.*``), so a trained checkpoint can drop in; they are converted
once into the fused layer's layout (``Wqkv`` de-interleaved).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain
from forest_slam_tpu_torch.utils import trace

LN_EPS = 1e-5  # torch.nn.LayerNorm's default, which LightGlue keeps
HEAD_DIM = 64  # the fused layer's head width
NEG = -1e9  # masked entries of the assignment's similarity

_BF = torch.bfloat16


@dataclass(frozen=True)
class LightGlueConfig:
    """LightGlue's ``superpoint`` settings, adaptive depth and width off."""

    descriptor_dim: int = 256
    n_layers: int = 9
    num_heads: int = 4
    filter_threshold: float = 0.1
    depth_confidence: float = -1.0
    width_confidence: float = -1.0

    def __post_init__(self):
        if self.depth_confidence >= 0 or self.width_confidence >= 0:
            raise ValueError(f"adaptive depth and width are not supported (depth_confidence "
                             f"{self.depth_confidence}, width_confidence {self.width_confidence}): set both to -1")
        if self.descriptor_dim % self.num_heads or self.descriptor_dim // self.num_heads != HEAD_DIM:
            raise ValueError(f"LightGlue here takes {HEAD_DIM}-wide heads; got descriptor_dim "
                             f"{self.descriptor_dim} over {self.num_heads} heads")


def split_qkv(w, b, num_heads: int):
    """``Wqkv`` (3D, D) and its bias (3D,), output channel 192 h + 3 j + w
    -> per-head (h, D, dh) kernels and (h, 1, dh) biases of q, k and v."""
    D = w.shape[1]
    dh = D // num_heads
    w = w.reshape(num_heads, dh, 3, D)
    b = b.reshape(num_heads, dh, 3)
    return tuple(t for i in range(3) for t in (w[:, :, i].transpose(1, 2).contiguous(),
                                               b[:, None, :, i].contiguous()))


def _heads(w, b, num_heads: int):
    """A (D, D) projection whose output channel h * dh + j is head h, dim j
    -> (h, D, dh) kernel and (h, 1, dh) bias."""
    D = w.shape[1]
    dh = D // num_heads
    return w.t().reshape(D, num_heads, dh).permute(1, 0, 2).contiguous(), b.reshape(num_heads, 1, dh).contiguous()


def _tail(sd: dict, prefix: str, out: str, num_heads: int):
    """The merge and FFN weights of a block in the layer's layout: the
    output projection ``out`` by head (h, dh, D), FFN.0 split into the rows
    acting on x and on the message, LayerNorm in float32, FFN.3."""
    D = sd[prefix + out + ".weight"].shape[0]
    wm = sd[prefix + out + ".weight"].t().reshape(num_heads, D // num_heads, D).contiguous()
    w0 = sd[prefix + "ffn.0.weight"].t()
    return (wm, sd[prefix + out + ".bias"].reshape(1, D), w0[:D].contiguous(), w0[D:].contiguous(),
            sd[prefix + "ffn.0.bias"].reshape(1, 2 * D)), (
        sd[prefix + "ffn.1.weight"].reshape(1, 2 * D), sd[prefix + "ffn.1.bias"].reshape(1, 2 * D)), (
        sd[prefix + "ffn.3.weight"].t().contiguous(), sd[prefix + "ffn.3.bias"].reshape(1, D))


def layer_weights(sd: dict, i: int, kind: str, num_heads: int, dtype=_BF, device=None) -> tuple:
    """Block ``kind`` ("self" or "cross") of layer ``i`` of a state dict as
    the fused layer's weight tuple (gnn_kernel.split_layer_params' layout):
    products' weights in ``dtype``, LayerNorm in float32. A cross block's q
    and k kernels are both ``to_qk``."""
    f32 = {k: v.detach().float().to(device) for k, v in sd.items()
           if k.startswith(f"transformers.{i}.{kind}_attn.")}
    prefix = f"transformers.{i}.{kind}_attn."
    if kind == "self":
        qkv = split_qkv(f32[prefix + "Wqkv.weight"], f32[prefix + "Wqkv.bias"], num_heads)
    elif kind == "cross":
        qk = _heads(f32[prefix + "to_qk.weight"], f32[prefix + "to_qk.bias"], num_heads)
        qkv = qk + qk + _heads(f32[prefix + "to_v.weight"], f32[prefix + "to_v.bias"], num_heads)
    else:
        raise ValueError(f"unknown block {kind!r}")
    merge_mlp0, ln, mlp1 = _tail(f32, prefix, "out_proj" if kind == "self" else "to_out", num_heads)
    net = tuple(t.to(dtype) for t in qkv + merge_mlp0)
    return net + tuple(t.contiguous() for t in ln) + tuple(t.to(dtype) for t in mlp1)


class LightGlue:
    """The matcher with its weights in the fused layer's layout. Each step is
    a method, so tests can compare every block; :meth:`match` runs them
    all."""

    def __init__(self, cfg: LightGlueConfig, state_dict: dict, device=None, dtype=_BF):
        n = cfg.n_layers
        held = {int(k.split(".")[1]) for k in state_dict if k.startswith("transformers.")}
        if held != set(range(n)):
            raise ValueError(f"the state dict holds layers {sorted(held)}; the configuration runs {n}")
        if dtype != _BF and dtype != torch.float32:
            raise ValueError(f"dtype bf16 (the kernel's) or float32 (tests); got {dtype}")
        self.cfg, self.dtype = cfg, dtype
        h = cfg.num_heads
        self.self_w = [layer_weights(state_dict, i, "self", h, dtype, device) for i in range(n)]
        self.cross_w = [layer_weights(state_dict, i, "cross", h, dtype, device) for i in range(n)]
        f32 = lambda k: state_dict[k].detach().float().to(device).contiguous()  # noqa: E731
        self.wr = f32("posenc.Wr.weight")  # (dh / 2, 2)
        la = f"log_assignment.{n - 1}."
        self.final_w, self.final_b = f32(la + "final_proj.weight").t().to(dtype), f32(la + "final_proj.bias")
        self.match_w, self.match_b = f32(la + "matchability.weight").t().to(dtype), f32(la + "matchability.bias")
        self._layer = gnn_layer if dtype == _BF else (lambda *a, **kw: gnn_layer_plain(*a, **kw, dtype=dtype))

    def encode(self, xy, desc, image_shape):
        """(x (B, K, D) in the activations' type, rotary table (B, K, dh/2, 2)
        float32 of (cos u, sin u)) of one set."""
        H, W = image_shape
        xy = xy.float()
        p = torch.stack([xy[..., 0] - W / 2.0, xy[..., 1] - H / 2.0], dim=-1) / (max(W, H) / 2.0)
        u = p[..., 0:1] * self.wr[:, 0] + p[..., 1:2] * self.wr[:, 1]
        return desc.to(self.dtype), torch.stack([torch.cos(u), torch.sin(u)], dim=-1).contiguous()

    def self_block(self, i: int, x, valid, rope):
        """Layer ``i``'s self block on (N, K, D) tokens of N sets."""
        return self._layer(x, x, valid, self.self_w[i], self.cfg.num_heads, rope=rope, ln_eps=LN_EPS, gelu=True)

    def cross_block(self, i: int, x0, x1, valid0, valid1):
        """Layer ``i``'s cross block: both directions in one layer call."""
        B = x0.shape[0]
        xq = torch.cat([x0, x1]).contiguous()
        xs = torch.cat([x1, x0]).contiguous()
        out = self._layer(xq, xs, torch.cat([valid1, valid0]), self.cross_w[i], self.cfg.num_heads,
                          ln_eps=LN_EPS, gelu=True)
        return out[:B], out[B:]

    def _dense(self, x, w, b):
        """bf16(bf16(x @ w) + b), in the activations' type."""
        return ((x.float() @ w.float()).to(self.dtype).float() + b.to(self.dtype).float()).to(self.dtype)

    def log_assignment(self, x0, x1, valid0, valid1):
        """(B, K0, K1) float32 scores; entries with an invalid end are the
        finite leftovers of the mask, never a valid row's or column's
        maximum."""
        scale = self.cfg.descriptor_dim ** 0.25
        md0 = self._dense(x0, self.final_w, self.final_b).float() / scale
        md1 = self._dense(x1, self.final_w, self.final_b).float() / scale
        sim = md0 @ md1.transpose(1, 2)
        sim = torch.where(valid0[:, :, None] & valid1[:, None, :], sim, torch.full_like(sim, NEG))
        z0 = (x0.float() @ self.match_w.float())[..., 0] + self.match_b
        z1 = (x1.float() @ self.match_w.float())[..., 0] + self.match_b
        cert = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        return F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1) + cert

    def filter(self, scores, valid0, valid1):
        """(B, K0) int32 ``matches0``: the mutual argmax, kept where
        exp(score) passes the threshold and both ends are valid."""
        best0, m0 = scores.max(dim=2)
        m1 = scores.argmax(dim=1)
        mutual = m1.gather(1, m0) == torch.arange(m0.shape[1], device=m0.device)[None]
        keep = mutual & valid0 & valid1.gather(1, m0) & (torch.exp(best0) > self.cfg.filter_threshold)
        return torch.where(keep, m0, torch.full_like(m0, -1)).to(torch.int32)

    @torch.no_grad()
    def match(self, xy0, desc0, valid0, xy1, desc1, valid1, image_shape):
        """(B, K0) int32 ``matches0`` of B pairs of keypoint sets, in the
        spans ``fs.lightglue.encode``, ``.self`` and ``.cross`` (one each a
        layer, with ``layer`` and ``tokens``) and ``.assign``."""
        B = xy0.shape[0]
        with trace.span("fs.lightglue.encode"):
            x0, r0 = self.encode(xy0, desc0, image_shape)
            x1, r1 = self.encode(xy1, desc1, image_shape)
            rope = torch.cat([r0, r1]).contiguous()
            valid = torch.cat([valid0, valid1])
        tokens = 2 * B * xy0.shape[1]
        for i in range(self.cfg.n_layers):
            with trace.span("fs.lightglue.self", layer=i, tokens=tokens):
                xs = self.self_block(i, torch.cat([x0, x1]).contiguous(), valid, rope)
                x0, x1 = xs[:B], xs[B:]
            with trace.span("fs.lightglue.cross", layer=i, tokens=tokens):
                x0, x1 = self.cross_block(i, x0, x1, valid0, valid1)
        with trace.span("fs.lightglue.assign"):
            return self.filter(self.log_assignment(x0, x1, valid0, valid1), valid0, valid1)
