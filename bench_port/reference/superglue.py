"""SuperGlue (arXiv:1911.11763) as the checkpoint runs it: a keypoint
encoder, alternating self and cross GNN layers, a final projection, the
score matrix and exp-domain Sinkhorn with a dustbin, decoded by mutual
argmax above the match threshold. Products take bf16 operands with float32
sums and bf16 results, bias added in bf16; attention's logits and softmax in
float32 with bf16 probabilities; LayerNorm statistics in float32; the
scores, Sinkhorn and decode in float32."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.common import SOUND, Precision

NEG = -1e9
LN_EPS = 1e-6
_BF = torch.bfloat16


def load_weights(sg_params: dict, n_layers: int, device) -> dict:
    """The flax tree as float32 tensors: kenc (list of (kernel, bias)),
    layers (list of (self, cross) dicts), final (kernel, bias), bin_score."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else t(v) for k, v in d.items()}

    kenc = sg_params["kenc"]
    names = sorted((k for k in kenc if k.startswith("mlp_") and k != "mlp_out"), key=lambda s: int(s[4:]))
    return dict(
        kenc=[(t(kenc[n]["kernel"]), t(kenc[n]["bias"])) for n in names + ["mlp_out"]],
        layers=[(tree(sg_params[f"self_{i}"]), tree(sg_params[f"cross_{i}"])) for i in range(n_layers)],
        final=(t(sg_params["final_proj"]["kernel"]), t(sg_params["final_proj"]["bias"])),
        bin_score=t(sg_params["bin_score"]),
    )


def _dense(x, kernel, bias, prec: Precision):
    """bf16(bf16(x @ kernel) + bias): bf16 operands, float32 sums."""
    y = (prec.net(x).float() @ prec.net(kernel).float()).to(_BF)
    return (y.float() + bias.to(_BF).float()).to(_BF)


def gnn_layer(x, src, src_mask, lp: dict, heads: int, prec: Precision):
    """One layer on (N, K, D) bf16 queries and (N, S, D) bf16 sources."""
    N, K, D = x.shape
    dh = D // heads

    def proj(a, name):
        w = lp["attn"][name]["kernel"].reshape(D, heads, dh).permute(1, 0, 2)  # (h, D, dh)
        b = lp["attn"][name]["bias"].reshape(heads, 1, dh)
        return (((prec.net(a)[:, None].float() @ prec.net(w).float()).to(_BF)).float() + b.to(_BF).float()).to(_BF)

    q, k, v = proj(x, "q"), proj(src, "k"), proj(src, "v")
    logits = (prec.net(q).float() @ prec.net(k).float().transpose(-1, -2)) * (1.0 / dh ** 0.5)
    logits = torch.where(src_mask[:, None, None, :], logits, torch.full_like(logits, NEG))
    p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    msg = (prec.net(p).float() @ prec.net(v).float()).to(_BF)  # (N, h, K, dh)
    wm = lp["attn"]["merge"]["kernel"].reshape(heads, dh, D)
    merged = torch.zeros((N, K, D), dtype=torch.float32, device=x.device)
    for h in range(heads):
        merged = merged + prec.net(msg[:, h]).float() @ prec.net(wm[h]).float()
    merged = (merged.to(_BF).float() + lp["attn"]["merge"]["bias"].to(_BF).float()).to(_BF)
    w0 = lp["mlp0"]["kernel"]
    y = (prec.net(x).float() @ prec.net(w0[:D]).float() + prec.net(merged).float() @ prec.net(w0[D:]).float())
    y = (y.to(_BF).float() + lp["mlp0"]["bias"].to(_BF).float()).to(_BF).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) * (y - mu)).mean(-1, keepdim=True)
    yr = torch.clamp((y - mu) * torch.rsqrt(var + LN_EPS) * lp["ln"]["scale"] + lp["ln"]["bias"], min=0.0).to(_BF)
    delta = ((prec.net(yr).float() @ prec.net(lp["mlp1"]["kernel"]).float()).to(_BF).float()
             + lp["mlp1"]["bias"].to(_BF).float()).to(_BF)
    return (x.float() + delta.float()).to(_BF)


def sinkhorn_decode(scores, valid0, valid1, alpha, iters: int):
    """(best1, sc0, best0, sc1) of exp-domain Sinkhorn with a dustbin."""
    s = scores.float()
    B, K0, K1 = s.shape
    v0 = valid0.float()[:, :, None]
    v1 = valid1.float()[:, None, :]
    s = torch.where(v0 * v1 > 0, s, torch.full_like(s, NEG))
    r = torch.maximum(s.max(dim=2, keepdim=True).values, alpha)
    khat = torch.exp(s - r)
    binc = v0 * torch.exp(alpha - r)
    n0, n1 = v0.sum(dim=(1, 2)), v1.sum(dim=(1, 2))
    A = torch.ones((B, K0, 1), device=s.device)
    V = torch.ones((B, 1, K1), device=s.device)
    Vbin = torch.ones((B,), device=s.device)
    for _ in range(iters):
        A = v0 / torch.clamp((khat * V).sum(2, keepdim=True) + binc * Vbin[:, None, None], min=1e-30)
        Abin = n1 / torch.clamp((v1 * V).sum(dim=(1, 2)) + Vbin, min=1e-30)
        V = v1 / torch.clamp((khat * A).sum(1, keepdim=True) + v1 * Abin[:, None, None], min=1e-30)
        Vbin = n0 / torch.clamp((binc * A).sum(dim=(1, 2)) + Abin, min=1e-30)
    M = khat * V
    Nm = khat * A
    return torch.argmax(M, 2), A[..., 0] * M.max(2).values, torch.argmax(Nm, 1), V[:, 0, :] * Nm.max(1).values


def match(f0: dict, f1: dict, weights: dict, cfg: dict, image_shape, prec: Precision = SOUND):
    """(B, K) matches of f0's keypoints into f1's, or -1."""
    H, W = image_shape
    heads = cfg["num_heads"]
    scale = torch.tensor([W, H], dtype=torch.float32, device=f0["xy"].device)

    def encode(f):
        x = torch.cat([(2.0 * f["xy"] - scale) / float(max(W, H)), f["score"][..., None]], -1).to(_BF)
        *hidden, last = weights["kenc"]
        for kern, b in hidden:
            x = torch.relu(_dense(x, kern, b, prec))
        x = _dense(x, *last, prec)
        return (f["desc"].to(_BF).float() + x.float()).to(_BF)

    x0, x1 = encode(f0), encode(f1)
    v0, v1 = f0["valid"], f1["valid"]
    B = x0.shape[0]
    for self_p, cross_p in weights["layers"]:
        xs = gnn_layer(torch.cat([x0, x1]), torch.cat([x0, x1]), torch.cat([v0, v1]), self_p, heads, prec)
        x0, x1 = xs[:B], xs[B:]
        xc = gnn_layer(torch.cat([x0, x1]), torch.cat([x1, x0]), torch.cat([v1, v0]), cross_p, heads, prec)
        x0, x1 = xc[:B], xc[B:]
    g0 = _dense(x0, *weights["final"], prec).float()
    g1 = _dense(x1, *weights["final"], prec).float()
    scores = prec.f32((g0 @ g1.transpose(1, 2)) / cfg["descriptor_dim"] ** 0.25)
    best1, sc0, best0, _ = sinkhorn_decode(scores, v0, v1, weights["bin_score"], cfg["sinkhorn_iterations"])
    mutual = best0.gather(1, best1) == torch.arange(best1.shape[1], device=best1.device)[None]
    ok = mutual & (sc0 > cfg["match_threshold"]) & v0
    return torch.where(ok, best1, torch.full_like(best1, -1))
