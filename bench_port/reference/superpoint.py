"""SuperPoint (arXiv:1712.07629) as the checkpoint runs it: an optional
space-to-depth stem, a VGG encoder, a 65-channel detector head and a
256-d descriptor head, bf16 convolutions with the bias added after the
output is rounded; keypoints by 9x9 NMS, a threshold, a 4 px border, the
best of each 4x4 block and the top K; descriptors sampled bilinearly on the
coarse grid in bf16 and L2-normalised."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import SOUND, Precision, maxpool_same, top_k

CONVS = ("enc1_0", "enc1_1", "enc2_0", "enc2_1", "enc3_0", "enc3_1", "enc4_0", "enc4_1",
         "det_conv", "det_out", "desc_conv", "desc_out")
BLOCK, BORDER = 4, 4


def load_weights(sp_params: dict, device) -> dict:
    """name -> (OIHW float32 kernel, float32 bias) from the flax tree."""
    p = sp_params.get("net", sp_params)
    return {n: (torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(p[n]["kernel"], np.float32),
                                                                  (3, 2, 0, 1))), device=device),
                torch.as_tensor(np.array(p[n]["bias"], np.float32), device=device)) for n in CONVS}


def network(images, weights: dict, stem: int, prec: Precision = SOUND):
    """(B, H, W) images in [0, 255] -> ((B, H, W) float32 heat,
    (B, H/8, W/8, D) float32 unit descriptors)."""
    B, H, W = images.shape
    x = (images / 255.0).to(torch.bfloat16)
    if stem > 1:
        x = x.reshape(B, H // stem, stem, W // stem, stem).permute(0, 2, 4, 1, 3).reshape(B, stem * stem, H // stem,
                                                                                        W // stem)
    else:
        x = x[:, None]

    def conv(name, x):
        w, b = weights[name]
        return F.conv2d(prec.net(x), prec.net(w), None, padding=w.shape[-1] // 2) + b.to(torch.bfloat16)[None, :,
                                                                                                        None, None]

    n_pools = 3 - {1: 0, 2: 1, 4: 2, 8: 3}[stem]
    for blk in range(1, 5):
        for i in range(2):
            x = torch.relu(conv(f"enc{blk}_{i}", x))
        if blk <= n_pools:
            x = F.max_pool2d(x, 2, 2)
    logits = conv("det_out", torch.relu(conv("det_conv", x))).float()
    heat = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :64], 8)[:, 0]
    d = conv("desc_out", torch.relu(conv("desc_conv", x))).float()
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-8)
    return prec.f32(heat), d.permute(0, 2, 3, 1).contiguous()


def block_maxima(heat, radius: int, threshold: float):
    """Kept heat (NMS winners above the threshold, inside the border) and,
    per 4x4 block, its maximum and the flat index of the first maximum in
    row-major order."""
    B, H, W = heat.shape
    kept = torch.where((heat >= maxpool_same(heat, 2 * radius + 1)) & (heat > threshold), heat,
                       torch.zeros_like(heat))
    ys = torch.arange(H, device=heat.device)[:, None]
    xs = torch.arange(W, device=heat.device)[None, :]
    inside = (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    kept = torch.where(inside, kept, torch.zeros_like(kept))
    Hb, Wb = H // BLOCK, W // BLOCK
    blocks = kept.reshape(B, Hb, BLOCK, Wb, BLOCK).permute(0, 1, 3, 2, 4).reshape(B, Hb, Wb, BLOCK * BLOCK)
    local = torch.argmax(blocks, dim=-1)
    by = torch.arange(Hb, device=heat.device)[:, None] * BLOCK + torch.div(local, BLOCK, rounding_mode="floor")
    bx = torch.arange(Wb, device=heat.device)[None, :] * BLOCK + local % BLOCK
    return blocks.amax(-1), by * W + bx, kept


def sample_descriptors(coarse, xy, prec: Precision = SOUND):
    """Bilinear samples of (B, Hc, Wc, D) coarse descriptors (in the
    network's precision) at (B, K, 2) pixels, L2-normalised."""
    B, Hc, Wc, D = coarse.shape
    flat = prec.net(coarse).reshape(B, Hc * Wc, D)
    u = (xy[..., 0] + 0.5) / 8 - 0.5
    v = (xy[..., 1] + 0.5) / 8 - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u0, v0 = u0.long().clamp(0, Wc - 1), v0.long().clamp(0, Hc - 1)
    u1, v1 = (u0 + 1).clamp(0, Wc - 1), (v0 + 1).clamp(0, Hc - 1)

    def at(vv, uu):
        return flat.gather(1, (vv * Wc + uu)[..., None].expand(-1, -1, D)).float()

    d = (at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u1) * fu * (1 - fv) + at(v1, u0) * (1 - fu) * fv
         + at(v1, u1) * fu * fv)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)


def extract(images, weights: dict, cfg: dict, prec: Precision = SOUND):
    """Keypoints of (B, H, W) images: dict of xy (B, K, 2), score (B, K),
    desc (B, K, D) and valid (B, K). ``cfg``: stem_stride, max_keypoints,
    nms_radius, keypoint_threshold."""
    heat, coarse = network(images, weights, cfg["stem_stride"], prec)
    B, H, W = heat.shape
    K = cfg["max_keypoints"]
    if (H // BLOCK) * (W // BLOCK) >= K and cfg["nms_radius"] >= BLOCK - 1 and H % BLOCK == 0 and W % BLOCK == 0:
        bvals, bidx, _ = block_maxima(heat, cfg["nms_radius"], cfg["keypoint_threshold"])
        vals, t = top_k(bvals.reshape(B, -1), K)
        idx = bidx.reshape(B, -1).gather(1, t)
    else:
        _, _, kept = block_maxima(heat, cfg["nms_radius"], cfg["keypoint_threshold"])
        vals, idx = top_k(kept.reshape(B, H * W), K)
    valid = vals > 0.0
    xy = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()], -1) * valid[..., None]
    return dict(xy=xy, score=vals, desc=sample_descriptors(coarse, xy, prec), valid=valid)
