"""Exp-domain Sinkhorn + match decode: the CUDA kernel and its plain version.

Counterpart of frontend/pallas_sinkhorn.py (``sinkhorn_decode`` /
``match_decode``). The kernel is ``csrc/sinkhorn.cu``;
:func:`sinkhorn_decode_plain` runs the same iteration with tensor ops
(iteration for iteration the TPU kernel's, and equivalent to
superglue.log_sinkhorn + match_from_couplings). :func:`sinkhorn_decode`
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors.
"""

from __future__ import annotations

import torch

from forest_slam_tpu_torch import _build

NEG = -1e9
_TINY = 1e-30


def sinkhorn_decode_plain(scores, valid0, valid1, alpha, iters: int):
    """(best1, sc0, best0, sc1) of ``iters`` exp-domain Sinkhorn iterations
    on (B, K0, K1) scores with a dustbin at ``alpha``."""
    s = scores.float()
    B, K0, K1 = s.shape
    v0 = valid0.float()[:, :, None]  # (B, K0, 1)
    v1 = valid1.float()[:, None, :]  # (B, 1, K1)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=s.device)
    s = torch.where(v0 * v1 > 0, s, torch.full_like(s, NEG))
    r = torch.maximum(s.max(dim=2, keepdim=True).values, alpha)
    khat = torch.exp(s - r)
    binc = v0 * torch.exp(alpha - r)  # (B, K0, 1)
    n0 = v0.sum(dim=(1, 2))  # (B,)
    n1 = v1.sum(dim=(1, 2))
    A = torch.ones((B, K0, 1), device=s.device)
    V = torch.ones((B, 1, K1), device=s.device)
    Vbin = torch.ones((B,), device=s.device)
    for _ in range(iters):
        rowsum = (khat * V).sum(dim=2, keepdim=True) + binc * Vbin[:, None, None]
        A = v0 / torch.clamp(rowsum, min=_TINY)
        rsbin = (v1 * V).sum(dim=(1, 2)) + Vbin
        Abin = n1 / torch.clamp(rsbin, min=_TINY)
        colsum = (khat * A).sum(dim=1, keepdim=True) + v1 * Abin[:, None, None]
        V = v1 / torch.clamp(colsum, min=_TINY)
        csbin = (binc * A).sum(dim=(1, 2)) + Abin
        Vbin = n0 / torch.clamp(csbin, min=_TINY)
    M = khat * V
    rowm = M.max(dim=2).values
    best1 = torch.argmax(M, dim=2)  # first index of the maximum
    sc0 = A[..., 0] * rowm
    N = khat * A
    colm = N.max(dim=1).values
    best0 = torch.argmax(N, dim=1)
    sc1 = V[:, 0, :] * colm
    return best1.to(torch.int32), sc0, best0.to(torch.int32), sc1


def sinkhorn_decode(scores, valid0, valid1, alpha, iters: int):
    """Fused Sinkhorn(iters) + row/column argmax decode of (B, K0, K1)
    float32 scores with (B, K0) / (B, K1) bool validity: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if scores.device.type == "cpu":
        return sinkhorn_decode_plain(scores, valid0, valid1, alpha, iters)
    if scores.dtype != torch.float32 or scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError(f"sinkhorn_decode needs contiguous (B, K0, K1) float32; got {scores.dtype} {tuple(scores.shape)}")
    B, K0, K1 = scores.shape
    if valid0.shape != (B, K0) or valid1.shape != (B, K1):
        raise ValueError(f"valid masks must be (B, K0), (B, K1); got {tuple(valid0.shape)}, {tuple(valid1.shape)}")
    dev = scores.device
    for t in (valid0, valid1):
        if t.device != dev:
            raise ValueError("sinkhorn_decode inputs must share one device")
    v0 = valid0.float().contiguous()
    v1 = valid1.float().contiguous()
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(1).contiguous()
    n0 = v0.sum(dim=1).contiguous()
    n1 = v1.sum(dim=1).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    r = torch.empty((B, K0), **f32)
    binc = torch.empty((B, K0), **f32)
    A = torch.empty((B, K0), **f32)
    Abin = torch.empty((B,), **f32)
    V = torch.ones((B, K1), **f32)
    Vbin = torch.ones((B,), **f32)
    best1 = torch.empty((B, K0), dtype=torch.int32, device=dev)
    sc0 = torch.empty((B, K0), **f32)
    best0 = torch.empty((B, K1), dtype=torch.int32, device=dev)
    sc1 = torch.empty((B, K1), **f32)
    fn = _build.function("fs_sinkhorn_decode", *[_build.P] * 16, *[_build.I] * 4, _build.P)
    rc = fn(scores.data_ptr(), v0.data_ptr(), v1.data_ptr(), a.data_ptr(), n0.data_ptr(),
            n1.data_ptr(), r.data_ptr(), binc.data_ptr(), A.data_ptr(), Abin.data_ptr(),
            V.data_ptr(), Vbin.data_ptr(), best1.data_ptr(), sc0.data_ptr(), best0.data_ptr(),
            sc1.data_ptr(), B, K0, K1, iters, _build.stream_ptr(dev))
    _build.check("fs_sinkhorn_decode", rc)
    sinkhorn_decode.launches += 1
    return best1, sc0, best0, sc1


sinkhorn_decode.launches = 0
