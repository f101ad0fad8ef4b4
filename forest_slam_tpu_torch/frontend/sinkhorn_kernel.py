"""Exp-domain Sinkhorn + match decode: the CUDA kernel and its plain version.

Counterpart of frontend/pallas_sinkhorn.py (``sinkhorn_decode`` /
``match_decode``). The kernel is ``csrc/sinkhorn.cu``;
:func:`sinkhorn_decode_plain` runs the same iteration with tensor ops
(iteration for iteration the TPU kernel's, and equivalent to
superglue.log_sinkhorn + match_from_couplings). :func:`sinkhorn_decode`
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors; :func:`launch_plan` says how the kernel lays a shape out
(cluster size, rows per CTA, shared memory).
"""

from __future__ import annotations

import ctypes

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
    return _launch(scores, valid0, valid1, alpha, iters, cluster=0)


_PLAN_KEYS = ("cluster", "rows_per_cta", "smem_rows", "l2_rows", "smem_bytes", "active_clusters", "waves",
              "threads")
_plans: dict = {}


def launch_plan(B: int, K0: int, K1: int, device, cluster: int = 0) -> dict:
    """How the kernel runs (B, K0, K1) on ``device``: cluster size (CTAs per
    pair), rows per CTA and how many of them sit in shared memory and in the
    L2 scratch, shared memory bytes per CTA, clusters active at once, waves
    and threads per CTA. ``cluster`` 0 lets the launcher choose; 1..16 asks
    for that size. Cached per device and shape."""
    device = torch.device(device)
    key = (device.index, B, K0, K1, cluster)
    if key not in _plans:
        out = (ctypes.c_int * len(_PLAN_KEYS))()
        fn = _build.function("fs_sinkhorn_plan", *[_build.I] * 4, _build.P)
        with torch.cuda.device(device):
            rc = fn(B, K0, K1, cluster, ctypes.addressof(out))
        if rc == -1:
            raise ValueError(f"sinkhorn_decode: K1={K1} is too wide for V and the column partials to fit in "
                             "shared memory")
        if rc == -2:
            raise RuntimeError(f"sinkhorn_decode: no cluster size can run (B, K0, K1) = {(B, K0, K1)} "
                               f"(asked for {cluster or 'any'})")
        _build.check("fs_sinkhorn_plan", rc)
        _plans[key] = dict(zip(_PLAN_KEYS, out))
    return _plans[key]


def _launch(scores, valid0, valid1, alpha, iters: int, cluster: int):
    """One launch of the kernel, with the cluster size ``cluster`` (0: the
    launcher's choice)."""
    if scores.dtype != torch.float32 or scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError(f"sinkhorn_decode needs contiguous (B, K0, K1) float32; got {scores.dtype} {tuple(scores.shape)}")
    B, K0, K1 = scores.shape
    if valid0.shape != (B, K0) or valid1.shape != (B, K1):
        raise ValueError(f"valid masks must be (B, K0), (B, K1); got {tuple(valid0.shape)}, {tuple(valid1.shape)}")
    if K0 < 1 or K1 < 1:
        raise ValueError(f"sinkhorn_decode needs K0, K1 >= 1; got {(K0, K1)}")
    if iters < 0:
        raise ValueError(f"sinkhorn_decode needs iters >= 0; got {iters}")
    dev = scores.device
    for t in (valid0, valid1):
        if t.device != dev:
            raise ValueError("sinkhorn_decode inputs must share one device")
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if B == 0:
        return (torch.empty((0, K0), **i32), torch.empty((0, K0), **f32), torch.empty((0, K1), **i32),
                torch.empty((0, K1), **f32))
    plan = launch_plan(B, K0, K1, dev, cluster)
    v0 = valid0.to(torch.bool).contiguous().view(torch.uint8)
    v1 = valid1.to(torch.bool).contiguous().view(torch.uint8)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(1).contiguous()
    # the four outputs in one allocation; the khat rows that do not fit in
    # shared memory in an L2-resident scratch
    out = torch.empty((2 * B * (K0 + K1),), **f32)
    sc0, sc1, best1, best0 = torch.split(out, (B * K0, B * K1, B * K0, B * K1))
    best1, best0 = best1.view(torch.int32).view(B, K0), best0.view(torch.int32).view(B, K1)
    sc0, sc1 = sc0.view(B, K0), sc1.view(B, K1)
    n_spill = B * plan["cluster"] * plan["l2_rows"] * ((K1 + 3) // 4 * 4)
    spill = torch.empty((n_spill,), **f32) if n_spill else None
    fn = _build.function("fs_sinkhorn_decode", *[_build.P] * 9, *[_build.I] * 5, _build.P)
    rc = fn(scores.data_ptr(), v0.data_ptr(), v1.data_ptr(), a.data_ptr(), spill.data_ptr() if n_spill else None,
            best1.data_ptr(), sc0.data_ptr(), best0.data_ptr(), sc1.data_ptr(), B, K0, K1, iters, plan["cluster"],
            _build.stream_ptr(dev))
    _build.check("fs_sinkhorn_decode", rc)
    sinkhorn_decode.launches += 1
    return best1, sc0, best0, sc1


sinkhorn_decode.launches = 0
