"""Masked multi-head attention for SuperGlue's unfused GNN layer: the CUDA
kernel, its plain version and a differentiable Function around them.

Counterpart of frontend/pallas_attention.py (``fused_attention``, kernel
``_attn_kernel``). For q (B, h, K, dh), k and v (B, h, S, dh), all bf16, and
a (B, S) bool source mask:

    logits = (q . k) * scale                      float32
    logits = NEG where the source is masked       finite NEG = -1e9
    p      = exp(logits - rowmax) / max(rowsum, 1e-30)
    out    = bf16(bf16(p) @ v)                    float32 sums

A query whose sources are all masked averages v over all S (not NaN). The
probabilities are normalised before their bf16 cast, as the reference does.

The kernel is ``csrc/attention.cu``; :func:`masked_attention_plain` is the
reference's ``_dense_mirror``. :func:`attention_forward` launches the kernel
for CUDA tensors and takes the plain version only for CPU tensors.
:func:`masked_attention` is the :class:`torch.autograd.Function` whose
forward is ``attention_forward`` and whose backward differentiates the plain
version by recompute, as the reference's ``_fused_bwd`` does (its backward is
no kernel on the TPU either). ``fused_ok``'s K, S and VMEM limits are TPU
artifacts and are not carried over; the kernel takes 64-wide heads.
"""

from __future__ import annotations

import ctypes

import torch

from forest_slam_tpu_torch import _build

NEG = -1e9
HEAD_DIM = 64  # the kernel's head width

_BF = torch.bfloat16


def masked_attention_plain(q, k, v, source_mask, scale: float):
    """(B, h, K, dh) bf16 attention output with tensor ops, in the kernel's
    numerics (``pallas_attention.py:_dense_mirror``)."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    logits = torch.where(source_mask[:, None, None, :], logits, torch.full_like(logits, NEG))
    logits = logits - logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def _check(q, k, v, source_mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"attention takes q (B, h, K, dh) and k, v (B, h, S, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(source_mask.shape) != (k.shape[0], k.shape[2]):
        raise ValueError(f"source_mask must be (B, S); got {tuple(source_mask.shape)}")


def attention_forward(q, k, v, source_mask, scale: float):
    """Forward of the masked attention: the CUDA kernel for CUDA tensors
    (one launch per call), the plain version for CPU tensors."""
    _check(q, k, v, source_mask)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, source_mask, scale)
    B, h, K, dh = q.shape
    S = k.shape[2]
    if dh != HEAD_DIM:
        raise ValueError(f"the attention kernel takes {HEAD_DIM}-wide heads; got {dh}")
    if q.dtype != _BF or k.dtype != _BF or v.dtype != _BF or source_mask.dtype != torch.bool:
        raise ValueError(f"attention takes bf16 q, k, v and a bool mask; got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{source_mask.dtype}")
    for t in (q, k, v, source_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("attention inputs must be contiguous on one device")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("attention inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _build.function("fs_masked_attention", *[_build.P] * 5, *[_build.I] * 4, ctypes.c_float, _build.P)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), source_mask.data_ptr(), out.data_ptr(), B, h, K, S,
            float(scale), _build.stream_ptr(q.device))
    _build.check("fs_masked_attention", rc)
    attention_forward.launches += 1
    return out


attention_forward.launches = 0


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, source_mask, scale):
        ctx.save_for_backward(q, k, v, source_mask)
        ctx.scale = scale
        return attention_forward(q, k, v, source_mask, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, source_mask = ctx.saved_tensors
        with torch.enable_grad():
            qk = [t.detach().requires_grad_() for t in (q, k, v)]
            out = masked_attention_plain(*qk, source_mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qk, grad)
        return dq, dk, dv, None, None


def masked_attention(q, k, v, source_mask, scale: float):
    """Differentiable masked attention: forward through
    :func:`attention_forward`, backward by recomputing the plain version."""
    return _MaskedAttention.apply(q, k, v, source_mask, scale)
