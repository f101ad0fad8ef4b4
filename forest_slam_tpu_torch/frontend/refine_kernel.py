"""Match-refinement SAD cost volume: the CUDA kernel and its plain version.

Counterpart of frontend/pallas_refine.py (``refine_cost_volume_pallas``).
The kernel is ``csrc/refine_cost.cu`` (one warp per keypoint, several
keypoints a block: :func:`keypoints_per_block`); :func:`refine_cost_volume_plain`
computes the same function with tensor ops (the tap accumulation of
frontend/refine.py:_cost_volume_xla), and like the kernel leaves rows at or
past ``nvalid`` as exact zeros. :func:`refine_cost_volume` launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch import _build

_MAX_SMEM_FLOATS = 48 * 1024 // 4


def _check_inputs(img0, img1, xi0, yi0, xi1, yi1, nvalid):
    if img0.dim() != 3 or img1.dim() != 3 or img1.shape[0] != img0.shape[0]:
        raise ValueError(f"images must be (B, H, W); got {tuple(img0.shape)}, {tuple(img1.shape)}")
    B = img0.shape[0]
    for t in (xi0, yi0, xi1, yi1):
        if t.dim() != 2 or t.shape != xi0.shape or t.shape[0] != B:
            raise ValueError(f"keypoint indices must be (B, K); got {tuple(t.shape)}")
    if nvalid.shape != (B,):
        raise ValueError(f"nvalid must be (B,); got {tuple(nvalid.shape)}")


def refine_cost_volume_plain(img0, img1, xi0, yi0, xi1, yi1, template: int, radius: int, nvalid):
    """(B, K, n, n) SAD cost, n = 2 radius + 1; rows >= nvalid are zero."""
    _check_inputs(img0, img1, xi0, yi0, xi1, yi1, nvalid)
    t, R = template, radius
    ht = t // 2
    n = 2 * R + 1
    S = n + t - 1
    B, K = xi0.shape
    dev = img0.device
    bi = torch.arange(B, device=dev)[:, None, None, None]
    p0 = F.pad(img0.float(), (ht, ht, ht, ht))
    p1 = F.pad(img1.float(), (ht + R, ht + R, ht + R, ht + R))
    at = torch.arange(t, device=dev)
    aS = torch.arange(S, device=dev)
    tpl = p0[bi, (yi0.long()[..., None] + at)[..., :, None], (xi0.long()[..., None] + at)[..., None, :]]
    win = p1[bi, (yi1.long()[..., None] + aS)[..., :, None], (xi1.long()[..., None] + aS)[..., None, :]]
    cost = torch.zeros((B, K, n, n), dtype=torch.float32, device=dev)
    for ty in range(t):
        for tx in range(t):
            cost = cost + (win[..., ty:ty + n, tx:tx + n] - tpl[..., ty:ty + 1, tx:tx + 1]).abs()
    live = torch.arange(K, device=dev)[None, :] < nvalid[:, None]
    return torch.where(live[..., None, None], cost, torch.zeros_like(cost))


def keypoints_per_block(template: int, radius: int) -> int:
    """Keypoints one block of the kernel takes at this template and radius
    (builds the kernels on first use)."""
    return _build.function("fs_refine_keypoints_per_block", _build.I, _build.I)(template, radius)


def refine_cost_volume(img0, img1, xi0, yi0, xi1, yi1, template: int, radius: int, nvalid):
    """(B, K, n, n) SAD cost of 8x8-style templates of (B, H0, W0) frame 0
    against (2R+1)^2 offsets in (B, H1, W1) frame 1 at (B, K) int32
    keypoints; rows at or past ``nvalid`` (B,) are exact zeros. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if img0.device.type == "cpu":
        return refine_cost_volume_plain(img0, img1, xi0, yi0, xi1, yi1, template, radius, nvalid)
    _check_inputs(img0, img1, xi0, yi0, xi1, yi1, nvalid)
    tensors = ((img0, torch.float32), (img1, torch.float32), (xi0, torch.int32), (yi0, torch.int32),
               (xi1, torch.int32), (yi1, torch.int32), (nvalid, torch.int32))
    for t, dt in tensors:
        if t.device != img0.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"refine_cost_volume needs contiguous {dt} on {img0.device}; got {t.dtype} on {t.device}")
    S = 2 * radius + template
    if template * template + S * S > _MAX_SMEM_FLOATS:
        raise ValueError(f"template {template} / radius {radius} exceed the kernel's shared memory")
    B, H0, W0 = img0.shape
    H1, W1 = img1.shape[1:]
    K = xi0.shape[1]
    n = 2 * radius + 1
    cost = torch.empty((B, K, n, n), dtype=torch.float32, device=img0.device)
    fn = _build.function("fs_refine_cost", *[_build.P] * 8, *[_build.I] * 8, _build.P)
    rc = fn(img0.data_ptr(), img1.data_ptr(), xi0.data_ptr(), yi0.data_ptr(), xi1.data_ptr(),
            yi1.data_ptr(), nvalid.data_ptr(), cost.data_ptr(), B, K, H0, W0, H1, W1,
            template, radius, _build.stream_ptr(img0.device))
    _build.check("fs_refine_cost", rc)
    refine_cost_volume.launches += 1
    return cost


refine_cost_volume.launches = 0
