"""Per-keypoint stereo SAD cost rows: the CUDA kernel and its plain version.

Counterpart of stereo/pallas_sparse.py (``sparse_cost_rows_pallas``). The
kernel is ``csrc/sparse_cost.cu``; :func:`sparse_cost_rows_plain` computes
the same function with tensor ops (the gather path of stereo/sparse.py:
``_cost_rows_gather``). :func:`sparse_cost_rows` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch import _build


def _check_inputs(pl, pr, xi, yi):
    if pl.dim() != 3 or pr.shape != pl.shape:
        raise ValueError(f"images must be (B, H, W) alike; got {tuple(pl.shape)}, {tuple(pr.shape)}")
    if xi.dim() != 2 or yi.shape != xi.shape or xi.shape[0] != pl.shape[0]:
        raise ValueError(f"xi, yi must be (B, K); got {tuple(xi.shape)}, {tuple(yi.shape)}")


def sparse_cost_rows_plain(pl, pr, xi, yi, num_disparities: int, window: int):
    """(B, K, D) SAD cost indexed by disparity, keypoints clamped into the
    image and windows zero-padded outside it."""
    _check_inputs(pl, pr, xi, yi)
    B, H, W = pl.shape
    D, w = num_disparities, window
    r = w // 2
    S = D + w - 1
    x = xi.long().clamp(0, W - 1)
    y = yi.long().clamp(0, H - 1)
    pl_pad = F.pad(pl.float(), (r, r, r, r))
    pr_pad = F.pad(pr.float(), (D - 1 + r, r, r, r))
    bi = torch.arange(B, device=pl.device)[:, None, None, None]
    rows = (y[..., None] + torch.arange(w, device=pl.device))[..., :, None]
    patch = pl_pad[bi, rows, x[..., None, None] + torch.arange(w, device=pl.device)]
    strip = pr_pad[bi, rows, x[..., None, None] + torch.arange(S, device=pl.device)]
    windows = strip.unfold(-1, w, 1)  # (B, K, w, D, w): strip[..., j + dx]
    cost_j = (patch[..., :, None, :] - windows).abs().sum(dim=(2, 4))
    return cost_j.flip(-1)  # window offset j = D-1-d -> index by d


def sparse_cost_rows(pl, pr, xi, yi, num_disparities: int, window: int):
    """(B, K, D) SAD cost of prefiltered (B, H, W) float32 images at (B, K)
    int32 keypoints: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if pl.device.type == "cpu":
        return sparse_cost_rows_plain(pl, pr, xi, yi, num_disparities, window)
    _check_inputs(pl, pr, xi, yi)
    for t, dt in ((pl, torch.float32), (pr, torch.float32), (xi, torch.int32), (yi, torch.int32)):
        if t.device != pl.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"sparse_cost_rows needs contiguous {dt} on {pl.device}; got {t.dtype} on {t.device}")
    B, H, W = pl.shape
    K = xi.shape[1]
    cost = torch.empty((B, K, num_disparities), dtype=torch.float32, device=pl.device)
    fn = _build.function("fs_sparse_cost", *[_build.P] * 5, *[_build.I] * 6, _build.P)
    rc = fn(pl.data_ptr(), pr.data_ptr(), xi.data_ptr(), yi.data_ptr(), cost.data_ptr(),
            B, K, H, W, num_disparities, window, _build.stream_ptr(pl.device))
    _build.check("fs_sparse_cost", rc)
    sparse_cost_rows.launches += 1
    return cost


sparse_cost_rows.launches = 0
