"""Per-keypoint stereo SAD cost rows: the CUDA kernel and its plain version.

Counterpart of stereo/pallas_sparse.py (``sparse_cost_rows_pallas``). The
kernel is ``csrc/sparse_cost.cu``; :func:`sparse_cost_rows_plain` computes
the same function with tensor ops (the gather path of stereo/sparse.py:
``_cost_rows_gather``). :func:`sparse_cost_rows` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors. The kernel runs a
warp per keypoint, several keypoints a block (:func:`launch_plan`), takes
any D >= 1 and windows of 1..``MAX_WINDOW``; the TPU kernel's ``D + w - 1 <=
128`` and ``w <= 8`` limits are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch import _build

MAX_WINDOW = 15  # the kernel's template instances: w = 1..15
MAX_KEYPOINTS_PER_BLOCK = 8
SMEM_DEFAULT_BYTES = 48 * 1024  # a block's shared memory without the opt-in
SMEM_OPTIN_BYTES = 232448  # a block's shared memory with it on sm_90 (H100, H200)


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


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def keypoint_bytes(num_disparities: int, window: int) -> int:
    """Shared memory of one keypoint in the kernel: w patch rows of
    pad4(w + 3) floats and w strip rows of pad4(D + w + 2) floats (each row
    starts on 16 bytes, at the multiple of 4 columns at or left of the
    window), and 4 floats that the last lane of a pass may read past the
    strip."""
    D, w = num_disparities, window
    return 4 * (w * _pad4(w + 3) + w * _pad4(D + w + 2) + 4)


def launch_plan(num_disparities: int, window: int) -> dict:
    """The kernel's launch at D disparities and window w: one warp a
    keypoint, as many keypoints a block as fit in 48 KB of shared memory, at
    most 8, at least 1 (one keypoint may use the opt-in limit). ValueError
    for a window outside 1..``MAX_WINDOW``, D < 1, or a strip that does not
    fit."""
    D, w = num_disparities, window
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"the sparse-cost kernel takes windows of 1..{MAX_WINDOW}; got {w}")
    if D < 1:
        raise ValueError(f"the sparse-cost kernel needs at least one disparity; got {D}")
    per = keypoint_bytes(D, w)
    if per > SMEM_OPTIN_BYTES:
        raise ValueError(f"a {w} x {D + w - 1} strip ({per} bytes of shared memory a keypoint) exceeds the "
                         f"{SMEM_OPTIN_BYTES} bytes a block can hold")
    kp = max(1, min(MAX_KEYPOINTS_PER_BLOCK, SMEM_DEFAULT_BYTES // per))
    return dict(keypoints_per_block=kp, smem_bytes=kp * per)


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
    plan = launch_plan(num_disparities, window)
    B, H, W = pl.shape
    K = xi.shape[1]
    cost = torch.empty((B, K, num_disparities), dtype=torch.float32, device=pl.device)
    fn = _build.function("fs_sparse_cost", *[_build.P] * 5, *[_build.I] * 8, _build.P)
    rc = fn(pl.data_ptr(), pr.data_ptr(), xi.data_ptr(), yi.data_ptr(), cost.data_ptr(), B, K, H, W,
            num_disparities, window, plan["keypoints_per_block"], plan["smem_bytes"], _build.stream_ptr(pl.device))
    _build.check("fs_sparse_cost", rc)
    sparse_cost_rows.launches += 1
    return cost


sparse_cost_rows.launches = 0
