"""SuperPoint keypoint selection pooled per 4x4 block: the CUDA kernel and
its plain version.

Counterpart of frontend/pallas_select.py (``nms_pooled_batched``) and of the
block path of frontend/superpoint.py's ``select_keypoints``. For each pixel
of a (B, H, W) heat map, keep ``heat`` where it is at least the maximum of
its (2r+1)^2 window (ties survive), above the threshold and outside the
``border``-pixel strip, else 0; then per 4x4 block the largest kept value and
its flat index ``y * W + x``. The caller takes the top-k over the block
maxima.

Tie rule inside a block: the XLA path's ``argmax`` over the row-major
flattened block, so the smallest y wins, then the smallest x (the Pallas
kernel took the column argmax of row maxima instead, as detect_kernel.py
notes for the detection kernel). An empty block reports 0 and the index of
its top-left pixel. Pixels outside the image never win a window maximum, as
in :func:`maxpool2d_same`; the Pallas kernel pads with zeros, which is the
same only for heat >= 0.

The kernel is ``csrc/select.cu``; :func:`nms_block_max_plain` computes the
same function with tensor ops. The work is comparisons only, so the two
agree bit for bit. :func:`nms_block_max` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors. A lane of the
kernel owns the 4 columns of one pooled block and a warp a band of
``BAND_ROWS`` rows; :func:`launch_plan` lays the warps over the image. The
TPU kernel's ``W % 128`` limit and 64-row tile are not carried over: any H
and W that are multiples of 4 are taken, at radii 0..8.
"""

from __future__ import annotations

import ctypes

import torch

from forest_slam_tpu_torch import _build
from forest_slam_tpu_torch.utils.filters import maxpool2d_same

BLOCK = 4
BORDER = 4  # the reference implementation's remove_borders strip
MAX_RADIUS = 8  # the kernel's largest halo
BAND_ROWS = 8  # output rows a warp of the kernel computes (csrc/select.cu kBandRows)


def nms_kept_plain(heat, nms_radius: int = 4, threshold: float = 0.005, border: int = BORDER):
    """(B, H, W) heat -> the NMS survivors above ``threshold`` and outside
    the border strip, 0 elsewhere."""
    B, H, W = heat.shape
    nms = maxpool2d_same(heat, 2 * nms_radius + 1)
    kept = torch.where((heat >= nms) & (heat > threshold), heat, torch.zeros_like(heat))
    ys = torch.arange(H, device=heat.device)[:, None]
    xs = torch.arange(W, device=heat.device)[None, :]
    interior = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return torch.where(interior, kept, torch.zeros_like(kept))


def _check_heat(heat):
    if heat.dim() != 3 or heat.shape[1] % BLOCK or heat.shape[2] % BLOCK:
        raise ValueError(f"nms_block_max takes (B, H, W) heat with H and W multiples of {BLOCK}; "
                         f"got {tuple(heat.shape)}")


def nms_block_max_plain(heat, nms_radius: int = 4, threshold: float = 0.005, border: int = BORDER):
    """((B, H/4, W/4) float32 block maxima of the kept heat, same-shape
    int32 flat indices y * W + x), with tensor ops."""
    _check_heat(heat)
    B, H, W = heat.shape
    Hb, Wb = H // BLOCK, W // BLOCK
    kept = nms_kept_plain(heat.float(), nms_radius, threshold, border)
    blocks = kept.reshape(B, Hb, BLOCK, Wb, BLOCK).permute(0, 1, 3, 2, 4).reshape(B, Hb, Wb, BLOCK * BLOCK)
    vals = blocks.amax(dim=-1)
    local = torch.argmax(blocks, dim=-1)  # first maximum: smallest y, then x
    ys = torch.arange(Hb, device=heat.device)[:, None] * BLOCK + torch.div(local, BLOCK, rounding_mode="floor")
    xs = torch.arange(Wb, device=heat.device)[None, :] * BLOCK + local % BLOCK
    return vals, (ys * W + xs).to(torch.int32)


def launch_plan(shape, nms_radius: int = 4) -> dict:
    """How the kernel covers (B, H, W) heat at this radius: a lane owns one
    aligned float4 (one pooled block's columns), the ``halo_lanes`` =
    ceil(r/4) lanes at each edge of a warp only feed their neighbours'
    window maxima, so a warp writes ``lanes`` blocks of a row; ``col_warps``
    warps span a row and ``bands`` bands of ``BAND_ROWS`` rows the height:
    ``warps`` in all."""
    B, H, W = shape
    halo = -(-nms_radius // BLOCK)
    lanes = 32 - 2 * halo
    col_warps = -(-(W // BLOCK) // lanes)
    bands = -(-H // BAND_ROWS)
    return dict(halo_lanes=halo, lanes=lanes, col_warps=col_warps, bands=bands, warps=B * bands * col_warps)


def nms_block_max(heat, nms_radius: int = 4, threshold: float = 0.005, border: int = BORDER):
    """Block-pooled selection of (B, H, W) float32 heat: the CUDA kernel for
    CUDA tensors (one launch per call), the plain version for CPU tensors."""
    if heat.device.type == "cpu":
        return nms_block_max_plain(heat, nms_radius, threshold, border)
    _check_heat(heat)
    if heat.dtype != torch.float32 or not heat.is_contiguous() or heat.data_ptr() % 16:
        raise ValueError(f"nms_block_max needs contiguous, 16-byte aligned float32 heat; got {heat.dtype}")
    if not 0 <= nms_radius <= MAX_RADIUS:
        raise ValueError(f"the select kernel takes an NMS radius of 0..{MAX_RADIUS}; got {nms_radius}")
    B, H, W = heat.shape
    plan = launch_plan(heat.shape, nms_radius)
    vals = torch.empty((B, H // BLOCK, W // BLOCK), dtype=torch.float32, device=heat.device)
    idx = torch.empty((B, H // BLOCK, W // BLOCK), dtype=torch.int32, device=heat.device)
    fn = _build.function("fs_nms_block_max", *[_build.P] * 3, *[_build.I] * 4, ctypes.c_float, *[_build.I] * 3,
                         _build.P)
    rc = fn(heat.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, H, W, nms_radius, float(threshold), border,
            plan["col_warps"], plan["bands"], _build.stream_ptr(heat.device))
    _build.check("fs_nms_block_max", rc)
    nms_block_max.launches += 1
    return vals, idx


nms_block_max.launches = 0
