"""ORB detection pooled per 8x8 cell: the CUDA kernel and its plain version.

Counterpart of frontend/pallas_detect.py (``detect_pooled_batched``) and of
the XLA detection path of frontend/orb.py (``_extract_level`` into
``_select_keypoints``). For each pixel of a (B, H, W) pyramid level: the
FAST-9 score, the Harris response, ``rank = harris`` where FAST fires inside
the edge margin (else -inf), 3x3 NMS (``rank >= max of its 3x3``, ties
survive); then per 8x8 cell the largest kept rank and its flat index
``y * W + x`` in the level's own width. Cells that run past the image hold
-inf, as the XLA path's padding to a cell multiple does.

Tie rule inside a cell: the XLA path's ``argmax`` over the row-major
flattened cell, so the smallest y wins, then the smallest x (the Pallas
kernel took the column argmax of row maxima instead). An empty cell reports
-inf and the index of its top-left pixel.

The kernel is ``csrc/detect.cu``; :func:`detect_pooled_plain` computes the
same function with tensor ops. :func:`detect_pooled_levels` takes every
pyramid level of a batch and launches the kernel once for all of them on
CUDA tensors; :func:`detect_pooled` is its one-level case. Both take the
plain version only for CPU tensors, and both count their launches on
``detect_pooled.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch import _build
from forest_slam_tpu_torch.frontend.fast import fast_score_map, harris_response, interior_mask
from forest_slam_tpu_torch.utils.filters import maxpool2d_same

CELL = 8
HARRIS_K = 0.04  # OpenCV ORB's harrisK
MAX_HARRIS_BLOCK = 7  # the kernel's halo covers a box radius of 3
TILE = 32  # a block's output tile: TILE x TILE pixels
MAX_LEVELS = 16  # levels one launch takes (the kernel's level table)


def n_cells(H: int, W: int) -> tuple[int, int]:
    return -(-H // CELL), -(-W // CELL)


def _check_image(images):
    if images.dim() != 3 or images.shape[1] < 1 or images.shape[2] < 1:
        raise ValueError(f"detect_pooled takes (B, H, W) images; got {tuple(images.shape)}")


def detect_pooled_plain(images, threshold: float = 20.0, harris_block: int = 7, margin: int = 16):
    """((B, ceil(H/8), ceil(W/8)) float32 cell maxima, same-shape int32 flat
    indices y * W + x) of (B, H, W) images, with tensor ops."""
    _check_image(images)
    B, H, W = images.shape
    images = images.float()
    fast = fast_score_map(images, threshold)
    harris = harris_response(images, harris_block, HARRIS_K)
    neg = torch.full_like(harris, float("-inf"))
    ranked = torch.where((fast > 0.0) & interior_mask(H, W, margin, images.device), harris, neg)
    kept = torch.where((ranked >= maxpool2d_same(ranked, 3)) & torch.isfinite(ranked), ranked, neg)
    ncy, ncx = n_cells(H, W)
    kp = F.pad(kept, (0, ncx * CELL - W, 0, ncy * CELL - H), value=float("-inf"))
    tiles = kp.reshape(B, ncy, CELL, ncx, CELL).permute(0, 1, 3, 2, 4).reshape(B, ncy, ncx, CELL * CELL)
    vals = tiles.amax(dim=-1)
    within = torch.argmax(tiles, dim=-1)  # first maximum: smallest y, then x
    cy = torch.arange(ncy, device=images.device)[:, None]
    cx = torch.arange(ncx, device=images.device)[None, :]
    ys = cy * CELL + torch.div(within, CELL, rounding_mode="floor")
    xs = cx * CELL + within % CELL
    return vals, (ys * W + xs).to(torch.int32)


def level_table(shapes, batch: int):
    """The block layout of one launch over levels of (h, w) ``shapes``:
    (order, start), where ``order`` lists the levels with the most tiles
    first (equal counts in their given order) and ``start[i]`` is the first
    block of level ``order[i]``, each level taking its tiles times ``batch``
    blocks; ``start[-1]`` is the grid."""
    tiles = [-(-h // TILE) * -(-w // TILE) for h, w in shapes]
    order = sorted(range(len(shapes)), key=lambda i: -tiles[i])
    start = [0]
    for i in order:
        start.append(start[-1] + tiles[i] * batch)
    return order, start


def _check_kernel_inputs(levels, harris_block):
    for images in levels:
        _check_image(images)
        if images.dtype != torch.float32 or not images.is_contiguous():
            raise ValueError(f"detect_pooled needs contiguous float32 images; got {images.dtype}")
        if images.device != levels[0].device or images.shape[0] != levels[0].shape[0]:
            raise ValueError("detect_pooled_levels takes levels of one batch on one device")
    if harris_block % 2 == 0 or not 1 <= harris_block <= MAX_HARRIS_BLOCK:
        raise ValueError(f"the detect kernel takes an odd harris_block <= {MAX_HARRIS_BLOCK}; got {harris_block}")


def _launch(levels, threshold, harris_block, margin):
    """One kernel launch over at most MAX_LEVELS CUDA levels of one batch."""
    B = levels[0].shape[0]
    order, start = level_table([lv.shape[1:] for lv in levels], B)
    outs = []
    for lv in levels:
        shape = (B, *n_cells(*lv.shape[1:]))
        outs.append((torch.empty(shape, dtype=torch.float32, device=lv.device),
                     torch.empty(shape, dtype=torch.int32, device=lv.device)))
    if B == 0:
        return outs
    n = len(levels)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    F32 = ctypes.c_float
    fn = _build.function("fs_detect_levels", *[_build.P] * 6, *[_build.I] * 4, F32, F32, F32, _build.P)
    rc = fn(ptrs([levels[i] for i in order]), ptrs([outs[i][0] for i in order]),
            ptrs([outs[i][1] for i in order]), ints([levels[i].shape[1] for i in order]),
            ints([levels[i].shape[2] for i in order]), ints(start), n, B, harris_block, margin,
            float(threshold), 1.0 / ((1 << 2) * harris_block * 255.0), HARRIS_K,
            _build.stream_ptr(levels[0].device))
    _build.check("fs_detect_levels", rc)
    detect_pooled.launches += 1
    return outs


def detect_pooled_levels(levels, threshold: float = 20.0, harris_block: int = 7, margin: int = 16):
    """Cell-pooled detection of each (B, h_l, w_l) float32 level of one batch:
    a list of (vals, idx) per level, as :func:`detect_pooled` gives them. For
    CUDA levels one kernel launch for every MAX_LEVELS levels; for CPU levels
    the plain version, level by level."""
    levels = list(levels)
    if not levels:
        return []
    if all(lv.device.type == "cpu" for lv in levels):
        return [detect_pooled_plain(lv, threshold, harris_block, margin) for lv in levels]
    _check_kernel_inputs(levels, harris_block)
    outs = []
    for i in range(0, len(levels), MAX_LEVELS):
        outs += _launch(levels[i:i + MAX_LEVELS], threshold, harris_block, margin)
    return outs


def detect_pooled(images, threshold: float = 20.0, harris_block: int = 7, margin: int = 16):
    """Cell-pooled detection of (B, H, W) float32 images: the CUDA kernel for
    CUDA tensors (one launch per call), the plain version for CPU tensors."""
    if images.device.type == "cpu":
        return detect_pooled_plain(images, threshold, harris_block, margin)
    _check_kernel_inputs([images], harris_block)
    return _launch([images], threshold, harris_block, margin)[0]


detect_pooled.launches = 0
