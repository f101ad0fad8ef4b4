"""One detection call over every pyramid level, and the FAST gate as bit masks.

The CUDA kernel (``csrc/detect.cu``) takes all levels of a batch in one launch
and decides FAST with two 16-bit masks and a circular run-of-9 test; the card
tests (tests/test_torch_cuda.py) hold it to the plain version. Here, on the
CPU: the block layout the wrapper hands the kernel, the levels call against
the plain version level by level, and the mask formulation, written out in
numpy as the kernel computes it, against the JAX package's FAST score
(``fast_score_map(img, threshold) > 0``) on integer images whose ring
differences hit +-threshold exactly. Exact throughout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forest_slam_tpu.frontend.fast import fast_score_map as jfast
from forest_slam_tpu_torch.frontend import orb as torb
from forest_slam_tpu_torch.frontend.detect_kernel import (
    MAX_LEVELS,
    TILE,
    _check_kernel_inputs,
    detect_pooled,
    detect_pooled_levels,
    detect_pooled_plain,
    level_table,
)
from forest_slam_tpu_torch.frontend.fast import FAST_OFFSETS


def _pyramid_shapes(H, W, n_levels=8):
    sizes, _ = torb._level_geometry(H, W, torb.OrbConfig(n_levels=n_levels))
    return [(h, w) for h, w, _ in sizes]


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("shapes", [_pyramid_shapes(600, 960), _pyramid_shapes(160, 224),
                                    [(33, 41), (600, 960), (1, 1), (64, 32), (65, 33)]])
def test_level_table_blocks(B, shapes):
    order, start = level_table(shapes, B)
    tiles = [-(-h // TILE) * -(-w // TILE) for h, w in shapes]
    assert sorted(order) == list(range(len(shapes)))
    assert [tiles[i] for i in order] == sorted(tiles, reverse=True)  # largest level first
    assert start[0] == 0 and start[-1] == B * sum(tiles)
    assert [start[j + 1] - start[j] for j in range(len(order))] == [B * tiles[i] for i in order]
    ties = [i for i in order if tiles[i] == tiles[order[0]]]
    assert ties == sorted(ties)  # equal tile counts keep their given order


def test_level_table_main_pyramid():
    """The eight levels of 960x600 are already largest first; 32x32 tiles
    give 4,560 blocks for level 0 of 8 frames and 14,776 in all."""
    order, start = level_table(_pyramid_shapes(600, 960), 8)
    assert order == list(range(8))
    assert start == [0, 4560, 7760, 10112, 11696, 12896, 13728, 14344, 14776]


def test_detect_pooled_levels_cpu_is_plain_per_level():
    rng = np.random.default_rng(0)
    levels = [torch.as_tensor(rng.uniform(0, 255, (2, h, w)).astype(np.float32))
              for h, w in _pyramid_shapes(96, 160, 4) + [(33, 41)]]
    n = detect_pooled.launches
    got = detect_pooled_levels(levels, 20.0, 7, 8)
    assert detect_pooled.launches == n  # CPU tensors: no launch
    assert len(got) == len(levels) and detect_pooled_levels([]) == []
    for lv, (v, i) in zip(levels, got):
        rv, ri = detect_pooled_plain(lv, 20.0, 7, 8)
        assert torch.equal(v, rv) and torch.equal(i, ri)
    assert sum(int(torch.isfinite(v).sum()) for v, _ in got) > 50
    assert MAX_LEVELS >= 8


def test_select_keypoints_takes_pooled_detection():
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.uniform(0, 255, (2, 64, 96)).astype(np.float32))
    cfg = torb.OrbConfig(edge_margin=8)
    pooled = detect_pooled_levels([img], cfg.fast_threshold, cfg.harris_block, cfg.edge_margin)[0]
    a = torb._select_keypoints(img, 40, cfg)
    b = torb._select_keypoints(img, 40, cfg, pooled)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and int(a[2].sum()) > 10


def test_kernel_inputs_are_checked():
    imgs = torch.zeros((2, 40, 48))
    _check_kernel_inputs([imgs, torch.zeros((2, 20, 24))], 7)
    with pytest.raises(ValueError, match="one batch"):
        _check_kernel_inputs([imgs, torch.zeros((3, 20, 24))], 7)
    with pytest.raises(ValueError, match="contiguous float32"):
        _check_kernel_inputs([imgs.double()], 7)
    with pytest.raises(ValueError, match="harris_block"):
        _check_kernel_inputs([imgs], 9)
    with pytest.raises(ValueError, match="harris_block"):
        _check_kernel_inputs([imgs], 4)


def _run_of_9(m):
    """csrc/detect.cu:run_of_9 on uint32 arrays."""
    m = m | (m << 16)
    r = m & (m >> 1)
    r &= r >> 2
    r &= r >> 4
    r &= m >> 8
    return (r & 0xFFFF) != 0


def _mask_gate(img, threshold):
    """csrc/detect.cu:fast_corner for every pixel of (H, W) float32, the 3-px
    border false: the early reject on ring points 0, 4, 8 and 12, then the
    bright and dark masks."""
    H, W = img.shape
    t = np.float32(max(threshold, 0.0))
    p = np.pad(img, 3)
    d = np.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in FAST_OFFSETS]) - img
    quad = d[[0, 4, 8, 12]]
    maybe = ((quad > t).sum(0) >= 2) | ((quad < -t).sum(0) >= 2)
    weights = (np.uint32(1) << np.arange(16, dtype=np.uint32))[:, None, None]
    bright = ((d > t) * weights).sum(0).astype(np.uint32)
    dark = ((d < -t) * weights).sum(0).astype(np.uint32)
    gate = maybe & (_run_of_9(bright) | _run_of_9(dark))
    inside = np.zeros((H, W), bool)
    inside[3:H - 3, 3:W - 3] = True
    return gate & inside, maybe


@pytest.mark.parametrize("threshold", [20.0, 5.0, 0.0, -3.0])
def test_fast_mask_gate_equals_reference_score(threshold):
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 60, (48, 64)).astype(np.float32),  # differences hit +-20, +-5 and 0 exactly
              (rng.integers(0, 4, (48, 64)) * 20).astype(np.float32),
              (rng.integers(0, 12, (48, 64)) * 5).astype(np.float32),
              rng.uniform(0, 255, (48, 64)).astype(np.float32)]
    for img in images:
        ref = np.asarray(jfast(jnp.asarray(img), threshold)) > 0
        gate, maybe = _mask_gate(img, threshold)
        np.testing.assert_array_equal(gate, ref)
        assert ref.sum() > 5
        assert not (ref & ~maybe).any()  # the early reject never drops a corner
    flat = np.full((20, 20), 9.0, np.float32)  # every difference 0: no corner at any threshold
    assert not _mask_gate(flat, threshold)[0].any()
    assert not (np.asarray(jfast(jnp.asarray(flat), threshold)) > 0).any()
