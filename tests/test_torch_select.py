"""Keypoint selection of the port against the JAX package.

The port's plain block pooling (``nms_block_max_plain``, the select
kernel's plain version) and ``select_keypoints`` against the JAX
``select_keypoints`` on its Pallas path in interpret mode
(``nms_backend="pallas_interpret"``, ``pallas_select.nms_pooled_batched``)
and on its XLA path, with exact top-k. The heat is tie-free and peaky, as in
tests/test_pallas_select.py, and the work is comparisons only, so keypoint
sets, scores and descriptors must be equal (descriptors to float32 rounding
of the bilinear sample, 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forest_slam_tpu.frontend.pallas_select import nms_pooled_batched
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JConfig
from forest_slam_tpu.frontend.superpoint import select_keypoints as jselect
from forest_slam_tpu_torch.frontend.select_kernel import BAND_ROWS, launch_plan, nms_block_max, nms_block_max_plain
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, block_path, select_keypoints


def _peaky(rng, B, H, W):
    heat = rng.random((B, H, W), dtype=np.float32) * 0.004
    peaks = rng.random((B, H, W), dtype=np.float32)
    return np.where(peaks > 0.99, peaks, heat).astype(np.float32)


def _coarse(rng, B, H, W, D=32):
    c = rng.normal(size=(B, H // 8, W // 8, D)).astype(np.float32)
    return c / np.linalg.norm(c, axis=-1, keepdims=True)


def _kp_set(xy, score, valid):
    return {(int(x), int(y), float(s)) for (x, y), s, v in zip(xy, score, valid) if v}


def _compare(heat, coarse, K, backend, nms_radius=4):
    jcfg = JConfig(max_keypoints=K, descriptor_dim=coarse.shape[-1], topk_method="exact",
                   desc_sample_dtype=None, nms_backend=backend, nms_radius=nms_radius)
    jf = jselect(jnp.asarray(heat), jnp.asarray(coarse), jcfg)
    tcfg = SuperPointConfig(max_keypoints=K, descriptor_dim=coarse.shape[-1], desc_sample_dtype=None,
                            nms_backend="plain", nms_radius=nms_radius)
    tf = select_keypoints(torch.as_tensor(heat), torch.as_tensor(coarse), tcfg)
    n_valid = 0
    for b in range(heat.shape[0]):
        jset = _kp_set(np.asarray(jf.xy[b]), np.asarray(jf.score[b]), np.asarray(jf.valid[b]))
        tset = _kp_set(tf.xy[b].numpy(), tf.score[b].numpy(), tf.valid[b].numpy())
        assert jset == tset
        n_valid += len(tset)
        # descriptors of the same keypoints (order may differ between paths)
        jv = np.asarray(jf.valid[b])
        jd = {(int(x), int(y)): d for (x, y), d in zip(np.asarray(jf.xy[b])[jv], np.asarray(jf.desc[b])[jv])}
        tv = tf.valid[b].numpy()
        for (x, y), d in zip(tf.xy[b].numpy()[tv], tf.desc[b].numpy()[tv]):
            np.testing.assert_allclose(d, jd[(int(x), int(y))], atol=1e-6)
    return n_valid


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 96, 256)])
@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_select_matches_jax(shape, backend):
    rng = np.random.default_rng(sum(shape))
    heat = _peaky(rng, *shape)
    assert _compare(heat, _coarse(rng, *shape), 64, backend) >= 64 * shape[0] // 2


@pytest.mark.parametrize("shape", [(2, 96, 200), (1, 64, 136)])
def test_block_max_at_radius_8_matches_xla_path(shape):
    """The plain block pooling at the kernel's largest radius, on widths that
    are not multiples of 128, against the JAX XLA path; K is the number of
    blocks, so every kept block is compared."""
    B, H, W = shape
    rng = np.random.default_rng(11)
    heat = _peaky(rng, *shape)
    n_kept = int((nms_block_max_plain(torch.as_tensor(heat), 8)[0] > 0).sum())
    assert n_kept > 10 * B
    assert _compare(heat, _coarse(rng, *shape), (H // 4) * (W // 4), "xla", nms_radius=8) == n_kept


def test_launch_plan_covers_the_image():
    """The kernel's warps: each lane one float4 of a row, ceil(r/4) halo lanes
    at each warp edge, just enough warps across a row and bands of
    BAND_ROWS rows down it, no warp wholly outside the image."""
    assert launch_plan((8, 600, 960), 4) == dict(halo_lanes=1, lanes=30, col_warps=8, bands=75, warps=4800)
    for r in range(9):
        for H in (4, 8, 16, 20, 160, 600):
            for W in (4, 36, 112, 120, 124, 132, 224, 960):
                p = launch_plan((3, H, W), r)
                assert p["halo_lanes"] == -(-r // 4) and p["lanes"] == 32 - 2 * p["halo_lanes"]
                assert (p["col_warps"] - 1) * p["lanes"] < W // 4 <= p["col_warps"] * p["lanes"]
                assert (p["bands"] - 1) * BAND_ROWS < H <= p["bands"] * BAND_ROWS
                assert p["warps"] == 3 * p["bands"] * p["col_warps"]


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 96, 256)])
def test_block_max_matches_pallas_pooling(shape):
    """The kernel's output itself: the Pallas per-4-row maxima, pooled over
    columns as superpoint.py:282-293 does, equal the plain block maxima and
    indices."""
    heat = _peaky(np.random.default_rng(7), *shape)
    vals4, idx4, Wp = nms_pooled_batched(jnp.asarray(heat), 4, 0.005, 4, interpret=True)
    B, H, W = shape
    # the Pallas output runs to a multiple of its 64-row tile
    rv = np.asarray(vals4)[:, :H // 4].reshape(B, H // 4, W // 4, 4)
    ri = np.asarray(idx4)[:, :H // 4].reshape(B, H // 4, W // 4, 4)
    bv, bi = rv[..., 0], ri[..., 0]
    for j in range(1, 4):
        better = rv[..., j] > bv
        bv, bi = np.where(better, rv[..., j], bv), np.where(better, ri[..., j], bi)
    vals, idx = nms_block_max_plain(torch.as_tensor(heat))
    assert (bv > 0).sum() > 20
    np.testing.assert_array_equal(vals.numpy(), bv)
    np.testing.assert_array_equal(idx.numpy(), bi)
    # the wrapper takes the plain version on CPU tensors, without a launch
    n = nms_block_max.launches
    wv, wi = nms_block_max(torch.as_tensor(heat))
    assert nms_block_max.launches == n
    assert torch.equal(wv, vals) and torch.equal(wi, idx)


def test_select_border_and_threshold():
    H, W = 64, 128
    heat = np.zeros((1, H, W), np.float32)
    heat[0, 2, 50] = 0.9  # border strip (y < 4)
    heat[0, 30, W - 3] = 0.95  # border strip (x >= W - 4)
    heat[0, 30, 60] = 0.004  # below threshold 0.005
    heat[0, 20, 40] = 0.8  # keeper
    heat[0, 21, 42] = 0.7  # suppressed by the keeper's 9x9 window
    coarse = np.ones((1, H // 8, W // 8, 16), np.float32) / 4.0
    for backend in ("pallas_interpret", "xla"):
        jcfg = JConfig(max_keypoints=16, descriptor_dim=16, topk_method="exact", desc_sample_dtype=None,
                       nms_backend=backend)
        jf = jselect(jnp.asarray(heat), jnp.asarray(coarse), jcfg)
        assert _kp_set(np.asarray(jf.xy[0]), np.asarray(jf.score[0]), np.asarray(jf.valid[0])) == {
            (40, 20, float(np.float32(0.8)))}
    tf = select_keypoints(torch.as_tensor(heat), torch.as_tensor(coarse),
                          SuperPointConfig(max_keypoints=16, descriptor_dim=16, desc_sample_dtype=None))
    assert _kp_set(tf.xy[0].numpy(), tf.score[0].numpy(), tf.valid[0].numpy()) == {(40, 20, float(np.float32(0.8)))}
    vals, idx = nms_block_max_plain(torch.as_tensor(heat))
    assert int((vals > 0).sum()) == 1 and int(idx[0, 5, 10]) == 20 * W + 40
    # an empty block reports 0 and its top-left pixel
    assert float(vals[0, 0, 0]) == 0.0 and int(idx[0, 3, 7]) == 12 * W + 28


def test_tie_rule_is_row_major_first():
    """Equal survivors in one block: the XLA path's row-major argmax (the
    smallest y, then the smallest x) in the JAX package and the port."""
    H, W = 64, 128
    heat = np.zeros((1, H, W), np.float32)
    heat[0, 21, 43] = heat[0, 22, 41] = 0.5  # block (5, 10): (x 43, y 21) wins
    heat[0, 40, 80] = heat[0, 40, 81] = 0.6  # block (10, 20): (x 80, y 40) wins
    coarse = np.ones((1, H // 8, W // 8, 16), np.float32) / 4.0
    jcfg = JConfig(max_keypoints=16, descriptor_dim=16, topk_method="exact", desc_sample_dtype=None,
                   nms_backend="xla")
    jf = jselect(jnp.asarray(heat), jnp.asarray(coarse), jcfg)
    want = {(43, 21, 0.5), (80, 40, float(np.float32(0.6)))}
    assert _kp_set(np.asarray(jf.xy[0]), np.asarray(jf.score[0]), np.asarray(jf.valid[0])) == want
    tf = select_keypoints(torch.as_tensor(heat), torch.as_tensor(coarse),
                          SuperPointConfig(max_keypoints=16, descriptor_dim=16, desc_sample_dtype=None))
    assert _kp_set(tf.xy[0].numpy(), tf.score[0].numpy(), tf.valid[0].numpy()) == want


@pytest.mark.parametrize("shape,K", [((1, 62, 128), 64), ((1, 48, 96), 512)])
def test_off_block_shapes_take_dense_topk(shape, K):
    """Rows not a multiple of 4, or fewer blocks than K: the dense top-k on
    both sides, decided from the shape."""
    cfg = SuperPointConfig(max_keypoints=K, descriptor_dim=32, desc_sample_dtype=None)
    assert not block_path(cfg, *shape[1:])
    rng = np.random.default_rng(5)
    heat = _peaky(rng, *shape)
    coarse = _coarse(rng, shape[0], shape[1] // 8 * 8, shape[2])
    assert _compare(heat, coarse, K, "xla") > 10
    with pytest.raises(ValueError, match="multiples of 4"):
        nms_block_max_plain(torch.as_tensor(heat)[:, :, :-2])


def test_unknown_backend_raises():
    heat = torch.zeros((1, 64, 128))
    with pytest.raises(ValueError, match="nms_backend"):
        select_keypoints(heat, torch.zeros((1, 8, 16, 16)), SuperPointConfig(nms_backend="pallas"))
