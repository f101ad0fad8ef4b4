"""Sparse stereo of the port against the JAX package.

Frames are rendered corridor views rounded to 8-bit values, as a camera
delivers them: the prefiltered values are then multiples of 0.25, every SAD
sum is exact in float32, and the comparisons are bit for bit (tolerance 0)
whatever order either side sums in.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu.stereo.disparity import _prefilter
from forest_slam_tpu.stereo.pallas_sparse import sparse_cost_rows as jsparse_cost_rows
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JCfg
from forest_slam_tpu.stereo.sparse import _cost_rows_gather
from forest_slam_tpu.stereo.sparse import sparse_disparity_at_keypoints as jdisparity
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig, prefilter, sparse_disparity_at_keypoints
from forest_slam_tpu_torch.stereo.sparse_kernel import (
    MAX_KEYPOINTS_PER_BLOCK,
    SMEM_DEFAULT_BYTES,
    SMEM_OPTIN_BYTES,
    keypoint_bytes,
    launch_plan,
    sparse_cost_rows,
    sparse_cost_rows_plain,
)
from _torch_threads import one_torch_thread  # noqa: F401

H, W, D, w = 160, 224, 48, 7


@pytest.fixture(scope="module")
def scene():
    seq = render_sequence(n_frames=1, height=H, width=W, seed=5)
    il = np.round(np.array(seq.images_left[0], np.float32))
    ir = np.round(np.array(seq.images_right[0], np.float32))
    rng = np.random.default_rng(1)
    xy = np.column_stack([rng.integers(0, W, 200), rng.integers(0, H, 200)]).astype(np.float32)
    xy[:4] = [[0, 0], [W - 1, H - 1], [2, 80], [W - 3, 5]]  # borders and clamping
    xy[4:40] += rng.uniform(-0.49, 0.49, (36, 2)).astype(np.float32)  # fractional keypoints
    return il, ir, xy


def test_prefilter_matches(scene):
    il, _, _ = scene
    ref = np.asarray(_prefilter(jnp.asarray(il), 31.0))
    np.testing.assert_array_equal(prefilter(torch.as_tensor(il)[None], 31.0)[0].numpy(), ref)


def test_plain_cost_equals_gather_path_and_pallas_interpret(scene):
    il, ir, xy = scene
    pl = np.array(_prefilter(jnp.asarray(il), 31.0))
    pr = np.array(_prefilter(jnp.asarray(ir), 31.0))
    xi = np.round(xy[:, 0]).astype(np.int32)
    yi = np.round(xy[:, 1]).astype(np.int32)
    got = sparse_cost_rows_plain(torch.as_tensor(pl)[None], torch.as_tensor(pr)[None],
                                 torch.as_tensor(xi)[None], torch.as_tensor(yi)[None], D, w)[0].numpy()
    gather = np.asarray(_cost_rows_gather(jnp.asarray(pl), jnp.asarray(pr), jnp.asarray(xi), jnp.asarray(yi),
                                          JCfg(num_disparities=D, window=w)))
    np.testing.assert_array_equal(got, gather)
    interp = np.asarray(jsparse_cost_rows(jnp.asarray(pl), jnp.asarray(pr), jnp.asarray(xi[:64]),
                                          jnp.asarray(yi[:64]), D, w, interpret=True))
    np.testing.assert_array_equal(got[:64], interp)
    # the wrapper takes the plain version for CPU tensors
    wrapped = sparse_cost_rows(torch.as_tensor(pl)[None], torch.as_tensor(pr)[None],
                               torch.as_tensor(xi)[None], torch.as_tensor(yi)[None], D, w)[0].numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("D, w", [(96, 7), (128, 9)])
def test_plain_cost_equals_gather_path_at_kernel_shapes(scene, D, w):
    """The paths' D = 96, w = 7, and D = 128, w = 9, which the TPU kernel
    refuses (D + w - 1 > 128, w > 8) and the CUDA kernel takes."""
    il, ir, xy = scene
    pl = np.array(_prefilter(jnp.asarray(il), 31.0))
    pr = np.array(_prefilter(jnp.asarray(ir), 31.0))
    xi = np.round(xy[:, 0]).astype(np.int32)
    yi = np.round(xy[:, 1]).astype(np.int32)
    got = sparse_cost_rows_plain(torch.as_tensor(pl)[None], torch.as_tensor(pr)[None],
                                 torch.as_tensor(xi)[None], torch.as_tensor(yi)[None], D, w)[0].numpy()
    gather = np.asarray(_cost_rows_gather(jnp.asarray(pl), jnp.asarray(pr), jnp.asarray(xi), jnp.asarray(yi),
                                          JCfg(num_disparities=D, window=w)))
    assert got.shape == (len(xi), D) and (got > 0).any()
    np.testing.assert_array_equal(got, gather)


def test_launch_plan():
    """Keypoints a block: as many as fit in 48 KB, at most 8, at least 1
    (one keypoint past 48 KB takes the opt-in limit); each shared row on 16
    bytes; refused: windows outside 1..15, D < 1, a strip past the opt-in
    limit."""
    assert keypoint_bytes(96, 7) == 4 * (7 * 12 + 7 * 108 + 4)
    assert launch_plan(96, 7) == dict(keypoints_per_block=8, smem_bytes=8 * 3376)
    for D, w in [(1, 1), (48, 7), (96, 6), (128, 9), (160, 15), (1000, 15), (3000, 15)]:
        p = launch_plan(D, w)
        per = keypoint_bytes(D, w)
        kp = p["keypoints_per_block"]
        assert per % 16 == 0 and per >= 4 * (w * (w + 3) + w * (D + w + 2))
        assert p["smem_bytes"] == kp * per <= max(SMEM_DEFAULT_BYTES, per) and per <= SMEM_OPTIN_BYTES
        assert 1 <= kp <= MAX_KEYPOINTS_PER_BLOCK and (kp == MAX_KEYPOINTS_PER_BLOCK or (kp + 1) * per > SMEM_DEFAULT_BYTES)
    for D, w in [(96, 0), (96, 16), (96, 17), (0, 7), (4000, 15)]:
        with pytest.raises(ValueError):
            launch_plan(D, w)


@pytest.mark.parametrize("cost_path", ["auto", "plain"])
def test_disparity_bit_for_bit_with_gather_path(scene, cost_path):
    il, ir, xy = scene
    jd, jv = jdisparity(jnp.asarray(il), jnp.asarray(ir), jnp.asarray(xy), JCfg(num_disparities=D, cost_path="gather"))
    td, tv = sparse_disparity_at_keypoints(
        torch.as_tensor(il)[None], torch.as_tensor(ir)[None], torch.as_tensor(xy)[None],
        SparseStereoConfig(num_disparities=D, cost_path=cost_path),
    )
    jv = np.asarray(jv)
    assert jv.sum() > 60
    assert not jv[:3].any()
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
