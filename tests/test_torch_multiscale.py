"""Multi-scale extraction and the unfused-GNN slice of the port against the
JAX package.

- Octave sizes: Python's ``round``, then down to a multiple of the total
  stride, as learned.py:107-108 does (the lowres gate's 160x224 at octaves
  1.7 and 2.89 gives 256x352 and 448x640).
- Upsampling: ``resize_bilinear`` against ``jax.image.resize(..., "linear")``
  at 160x224 -> 256x352 and -> 448x640 on 0-255 images, to 1e-4 (two
  float32 ulps at 255 are 3e-5).
- Cross-octave duplicate suppression against the reference's
  ``lexsort((-score, cell))`` rule, with colliding cells and equal scores.
- The flagship's extraction at octaves (1.0, 2.0) on 64x128 frames, float32
  on both sides, the JAX side on its Pallas selection in interpret mode
  (both octaves are 128-lane wide): test_torch_superpoint.py's single-scale
  tolerances, keypoints and validity identical, scores to 1e-5, descriptors
  to 1e-4 on the valid slots.
- The slice at small size: five 96x128 corridor frames through
  ``run_stereo_vo_device`` in both packages, octaves (1.0, 2.0), K=128, the
  unfused matcher with 2 of the flagship's 9 layer pairs, refine radius 12.
  (At 64x128 the corridor gives at most 3 PnP inliers a pair on either side,
  so no pair passes the gate and only identities would be compared.) The
  RANSAC draws differ between the packages, so the comparison is of
  outcomes: the same pairs pass the gate, match and inlier counts within 2
  (bf16 roundings may flip near-tie matches), map validity agreeing on 97%,
  and poses to 1e-3, as tests/test_torch_pipeline.py holds relative poses.
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.base import learned_frontend as jlearned_frontend
from forest_slam_tpu.frontend.learned import LearnedFrontend as JLearned
from forest_slam_tpu.frontend.learned import LearnedFrontendConfig as JLFConfig
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JSPConfig
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JSparse
from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.frontend.base import learned_frontend
from forest_slam_tpu_torch.frontend.learned import _duplicates, octave_shape
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig
from forest_slam_tpu_torch.utils.filters import resize_bilinear
from _torch_threads import one_torch_thread  # noqa: F401

K = 128
SCALES = (1.0, 2.0)
F32 = {"dtype": torch.float32, "desc_sample_dtype": torch.float32}


@pytest.fixture(scope="module")
def jparams():
    state = serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())["params"]
    return {"superpoint": {"params": {"net": state["superpoint"]["params"]}}, "superglue": state["superglue"]}


def _jfrontend():
    return JLearned(JLFConfig(
        superpoint=JSPConfig(stem_stride=4, max_keypoints=K, topk_method="exact", nms_backend="pallas_interpret",
                             dtype=jnp.float32, desc_sample_dtype=jnp.float32),
        superglue=JSGConfig(gnn_layers=2, gnn_impl="xla", attention_impl="fused_interpret", sinkhorn_impl="xla"),
        scales=SCALES,
    ))


def _tfrontend(H, W):
    return load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device="cpu", scales=SCALES, superpoint_overrides=F32,
                                 superglue_overrides={"gnn_impl": "xla", "gnn_layers": 2})


def test_octave_shapes():
    assert [octave_shape(160, 224, s, 32) for s in (1.0, 1.7, 2.89)] == [(160, 224), (256, 352), (448, 640)]
    assert octave_shape(64, 128, 2.0, 32) == (128, 256)
    assert octave_shape(600, 960, 0.707, 32) == (416, 672)


@pytest.mark.parametrize("hw", [(256, 352), (448, 640)])
def test_resize_upsample_matches_jax(hw):
    x = (np.random.default_rng(2).random((3, 160, 224)) * 255).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + hw, "linear"))
    got = resize_bilinear(torch.as_tensor(x), *hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_duplicates_follow_lexsort():
    rng = np.random.default_rng(3)
    B, M = 3, 200
    cell = rng.integers(0, 40, (B, M)).astype(np.int32)
    cell[:, ::7] = -(np.arange(M, dtype=np.int32)[::7] + 1)  # unique sentinels
    score = rng.integers(0, 6, (B, M)).astype(np.float32) / 5.0  # many equal scores
    want = np.zeros((B, M), bool)
    for b in range(B):
        order = np.lexsort((-score[b], cell[b]))
        sc = cell[b][order]
        want[b][order] = np.concatenate([[False], sc[1:] == sc[:-1]])
    got = _duplicates(torch.as_tensor(cell), torch.as_tensor(score)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 100


def test_multiscale_extract_matches_jax(jparams):
    H, W = 64, 128
    imgs = np.array(render_sequence(n_frames=2, height=H, width=W, seed=5, speed=0.15).images_left, np.float32)
    jf = _jfrontend().extract(jparams, jnp.asarray(imgs))
    tf = _tfrontend(H, W).extract(torch.as_tensor(imgs))
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
    np.testing.assert_allclose(tf.score.numpy()[valid], np.asarray(jf.score)[valid], atol=1e-5)
    np.testing.assert_allclose(tf.desc.numpy()[valid], np.asarray(jf.desc)[valid], atol=1e-4)
    # both octaves contribute: the 2.0 octave's keypoints land on half pixels
    xy = tf.xy.numpy()[valid]
    assert valid.sum() > 100 and (xy % 1 != 0).any() and (xy % 1 == 0).all(-1).any()


def test_slice_matches_jax(jparams):
    H, W, N, HYP = 96, 128, 5, 256
    seq = render_sequence(n_frames=N, height=H, width=W, seed=11, speed=0.15)
    il, ir = np.array(seq.images_left, np.float32), np.array(seq.images_right, np.float32)
    jrig = seq.rig
    jcfg = jst.StereoConfig(sparse=JSparse(num_disparities=48), n_hypotheses=HYP, compose_mode="odometry",
                            match_refine_radius=12)
    jfront = jlearned_frontend(_jfrontend())
    run = jax.jit(lambda a, b, p, k: jst.run_stereo_vo_device(a, b, jrig, jcfg, k, jfront, p, frame_batch=N,
                                                              pair_batch=N - 1))
    jout = run(jnp.asarray(il), jnp.asarray(ir), jparams, jax.random.PRNGKey(0))

    tcfg = tst.StereoConfig(sparse=SparseStereoConfig(num_disparities=48), n_hypotheses=HYP,
                            compose_mode="odometry", match_refine_radius=12)
    cam = PinholeCamera(K=torch.as_tensor(np.array(jrig.left.K)), dist=torch.zeros(5), width=W, height=H)
    trig = StereoRig(cam, cam, torch.as_tensor(np.array(jrig.T_left_right)))
    g = torch.Generator()
    g.manual_seed(0)
    tout = tst.run_stereo_vo_device(torch.as_tensor(il), torch.as_tensor(ir), trig, tcfg, g,
                                    learned_frontend(_tfrontend(H, W)), frame_batch=N, pair_batch=N - 1)
    ok = np.asarray(jout.ok)
    assert ok.sum() >= 2
    np.testing.assert_array_equal(tout.ok.numpy(), ok)
    assert np.abs(tout.n_matches.numpy() - np.asarray(jout.n_matches)).max() <= 2
    assert np.abs(tout.n_inliers.numpy() - np.asarray(jout.n_inliers)).max() <= 2
    assert (tout.map_valid.numpy() == np.asarray(jout.map_valid)).mean() >= 0.97
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose), atol=1e-3)
