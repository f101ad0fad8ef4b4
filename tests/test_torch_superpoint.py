"""SuperPoint of the port against the JAX package on rendered frames.

Flagship checkpoint, 224x160 corridor frames, K=256, exact top-k on the JAX
side (topk_method="exact"; the XLA selection path, which is what the main
path runs at 960 wide). At float32 on both sides the heat maps agree to
float32 rounding of differently ordered conv sums (atol 1e-5) and the
selected keypoints are identical. At bf16 (the main path's type) rounding
differs between XLA and PyTorch convs, so the bound is wider: one bf16 ulp
in a detector logit (0.125 at logits of 16-32) moves a probability by about
1% of the peak, so heat within 1e-2 (mean 1e-4), and at least 90% of the
keypoints in common.
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax.numpy as jnp

from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JConfig
from forest_slam_tpu.frontend.superpoint import SuperPointNet as JNet
from forest_slam_tpu.frontend.superpoint import select_keypoints as jselect
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, select_keypoints
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, read_checkpoint, superpoint_from_jax

H, W, K = 160, 224, 256


@pytest.fixture(scope="module")
def setup():
    seq = render_sequence(n_frames=2, height=H, width=W, seed=3)
    imgs = np.array(seq.images_left, np.float32)
    state = serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())
    _, tree = read_checkpoint(FLAGSHIP_PATH)
    return imgs, state["params"]["superpoint"]["params"], tree["superpoint"]["params"]


def _run(imgs, jparams, tparams, jdtype, tdtype):
    jcfg = JConfig(stem_stride=4, max_keypoints=K, topk_method="exact", nms_backend="xla",
                   dtype=jdtype, desc_sample_dtype=jdtype)
    raw = JNet(jcfg).apply({"params": jparams}, jnp.asarray(imgs) / 255.0)
    jf = jselect(raw.heat, raw.coarse_desc, jcfg)
    tcfg = SuperPointConfig(stem_stride=4, max_keypoints=K, dtype=tdtype, desc_sample_dtype=tdtype)
    net = superpoint_from_jax(tparams, tcfg)
    with torch.no_grad():
        traw = net(torch.as_tensor(imgs) / 255.0)
        tf = select_keypoints(traw.heat, traw.coarse_desc, tcfg)
    return raw, jf, traw, tf


def test_superpoint_float32_matches(setup):
    imgs, jp, tp = setup
    raw, jf, traw, tf = _run(imgs, jp, tp, jnp.float32, torch.float32)
    np.testing.assert_allclose(traw.heat.numpy(), np.asarray(raw.heat), atol=1e-5)
    np.testing.assert_allclose(traw.coarse_desc.numpy(), np.asarray(raw.coarse_desc), atol=1e-4)
    assert int(np.asarray(jf.valid).sum()) > 100
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.xy.numpy(), np.asarray(jf.xy))
    np.testing.assert_allclose(tf.score.numpy(), np.asarray(jf.score), atol=1e-5)
    np.testing.assert_allclose(tf.desc.numpy(), np.asarray(jf.desc), atol=1e-4)


def test_superpoint_bf16_close(setup):
    imgs, jp, tp = setup
    raw, jf, traw, tf = _run(imgs, jp, tp, jnp.bfloat16, torch.bfloat16)
    d = np.abs(traw.heat.numpy() - np.asarray(raw.heat))
    assert d.max() < 1e-2 and d.mean() < 1e-4, (d.max(), d.mean())
    for b in range(imgs.shape[0]):
        jv = np.asarray(jf.valid[b])
        tv = tf.valid[b].numpy()
        jset = {tuple(p) for p in np.asarray(jf.xy[b])[jv]}
        tset = {tuple(p) for p in tf.xy[b].numpy()[tv]}
        assert len(jset & tset) >= 0.9 * max(len(jset), len(tset)), (len(jset), len(tset), len(jset & tset))


def test_subpixel_com_matches(setup):
    """The com3/com5 readouts of the sub-pixel checkpoints' meta: same
    separable sums, float32 rounding only (atol 1e-5 px)."""
    from forest_slam_tpu.frontend.superpoint import subpixel_com as jcom
    from forest_slam_tpu_torch.frontend.superpoint import subpixel_com

    imgs, jp, tp = setup
    raw, jf, traw, tf = _run(imgs, jp, tp, jnp.float32, torch.float32)
    for radius in (1, 2):
        ref = np.stack([np.asarray(jcom(raw.heat[b], jf.xy[b], jf.valid[b], radius)) for b in range(imgs.shape[0])])
        got = subpixel_com(traw.heat, tf.xy, tf.valid, radius).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        assert np.abs(got - tf.xy.numpy()).max() > 0.01
