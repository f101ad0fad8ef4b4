"""The port's ORB extraction against the JAX package on rendered frames.

Two 224x160 corridor frames, the default configuration (512 features, 8
levels; the JAX side on its XLA detection path). Level-0 keypoints are
identical, at least 98% of keypoints are shared at every level, descriptor
bits are equal for at least 99% of shared keypoints (the orientation moments'
summation order may move an angle across a 12 degree bin edge), angles agree
to 1e-3 rad and responses to rtol 1e-5 where the keypoints coincide.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend import orb as jorb
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu_torch.frontend import orb as torb
from _torch_threads import one_torch_thread  # noqa: F401


def _unpack(desc):
    desc = np.asarray(desc).astype(np.uint64)
    return ((desc[..., None] >> np.arange(32, dtype=np.uint64)) & 1).reshape(*desc.shape[:-1], 256)


@pytest.fixture(scope="module")
def extracted():
    seq = render_sequence(n_frames=2, height=160, width=224, seed=11, speed=0.15)
    imgs = np.array(seq.images_left, np.float32)
    jfn = jax.jit(lambda im: jorb.extract_orb(im, jorb.OrbConfig(detect_backend="xla")))
    jf = [jfn(jnp.asarray(im)) for im in imgs]
    tf = torb.extract_orb(torch.as_tensor(imgs), torb.OrbConfig())
    return jf, tf


def test_extract_orb_matches_jax(extracted):
    jf, tf = extracted
    _, budgets = torb._level_geometry(160, 224, torb.OrbConfig())
    starts = np.cumsum([0] + budgets)
    n_levels_with_points = 0
    for b, j in enumerate(jf):
        jxy, jv, jd = np.asarray(j.xy), np.asarray(j.valid), _unpack(j.desc)
        txy, tv, td = tf.xy[b].numpy(), tf.valid[b].numpy(), _unpack(tf.desc[b].numpy())
        np.testing.assert_array_equal(tf.octave[b].numpy(), np.asarray(j.octave))
        lv0 = slice(0, budgets[0])
        assert jv[lv0].sum() > 50
        np.testing.assert_array_equal(tv[lv0], jv[lv0])
        np.testing.assert_array_equal(txy[lv0], jxy[lv0])
        for lvl in range(len(budgets)):
            sl = slice(starts[lvl], starts[lvl + 1])
            js = {tuple(p): k for k, p in enumerate(jxy[sl][jv[sl]].tolist())}
            ts = {tuple(p): k for k, p in enumerate(txy[sl][tv[sl]].tolist())}
            if not js and not ts:
                continue
            n_levels_with_points += 1
            shared = set(js) & set(ts)
            assert len(shared) >= 0.98 * max(len(js), len(ts)), (b, lvl, len(shared), len(js), len(ts))
            jd_l, td_l = jd[sl][jv[sl]], td[sl][tv[sl]]
            same = [np.array_equal(jd_l[js[p]], td_l[ts[p]]) for p in shared]
            assert np.mean(same) >= 0.99, (b, lvl, np.mean(same))
    assert n_levels_with_points >= 8  # at least four levels per frame


def test_extract_orb_angles_and_responses(extracted):
    jf, tf = extracted
    for b, j in enumerate(jf):
        same = (np.asarray(j.xy) == tf.xy[b].numpy()).all(-1) & np.asarray(j.valid)
        da = np.abs(np.angle(np.exp(1j * (tf.angle[b].numpy()[same] - np.asarray(j.angle)[same]))))
        assert da.max() < 1e-3
        np.testing.assert_allclose(tf.response[b].numpy()[same], np.asarray(j.response)[same], rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(j.response)).max())
