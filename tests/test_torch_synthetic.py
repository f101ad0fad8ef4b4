"""Corridor renderer of the port against the JAX package.

The port makes its textures from a numpy seed; here it is handed the JAX
world's texture arrays, so both render the same world. Same float32 ray
casting in another order: a texture coordinate differs by float32 rounding
(~1e-5 texels at coordinates of ~1e3), which moves a bilinear sample by at
most the local gradient times that, so intensities (0-255) within 0.1 and
on average within 1e-3; depths to 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.io import synthetic as jsyn
from forest_slam_tpu_torch.io import synthetic as tsyn

H, W = 120, 160


@pytest.fixture(scope="module")
def worlds():
    jw = jsyn.make_corridor_world(jax.random.PRNGKey(0))
    tw = tsyn.make_corridor_world(textures=np.array(jw.textures), device="cpu")
    return jw, tw


def test_trajectory_and_rig_match():
    jT = np.asarray(jsyn.corridor_trajectory(40, speed=0.15))
    tT = tsyn.corridor_trajectory(40, speed=0.15, device="cpu").numpy()
    np.testing.assert_allclose(tT, jT, atol=1e-5)
    jr = jsyn.default_rig(H, W, baseline=0.25)
    tr = tsyn.default_rig(H, W, baseline=0.25, device="cpu")
    np.testing.assert_array_equal(tr.left.K.numpy(), np.asarray(jr.left.K))
    np.testing.assert_array_equal(tr.T_left_right.numpy(), np.asarray(jr.T_left_right))


@pytest.mark.parametrize("frame", [0, 7, 23])
def test_render_view_matches(worlds, frame):
    jw, tw = worlds
    T = np.asarray(jsyn.corridor_trajectory(24, speed=0.15))[frame]
    rig = jsyn.default_rig(H, W)
    K = np.asarray(rig.left.K)
    for pose in (T, T @ np.asarray(rig.T_left_right)):
        ji, jd = (np.asarray(a) for a in jsyn.render_view(jw, jnp.asarray(pose), jnp.asarray(K), H, W))
        ti, td = (a.numpy() for a in tsyn.render_view(tw, torch.tensor(pose), torch.tensor(K), H, W))
        d = np.abs(ti - ji)
        assert d.max() < 0.1 and d.mean() < 1e-3, (d.max(), d.mean())
        finite = np.isfinite(jd)
        np.testing.assert_array_equal(np.isfinite(td), finite)
        np.testing.assert_allclose(td[finite], jd[finite], rtol=1e-4)


def test_batched_render_equals_single(worlds):
    _, tw = worlds
    Ts = tsyn.corridor_trajectory(3, device="cpu")
    K = tsyn.default_rig(H, W, device="cpu").left.K
    batch, _ = tsyn.render_view(tw, Ts, K, H, W)
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(), tsyn.render_view(tw, Ts[i], K, H, W)[0].numpy())


def test_texture_smoothing_matches_convolve():
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 255, (16, 12)).astype(np.float32)
    ref = np.apply_along_axis(lambda r: np.convolve(r, [0.25, 0.5, 0.25], mode="same"), 0, t)
    ref = np.apply_along_axis(lambda r: np.convolve(r, [0.25, 0.5, 0.25], mode="same"), 1, ref)
    np.testing.assert_allclose(tsyn._smooth(t), ref, atol=1e-4)
