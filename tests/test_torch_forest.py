"""Forest world and loop trajectory of the port against the JAX package
(io/synthetic.py).

The port draws its textures and trunks from a numpy seed; here it is handed
the JAX world's arrays, so both render the same forest. The same float32 ray
casting in another order, with the trunks' cylinder intersections on top of
the planes. On the corridor intensities agree within 0.1 of 0-255
(tests/test_torch_synthetic.py); a bark coordinate goes through atan2 and a
radius / 0.05 m scale, and the bark is unsmoothed along u, so float32
rounding moves a bark sample further: within 0.5, on average within 2e-3.
Depths to 1e-4 relative, the same pixels hitting nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.io import synthetic as jsyn
from forest_slam_tpu_torch.io import synthetic as tsyn
from _torch_threads import one_torch_thread  # noqa: F401

H, W = 48, 64


@pytest.fixture(scope="module")
def worlds():
    jw = jsyn.make_forest_world(jax.random.PRNGKey(0), z_range=(-5.0, 30.0))
    arrays = tsyn.ForestArrays(np.array(jw.textures), np.array(jw.trunks), np.array(jw.trunk_texture))
    return jw, tsyn.make_forest_world(arrays=arrays, device="cpu")


@pytest.mark.parametrize("frame", [0, 5, 9])
def test_forest_render_matches(worlds, frame):
    jw, tw = worlds
    T = np.asarray(jsyn.corridor_trajectory(10, speed=1.5))[frame]
    rig = jsyn.default_rig(H, W)
    K = np.asarray(rig.left.K)
    for pose in (T, T @ np.asarray(rig.T_left_right)):
        ji, jd = (np.asarray(a) for a in jsyn.render_view(jw, jnp.asarray(pose), jnp.asarray(K), H, W))
        ti, td = (a.numpy() for a in tsyn.render_view(tw, torch.tensor(pose), torch.tensor(K), H, W))
        d = np.abs(ti - ji)
        assert d.max() < 0.5 and d.mean() < 2e-3, (d.max(), d.mean())
        finite = np.isfinite(jd)
        np.testing.assert_array_equal(np.isfinite(td), finite)
        np.testing.assert_allclose(td[finite], jd[finite], rtol=1e-4)


def test_trunks_occlude_in_the_render(worlds):
    """Some pixels see a trunk: nearer than the planes behind them, with the
    bark's values."""
    _, tw = worlds
    rig = tsyn.default_rig(H, W, device="cpu")
    T = tsyn.corridor_trajectory(1, device="cpu")[0]
    planes_only = tw._replace(trunks=tw.trunks[:0])
    img, dep = tsyn.render_view(tw, T, rig.left.K, H, W)
    img0, dep0 = tsyn.render_view(planes_only, T, rig.left.K, H, W)
    nearer = dep < dep0
    assert 0.01 < nearer.float().mean() < 0.9
    assert torch.equal(img[~nearer], img0[~nearer])


def test_forest_arrays_from_a_seed():
    a = tsyn.forest_arrays(seed=3, n_trees=40, z_range=(-5.0, 20.0), texture_px=64)
    b = tsyn.forest_arrays(seed=3, n_trees=40, z_range=(-5.0, 20.0), texture_px=64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a.textures.shape == (4, 64, 64) and a.trunk_texture.shape == (64, 64) and a.trunks.shape == (40, 5)
    assert a.textures.min() >= 0.0 and a.textures.max() <= 255.0
    cx, cz, r, h, u = a.trunks.T
    assert (np.abs(cx) >= 1.6).all() and (np.abs(cx) <= 14.0).all() and (cx < 0).any() and (cx > 0).any()
    assert (cz >= -5.0).all() and (cz <= 20.0).all() and (r >= 0.12).all() and (r <= 0.45).all()
    assert (h == 6.0).all() and (u >= 0).all() and (u <= 64).all()
    # bark streaks run along v: neighbours down a column agree better than along a row
    bark = a.trunk_texture[8:-8, 8:-8]  # away from the zero-padded edges
    assert np.abs(np.diff(bark, axis=0)).mean() < 0.5 * np.abs(np.diff(bark, axis=1)).mean()


def test_out_and_back_trajectory_matches():
    j = np.asarray(jsyn.out_and_back_trajectory(n_forward=6, n_turn=4, speed=0.25, n_rejoin=2))
    t = tsyn.out_and_back_trajectory(n_forward=6, n_turn=4, speed=0.25, n_rejoin=2, device="cpu").numpy()
    assert t.shape == j.shape == (2 * 6 + 2 * 4 + 2 * 2, 4, 4)
    np.testing.assert_allclose(t, j, atol=1e-6)


def test_render_sequence_forest_and_corridor():
    for scene in ("forest", "corridor"):
        seq = tsyn.render_sequence(3, height=32, width=48, speed=1.0, scene=scene, device="cpu")
        assert seq.images_left.shape == seq.images_right.shape == seq.depths_left.shape == (3, 32, 48)
        assert torch.isfinite(seq.images_left).all() and seq.images_left.max() <= 255.0
        assert seq.T_world_cam.shape == (3, 4, 4) and seq.timestamps.shape == (3,)
    with pytest.raises(ValueError, match="scene"):
        tsyn.render_sequence(2, scene="desert", device="cpu")


def test_threefry_draws_equal_jax_random():
    """utils/threefry.py against jax.random, bit for bit: keys, splits and
    float32 uniforms at the ranges the worlds draw."""
    from forest_slam_tpu_torch.utils import threefry

    for seed in (0, 3):
        jk = jax.random.split(jax.random.PRNGKey(seed), 9)
        tk = threefry.split(threefry.prng_key(seed), 9)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(threefry.split(tk[7], 4), np.asarray(jax.random.split(jk[7], 4)))
        for i in (0, 5, 8):
            for lo, hi, shape in ((0.0, 255.0, (40, 24)), (-5.0, 44.0, (150,)), (0.12, 0.45, (150,)), (0.0, 1.0, ())):
                j = np.asarray(jax.random.uniform(jk[i], shape, minval=lo, maxval=hi))
                np.testing.assert_array_equal(threefry.uniform(tk[i], shape, lo, hi), j)
    with pytest.raises(ValueError, match="seed"):
        threefry.prng_key(-1)


def test_jax_drawn_worlds_equal_the_jax_package_worlds():
    """draws="jax" gives the JAX package's worlds of the same seed: the same
    uniforms and the same float32 smoothing (equal here; 1e-4 of 0-255
    allows another summation order), the ground's coarse grid upsampled by
    another library (3e-5 here); trunks exact."""
    px = 128
    jf = jsyn.make_forest_world(jax.random.PRNGKey(0), z_range=(-5.0, 44.0), texture_px=px)
    tf = tsyn.forest_arrays(0, z_range=(-5.0, 44.0), texture_px=px, draws="jax")
    np.testing.assert_array_equal(tf.trunks, np.asarray(jf.trunks))
    np.testing.assert_allclose(tf.textures, np.asarray(jf.textures), atol=1e-4)
    np.testing.assert_allclose(tf.trunk_texture, np.asarray(jf.trunk_texture), atol=1e-4)
    jc = jsyn.make_corridor_world(jax.random.PRNGKey(0), texture_px=px)
    np.testing.assert_allclose(tsyn.corridor_textures(0, px, draws="jax"), np.asarray(jc.textures), atol=1e-4)
    with pytest.raises(ValueError, match="draws"):
        tsyn.corridor_textures(0, 8, draws="torch")
