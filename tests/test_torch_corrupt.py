"""Image corruptions of the port against the JAX package (utils/corrupt.py).

The JAX functions draw with ``jax.random``; the test draws the same numbers
from the same keys (the seed mask of each frame's blur, each frame's gain,
bias, gamma and noise) and hands them to the port. Tolerances: the line
kernel to 1e-6 (float32 sin/cos in another library); the blurred images to
2e-3 gray levels on 0-255 (a 15x15 convolution summed in another order);
the sensor shift to 2e-3 (float32 powers and square roots in another
library). The exposure compensation that the domain-shift gate runs after the
sensor shift (``photo_normalize_stack``) to 1e-3 (float32 means and
standard deviations summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.utils import corrupt as jc
from forest_slam_tpu_torch.utils import corrupt as tc
from _torch_threads import one_torch_thread  # noqa: F401

N, H, W = 3, 48, 64


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (N, H, W)).astype(np.float32)


@pytest.mark.parametrize("k, angle", [(15, 45.0), (9, 0.0), (7, 30.0)])
def test_motion_blur_kernel_matches(k, angle):
    j = np.asarray(jc.motion_blur_kernel(k, angle))
    t = tc.motion_blur_kernel(k, angle).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    assert abs(t.sum() - 1.0) < 1e-5


def test_apply_motion_blur_matches(frames):
    kern = jc.motion_blur_kernel(15, 45.0)
    j = np.asarray(jax.vmap(lambda im: jc.apply_motion_blur(im, 15, 45.0))(jnp.asarray(frames)))
    t = tc.apply_motion_blur(torch.as_tensor(frames), kernel=torch.as_tensor(np.array(kern))).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3)
    t2 = tc.apply_motion_blur(torch.as_tensor(frames), 15, 45.0).numpy()
    np.testing.assert_allclose(t2, j, atol=2e-3)


def test_corrupt_stack_matches_with_the_jax_seeds(frames):
    cfg = tc.BlurConfig(blur_percentage=0.3, kernel_size=15, angle_deg=45.0)
    key = jax.random.PRNGKey(17)
    j = np.asarray(jc.corrupt_stack(jnp.asarray(frames), key, jc.BlurConfig(*cfg)))
    seeds = np.array(jax.vmap(lambda k: jax.random.bernoulli(k, cfg.blur_percentage / 100.0, (H, W)))(
        jax.random.split(key, N)))
    kern = torch.as_tensor(np.array(jc.motion_blur_kernel(15, 45.0)))
    t = tc.corrupt_stack(torch.as_tensor(frames), cfg=cfg, seeds=torch.as_tensor(seeds), kernel=kern).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3)
    changed = np.abs(t - frames) > 1e-3
    assert 0.2 < changed.mean() < 0.95  # regions blurred, others untouched
    # with no blur the stack is returned as it is; a generator's draws work too
    same = tc.corrupt_stack(torch.as_tensor(frames), cfg=cfg._replace(blur_percentage=0.0))
    assert torch.equal(same, torch.as_tensor(frames))
    g = torch.Generator().manual_seed(0)
    drawn = tc.corrupt_stack(torch.as_tensor(frames), g, cfg)
    assert drawn.shape == (N, H, W) and 0.2 < (drawn.numpy() != frames).mean() < 0.95


def _jax_sensor_draws(key, cfg):
    """The values jc.sensor_shift_stack draws for each frame."""
    gain, bias, gamma, noise = [], [], [], []
    for k in jax.random.split(key, N):
        kg, kb, kgam, kn = jax.random.split(k, 4)
        gain.append(jnp.exp(jax.random.uniform(kg, (), minval=-cfg.max_gain, maxval=cfg.max_gain)))
        bias.append(jax.random.uniform(kb, (), minval=-cfg.max_bias, maxval=cfg.max_bias))
        lg = jnp.log1p(cfg.max_gamma)
        gamma.append(jnp.exp(jax.random.uniform(kgam, (), minval=-lg, maxval=lg)))
        noise.append(jax.random.normal(kn, (H, W)))
    return tc.SensorDraws(*(torch.as_tensor(np.array(jnp.stack(a))) for a in (gain, bias, gamma, noise)))


def test_sensor_shift_matches_with_the_jax_draws(frames):
    key = jax.random.PRNGKey(27)
    jcfg = jc.SensorConfig()
    j = np.asarray(jc.sensor_shift_stack(jnp.asarray(frames), key, jcfg))
    t = tc.sensor_shift_stack(torch.as_tensor(frames), draws=_jax_sensor_draws(key, jcfg)).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3)
    assert t.min() >= 0.0 and t.max() <= 255.0


def test_sensor_draws_stay_in_their_ranges():
    cfg = tc.SensorConfig()
    d = tc.sensor_draws((64, 4, 4), cfg, torch.Generator().manual_seed(1), device="cpu")
    assert (d.gain.log().abs() <= cfg.max_gain + 1e-6).all()
    assert (d.bias.abs() <= cfg.max_bias).all()
    assert (d.gamma.log().abs() <= np.log1p(cfg.max_gamma) + 1e-6).all()
    assert d.noise.shape == (64, 4, 4) and abs(float(d.noise.std()) - 1.0) < 0.2


def test_photo_normalize_stack_matches(frames):
    from forest_slam_tpu.pipelines.stereo import photo_normalize_stack as jnorm
    from forest_slam_tpu_torch.pipelines.stereo import photo_normalize_stack

    shifted = frames * 0.6 + 30.0
    shifted[1] = 200.0  # a flat frame: the standard deviation's floor
    j = np.asarray(jnorm(jnp.asarray(shifted)))
    t = photo_normalize_stack(torch.as_tensor(shifted)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-3)
    assert abs(t[0].mean() - 127.0) < 1.0 and abs(t[0].std() - 48.0) < 1.0
