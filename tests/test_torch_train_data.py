"""The port's training data (forest_slam_tpu_torch.train.data) and blur
augmentation against train/data.py and train/trainer.py, with the same
draws handed to both sides: each test draws with ``jax.random`` from the
reference's own key splits and gives the values to the port.

Tolerances:
- homographies rtol 1e-5; corners and transferred points within 1e-3 px;
  validity masks equal (corridor pairs: at most one point flips at the
  occlusion test's and the border's edges);
- painted corner scenes: at most 0.2% of pixels differ (cos/sin one ulp
  apart may move a rectangle edge across a pixel centre), the rest within
  1e-4;
- warps within 1e-2 gray levels but where the reference and the port's
  adjugate inverse put a sample on either side of an image edge (at most
  0.5% of pixels);
- texture images within 0.02 gray levels: ``jax.image.resize``'s upsampling
  is not the plain bilinear weights to the last bit (the port's
  utils/filters.py holds 3e-5 on 0-1 inputs, times 255); the Harris
  teacher on the same image gives the same points;
- rendered corridor views within 1e-2 gray levels off texture-sampling
  edges (99% of pixels);
- the whole batch of make_training_batch: corners and masks as above,
  images as their generators;
- blur: bit-identical regions, blurred values within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.io import synthetic as jsyn
from forest_slam_tpu.train import data as J
from forest_slam_tpu.train.trainer import TrainConfig as JTrainConfig
from forest_slam_tpu.train.trainer import _blur_training_batch
from forest_slam_tpu_torch.io.synthetic import make_corridor_world
from forest_slam_tpu_torch.train import data as T
from forest_slam_tpu_torch.train.trainer import BlurDraws, blur_images
from _torch_threads import one_torch_thread  # noqa: F401

H, W = 64, 80


def _t(a):
    return torch.as_tensor(np.array(a))


def _u(key, shape, lo=0.0, hi=1.0):
    return _t(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def jax_corner_draws(keys, n_shapes):
    out = []
    for k in keys:
        ks = jax.random.split(k, 6)
        m = min(H, W)
        out.append(T.CornerDraws(
            bg=_u(ks[0], (H, W)),
            centers=_u(ks[1], (n_shapes, 2), jnp.array([W * 0.1, H * 0.1]), jnp.array([W * 0.9, H * 0.9])),
            sizes=_u(ks[2], (n_shapes, 2), m * 0.08, m * 0.35),
            angles=_u(ks[3], (n_shapes,), 0.0, jnp.pi),
            intensities=_u(ks[4], (n_shapes,), 0.0, 255.0),
            order=_u(ks[5], (4 * n_shapes,)),
        ))
    return T.CornerDraws(*(torch.stack(x) for x in zip(*out)))


def jax_homography_draws(keys):
    out = []
    for k in keys:
        ks = jax.random.split(k, 4)
        out.append(T.HomographyDraws(angle=_u(ks[0], (), -0.35, 0.35), log_scale=_u(ks[1], (), -0.25, 0.25),
                                     shift=_u(ks[2], (2,), -0.12, 0.12), perspective=_u(ks[3], (2,), -3e-4, 3e-4)))
    return T.HomographyDraws(*(torch.stack(x) for x in zip(*out)))


def jax_texture_draws(keys):
    out = []
    for k in keys:
        ks = jax.random.split(k, 3)
        out.append(T.TextureDraws(_u(ks[0], (H // 8, W // 8)), _u(ks[1], (H // 2, W // 2)), _u(ks[2], (H, W))))
    return T.TextureDraws(*(torch.stack(x) for x in zip(*out)))


def _images_close(got, ref, tol, max_off=0.002):
    off = np.abs(got - ref) > tol
    assert off.mean() <= max_off, (off.mean(), np.abs(got - ref).max())


@pytest.mark.parametrize("n_shapes,max_corners", [(12, 48), (4, 24)])
def test_random_corner_image(n_shapes, max_corners):
    keys = jax.random.split(jax.random.PRNGKey(n_shapes), 3)
    ref = jax.vmap(lambda k: J.random_corner_image(k, H, W, n_shapes, max_corners))(keys)
    img, xy, valid = T.random_corner_image(jax_corner_draws(keys, n_shapes), H, W, max_corners)
    _images_close(img.numpy(), np.asarray(ref[0]), 1e-4)
    np.testing.assert_allclose(xy.numpy(), np.asarray(ref[1]), atol=1e-3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))


def test_random_homography_and_points():
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    ref = np.stack([np.asarray(J.random_homography(k, H, W)) for k in keys])
    got = T.random_homography(jax_homography_draws(keys), H, W).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pts = np.random.default_rng(0).uniform([0, 0], [W, H], size=(4, 30, 2)).astype(np.float32)
    ref_p = np.stack([np.asarray(J.apply_homography(jnp.asarray(ref[i]), jnp.asarray(pts[i]))) for i in range(4)])
    np.testing.assert_allclose(T.apply_homography(_t(ref), _t(pts)).numpy(), ref_p, atol=1e-3)


def test_warp_image():
    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    Hm = np.stack([np.asarray(J.random_homography(k, H, W)) for k in keys])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = 120 + 60 * np.sin(xs / 6.0) + 50 * np.cos(ys / 5.0)
    corner_img = np.asarray(J.random_corner_image(keys[0], H, W)[0])
    imgs = np.stack([smooth, corner_img, smooth[::-1]]).astype(np.float32)
    ref = np.stack([np.asarray(J.warp_image(jnp.asarray(imgs[i]), jnp.asarray(Hm[i]))) for i in range(3)])
    got = T.warp_image(_t(imgs), _t(Hm)).numpy()
    _images_close(got, ref, 1e-2, max_off=0.005)


def test_random_texture_image():
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ref = jax.vmap(lambda k: J.random_texture_image(k, H, W, 24))(keys)
    img, xy, valid = T.random_texture_image(jax_texture_draws(keys), H, W, 24)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref[0]), atol=0.02)
    # the teacher on the reference's own images: the same points
    xy_r, valid_r = T.teacher_points(_t(ref[0]), 24)
    np.testing.assert_array_equal(xy_r.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(valid_r.numpy(), np.asarray(ref[2]))
    # and on the port's: most points at the same pixels
    same = [(np.abs(xy.numpy()[b, :, None] - np.asarray(ref[1])[b, None]).sum(-1) == 0).any(1)[valid.numpy()[b]]
            for b in range(2)]
    assert np.concatenate(same).mean() >= 0.9


@pytest.fixture(scope="module")
def corridor_world():
    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 8)
    return key, ks, jsyn.make_corridor_world(ks[0])


def test_corridor_pair(corridor_world):
    key, ks, jworld = corridor_world
    ref = J.corridor_pair(key, H, W, 32, noise_sigma=0.0, min_forward=0.5, max_forward=1.5)
    draws = T.CorridorDraws(
        p0=_t(jnp.zeros(3) + jax.random.uniform(ks[1], (3,), minval=jnp.array([-2.0, -0.4, 0.0]),
                                                maxval=jnp.array([2.0, 0.4, 20.0]))),
        w0=_u(ks[2], (3,), jnp.array([-0.08, -0.3, -0.05]), jnp.array([0.08, 0.3, 0.05])),
        forward=_u(ks[3], (), 0.5, 1.5), lateral=_u(ks[4], (2,), -0.15, 0.15), w1=_u(ks[5], (3,), -0.06, 0.06))
    world = make_corridor_world(textures=np.array(jworld.textures), device="cpu")
    got = T.corridor_pair(world, draws, H, W, 32)
    for name in ("image0", "image1"):
        _images_close(getattr(got, name)[0].numpy(), np.asarray(getattr(ref, name)), 1e-2, max_off=0.01)
    v0 = np.asarray(ref.valid0)
    assert v0.sum() >= 10
    np.testing.assert_array_equal(got.corners0[0].numpy(), np.asarray(ref.corners0))
    np.testing.assert_array_equal(got.valid0[0].numpy(), v0)
    np.testing.assert_allclose(got.corners1[0].numpy()[v0], np.asarray(ref.corners1)[v0], atol=1e-3)
    assert (got.valid1[0].numpy() != np.asarray(ref.valid1)).sum() <= 1


def test_make_training_batch_from_pool():
    B, M, n_pool = 6, 24, 5
    tex, cor = 0.34, 0.34
    rng = np.random.default_rng(1)
    pool_np = J.TrainingBatch(
        image0=rng.uniform(0, 255, (n_pool, H, W)).astype(np.float32),
        image1=rng.uniform(0, 255, (n_pool, H, W)).astype(np.float32),
        corners0=rng.uniform(0, 60, (n_pool, M, 2)).astype(np.float32),
        corners1=rng.uniform(0, 60, (n_pool, M, 2)).astype(np.float32),
        valid0=rng.random((n_pool, M)) < 0.8, valid1=rng.random((n_pool, M)) < 0.6)
    key = jax.random.PRNGKey(12)
    ref = J.make_training_batch(key, B, H, W, M, tex, cor, J.TrainingBatch(*map(jnp.asarray, pool_np)))
    n_cor, n_tex, n_rest = T.batch_split(B, tex, cor)
    assert (n_cor, n_tex, n_rest) == (2, 2, 2)
    keys = jax.random.split(key, B)
    k_idx, k_n0, k_n1 = jax.random.split(keys[0], 3)
    sub = lambda ks, i: [jax.random.split(k, 3)[i] for k in ks]
    tex_keys, cor_keys = keys[n_cor:n_cor + n_tex], keys[n_cor + n_tex:]
    normal = lambda ks: torch.stack([_t(jax.random.normal(k, (H, W))) for k in ks])
    draws = T.BatchDraws(
        pool_index=_t(jax.random.randint(k_idx, (n_cor,), 0, n_pool)).long(),
        pool_noise0=_t(jax.random.normal(k_n0, (n_cor, H, W))), pool_noise1=_t(jax.random.normal(k_n1, (n_cor, H, W))),
        texture=jax_texture_draws(sub(tex_keys, 0)), texture_homography=jax_homography_draws(sub(tex_keys, 1)),
        texture_noise=normal(sub(tex_keys, 2)),
        corner=jax_corner_draws(sub(cor_keys, 0), 12), corner_homography=jax_homography_draws(sub(cor_keys, 1)),
        corner_noise=normal(sub(cor_keys, 2)))
    got = T.training_batch(draws, H, W, M, T.TrainingBatch(*map(_t, pool_np)))
    for name in ("valid0", "corners0"):
        np.testing.assert_array_equal(getattr(got, name)[:n_cor].numpy(), np.asarray(getattr(ref, name))[:n_cor])
    np.testing.assert_allclose(got.image0[:n_cor].numpy(), np.asarray(ref.image0)[:n_cor], atol=1e-4)
    # texture pairs: the images as their generator; corner pairs exact labels
    np.testing.assert_allclose(got.image0[n_cor:n_cor + n_tex].numpy(), np.asarray(ref.image0)[n_cor:n_cor + n_tex],
                               atol=0.05)
    c = slice(n_cor + n_tex, B)
    _images_close(got.image0[c].numpy(), np.asarray(ref.image0)[c], 1e-3)
    _images_close(got.image1[c].numpy(), np.asarray(ref.image1)[c], 1e-2, max_off=0.005)
    np.testing.assert_allclose(got.corners1[c].numpy(), np.asarray(ref.corners1)[c], atol=1e-3)
    np.testing.assert_array_equal(got.valid1[c].numpy(), np.asarray(ref.valid1)[c])
    np.testing.assert_array_equal(got.valid0[c].numpy(), np.asarray(ref.valid0)[c])


def test_make_training_batch_generator():
    """The generator entry point: shapes, labels inside the images, and the
    same batch again from the same seed."""
    def draw():
        g = torch.Generator()
        g.manual_seed(3)
        return T.make_training_batch(g, 5, H, W, 24, 0.4, 0.0, device="cpu")

    b = draw()
    assert b.image0.shape == (5, H, W) and b.corners0.shape == (5, 24, 2)
    assert b.valid0.any() and b.valid1.any() and not (b.valid1 & ~b.valid0).any()
    c1 = b.corners1[b.valid1]
    assert (c1[:, 0] >= 4).all() and (c1[:, 0] < W - 4).all()
    assert all(torch.equal(x, y) for x, y in zip(b, draw()))


def test_blur_matches_reference():
    cfg = JTrainConfig(height=H, width=W, blur_fraction=0.6)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, (2, 4, H, W)).astype(np.float32)
    batch = J.TrainingBatch(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), *(jnp.zeros((4, 3, 2)),) * 2,
                            *(jnp.ones((4, 3), bool),) * 2)
    key = jax.random.PRNGKey(9)
    ref = _blur_training_batch(key, batch, cfg)
    chosen = []
    for view, sk in enumerate(jax.random.split(key)):
        ksel, kp, ka, km = jax.random.split(sk, 4)
        draws = BlurDraws(selected=_u(ksel, (4,)) < 0.6, percentage=_u(kp, (4,), 0.25, 0.75),
                          angle=_u(ka, (4,), 0.0, 180.0),
                          seeds=torch.stack([_u(mk, (H, W)) for mk in jax.random.split(km, 4)]))
        chosen += draws.selected.tolist()
        got = blur_images(_t(imgs[view]), draws, 15).numpy()
        r = np.asarray(ref[view])
        np.testing.assert_array_equal(got == imgs[view], r == imgs[view])
        np.testing.assert_allclose(got, r, atol=1e-4)
    assert any(chosen) and not all(chosen)  # blurred and untouched images both checked
