"""The port's ORB front end against the JAX package, module by module.

Inputs are made with numpy from a seed (or rendered by the JAX package's
corridor renderer) and handed to both sides. Tolerances:

- FAST scores, the static BRIEF/moment tables, Hamming distances and mutual
  matches: exact (differences, minima, maxima, integers);
- Harris: rtol 1e-5 (sums of float32 products in another order than XLA's
  convolution);
- the resize: 1e-3 against ``jax.image.resize`` at the main path's first
  pyramid step, and 1e-6 of the 0-255 range against the float64 product of
  JAX's own weight matrices at every step of a pyramid (``jax.image.resize`` itself is up to
  ~5e-3 off that product at some steps on the CPU);
- cell-pooled detection: the same finite mask, values to rtol 1e-5 and equal
  indices where finite, as tests/test_pallas_detect.py holds the Pallas
  kernel;
- whole extraction: tests/test_torch_orb_extract.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend import matching as jmatch
from forest_slam_tpu.frontend import orb as jorb
from forest_slam_tpu.frontend.fast import fast_score_map as jfast
from forest_slam_tpu.frontend.fast import harris_response as jharris
from forest_slam_tpu.frontend.fast import nms_topk as jnms_topk
from forest_slam_tpu.frontend.pallas_detect import detect_pooled as pallas_detect_pooled
from forest_slam_tpu.utils.filters import maxpool2d_same as jmaxpool
from forest_slam_tpu_torch.frontend import matching as tmatch
from forest_slam_tpu_torch.frontend import orb as torb
from forest_slam_tpu_torch.frontend.detect_kernel import detect_pooled, detect_pooled_plain
from forest_slam_tpu_torch.frontend.fast import fast_score_map, harris_response, nms_topk
from forest_slam_tpu_torch.utils.filters import resize_bilinear


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("integer", [True, False])
def test_fast_score_map_exact(integer):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (70, 90)) if integer else rng.uniform(0, 255, (70, 90))
    img = img.astype(np.float32)
    ref = np.asarray(jfast(jnp.asarray(img), 20.0))
    got = fast_score_map(_t(img), 20.0).numpy()
    assert (ref > 0).sum() > 100
    np.testing.assert_array_equal(got, ref)


def test_harris_response():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (70, 90)).astype(np.float32)
    ref = np.asarray(jharris(jnp.asarray(img), 7))
    got = harris_response(_t(img), 7).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_nms_topk_exact():
    """Integer FAST scores hold many equal values: ties keep index order."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 50, 64)).astype(np.float32)
    score = fast_score_map(_t(img), 20.0)
    xy, vals, valid = nms_topk(score, 400)
    for b in range(2):
        jxy, jvals, jvalid = jnms_topk(jnp.asarray(score[b].numpy()), 400)
        assert 0 < int(valid[b].sum()) < 400
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(vals[b].numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(xy[b].numpy(), np.asarray(jxy))


def test_resize_bilinear_main_path_step():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (600, 960)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (500, 800), method="linear"))
    np.testing.assert_allclose(resize_bilinear(_t(img), 500, 800).numpy(), ref, rtol=0, atol=1e-3)


def _resize_weights(n_in, n_out):
    """(n_out, n_in) weights of an antialiased "linear" resize along one axis,
    computed in float32 step by step as jax.image.resize's weight matrix
    (half-pixel centres, the triangle widened by the scale factor on a
    downsample, columns normalised)."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(max(inv, 1.0))
    w = np.maximum(f32(0), f32(1) - x)
    return (w / w.sum(0, keepdims=True)).T


def test_resize_bilinear_pyramid_jax_weights():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for n_in, n_out in ((160, 133), (224, 187)):  # the same weights as JAX's
        jw = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True))
        np.testing.assert_allclose(_resize_weights(n_in, n_out), jw.T, rtol=1e-6, atol=1e-9)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (160, 224)).astype(np.float32)
    sizes, _ = torb._level_geometry(160, 224, torb.OrbConfig())
    level = img
    for h, w, _ in sizes[1:]:
        wy, wx = _resize_weights(level.shape[0], h).astype(np.float64), _resize_weights(level.shape[1], w).astype(np.float64)
        got = resize_bilinear(_t(level)[None], h, w)[0].numpy()
        np.testing.assert_allclose(got, wy @ level.astype(np.float64) @ wx.T, rtol=0, atol=1e-6 * 255)
        level = got


def _jax_pooled(img, threshold=20.0, block=7, margin=16):
    """The XLA detection path (orb.py:_extract_level) pooled per 8x8 cell with
    argmax over the flattened cell, indices y * W + x."""
    H, W = img.shape
    fast = jfast(img, threshold)
    ranked = jnp.where(fast > 0.0, jharris(img, block), -jnp.inf)
    ys, xs = jnp.arange(H)[:, None], jnp.arange(W)[None, :]
    ranked = jnp.where((ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin), ranked, -jnp.inf)
    is_max = ranked >= jmaxpool(ranked, 3)
    kept = np.asarray(jnp.where(is_max & jnp.isfinite(ranked), ranked, -jnp.inf))
    ncy, ncx = -(-H // 8), -(-W // 8)
    kp = np.full((ncy * 8, ncx * 8), -np.inf, np.float32)
    kp[:H, :W] = kept
    tiles = kp.reshape(ncy, 8, ncx, 8).transpose(0, 2, 1, 3).reshape(ncy, ncx, 64)
    k = tiles.argmax(-1)
    ys = np.arange(ncy)[:, None] * 8 + k // 8
    xs = np.arange(ncx)[None, :] * 8 + k % 8
    return tiles.max(-1), ys * W + xs, kept


@pytest.mark.parametrize("shape", [(96, 160), (83, 157)])
def test_detect_pooled_plain_matches_xla_path(shape):
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 255, (2,) + shape).astype(np.float32)
    vals, idx = detect_pooled_plain(_t(imgs))
    assert vals.shape == idx.shape == (2, -(-shape[0] // 8), -(-shape[1] // 8))
    assert idx.dtype == torch.int32
    # on a CPU tensor the wrapper is the plain version
    n = detect_pooled.launches
    v2, i2 = detect_pooled(_t(imgs))
    assert detect_pooled.launches == n
    assert torch.equal(v2, vals) and torch.equal(i2, idx)
    for b in range(2):
        ref_v, ref_i, _ = _jax_pooled(jnp.asarray(imgs[b]))
        v, i = vals[b].numpy(), idx[b].numpy()
        fin = np.isfinite(ref_v)
        assert fin.sum() > 50
        assert (np.isfinite(v) == fin).all()
        np.testing.assert_allclose(v[fin], ref_v[fin], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(i[fin], ref_i[fin])


@pytest.mark.parametrize("shape", [(96, 160), (83, 157)])
def test_detect_pooled_plain_matches_pallas_interpret(shape):
    """Against the Pallas kernel in interpret mode, in the cells whose
    maximum is unique (where the two tie rules agree); its indices are
    y * round_up(W, 128) + x."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    pv, pi, Wp = pallas_detect_pooled(jnp.asarray(img), interpret=True)
    ncy, ncx = -(-shape[0] // 8), -(-shape[1] // 8)
    pv, pi = np.asarray(pv)[:ncy, :ncx], np.asarray(pi)[:ncy, :ncx]
    vals, idx = detect_pooled_plain(_t(img)[None])
    v, i = vals[0].numpy(), idx[0].numpy()
    _, _, kept = _jax_pooled(jnp.asarray(img))
    fin = np.isfinite(v)
    assert (np.isfinite(pv) == fin).all()
    np.testing.assert_allclose(pv[fin], v[fin], rtol=1e-5, atol=1e-6)
    H, W = shape
    kp = np.full((ncy * 8, ncx * 8), -np.inf, np.float32)
    kp[:H, :W] = kept
    tiles = kp.reshape(ncy, 8, ncx, 8).transpose(0, 2, 1, 3).reshape(ncy, ncx, 64)
    unique = fin & ((tiles == tiles.max(-1, keepdims=True)).sum(-1) == 1)
    assert unique.sum() > 0.9 * fin.sum()
    np.testing.assert_array_equal((pi // Wp) * W + pi % Wp, np.where(unique, i, (pi // Wp) * W + pi % Wp))


def test_select_keypoints_matches_jax_with_padding():
    """More budget than cells on a small level: -inf padding slots and equal
    scores in index order, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(6)
    blocks = rng.integers(0, 256, (6, 8)).astype(np.float32)
    img = np.kron(blocks, np.ones((8, 8), np.float32))[:44, :60]  # blocky: many equal responses
    cfg = torb.OrbConfig(edge_margin=4)
    xy, score, valid = torb._select_keypoints(_t(img)[None], 70, cfg)
    _, _, kept = _jax_pooled(jnp.asarray(img), margin=4)
    jxy, jscore, jvalid = jorb._select_keypoints(jnp.asarray(kept), 70, 8)
    assert 0 < int(valid.sum()) < 70
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(xy[0].numpy(), np.asarray(jxy))
    np.testing.assert_allclose(score[0].numpy(), np.asarray(jscore), rtol=1e-5, atol=1e-6)


def test_static_tables_equal_jax():
    np.testing.assert_array_equal(torb._brief_pattern(77), jorb._brief_pattern(77))
    np.testing.assert_array_equal(torb._rotated_patterns(77, 30), jorb._rotated_patterns(77, 30))
    np.testing.assert_array_equal(torb._moment_matrix(), jorb._moment_matrix())
    # the gather indices select exactly the +1 / -1 entries of JAX's one-hot
    # difference matrix (a column is all zero where the two points coincide)
    sel = jorb._brief_select_matrix(77, 30)
    flat = torb._brief_flat_index(77, 30).reshape(-1, 2)
    rebuilt = np.zeros_like(sel)
    cols = np.arange(flat.shape[0])
    np.add.at(rebuilt, (flat[:, 0], cols), -1.0)
    np.add.at(rebuilt, (flat[:, 1], cols), 1.0)
    np.testing.assert_array_equal(rebuilt, sel)
    for h, w in [(600, 960), (160, 224)]:
        assert torb._level_geometry(h, w, torb.OrbConfig()) == jorb._level_geometry(h, w, jorb.OrbConfig())


def test_hamming_and_mutual_nn_exact():
    rng = np.random.default_rng(7)
    da = rng.integers(0, 2**32, (3, 60, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, (3, 50, 8), dtype=np.uint64).astype(np.uint32)
    db[:, :10] = da[:, :10]  # exact duplicates: distance 0
    db[:, 10:20] = da[:, 10:20] ^ np.uint32(0x10001)  # distance 2
    db[:, 20] = db[:, 21]  # equal columns: argmin ties to the first
    va = rng.uniform(size=(3, 60)) < 0.9
    vb = rng.uniform(size=(3, 50)) < 0.9
    t_a, t_b = _t(da.astype(np.int64)), _t(db.astype(np.int64))
    dist = tmatch.hamming_distance_matrix(t_a, t_b)
    assert dist.dtype == torch.int32
    for b in range(3):
        jd = np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(da[b]), jnp.asarray(db[b])))
        np.testing.assert_array_equal(dist[b].numpy(), jd)
        for max_d in (None, 64, 1):
            jm = np.asarray(jmatch.mutual_nn_match(jnp.asarray(jd), jnp.asarray(va[b]), jnp.asarray(vb[b]), max_d))
            tm = tmatch.mutual_nn_match(dist[b:b + 1], _t(va[b:b + 1]), _t(vb[b:b + 1]), max_d)[0].numpy()
            np.testing.assert_array_equal(tm, jm)
    assert (tm >= 0).sum() > 0


def test_gather_matched_points():
    rng = np.random.default_rng(10)
    xa, xb = rng.normal(size=(30, 2)).astype(np.float32), rng.normal(size=(25, 2)).astype(np.float32)
    m = rng.integers(-1, 25, 30).astype(np.int32)
    ref = jmatch.gather_matched_points(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(m))
    got = tmatch.gather_matched_points(_t(xa)[None], _t(xb)[None], _t(m)[None])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))


def test_unpack_bits_pm1_exact():
    rng = np.random.default_rng(8)
    d = rng.integers(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jmatch.unpack_bits_pm1(jnp.asarray(d)))
    np.testing.assert_array_equal(tmatch.unpack_bits_pm1(_t(d.astype(np.int64))).numpy(), ref)
