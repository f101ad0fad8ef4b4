"""Match refinement of the port against the JAX package.

- Cost volume: the plain version against the Pallas kernel run in interpret
  mode (with a live count ``nvalid``, so the zero tail is checked too) and
  against the XLA tap accumulation. Integer-valued images make every SAD
  sum exact: tolerance 0.
- refine_matches_quality at scale 1.0 against the JAX XLA path on a shifted
  textured image: ok masks equal, refined coordinates and quality within
  1e-5 (the same float32 arithmetic in another framework).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.pallas_refine import refine_cost_volume_pallas
from forest_slam_tpu.frontend.refine import RefineConfig as JRefineConfig
from forest_slam_tpu.frontend.refine import _cost_volume_xla
from forest_slam_tpu.frontend.refine import refine_matches_quality as jrefine
from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches_quality
from forest_slam_tpu_torch.frontend.refine_kernel import refine_cost_volume, refine_cost_volume_plain
from _torch_threads import one_torch_thread  # noqa: F401

H, W, t, R = 64, 96, 8, 4


def _inputs(rng, B=2, K=24):
    img0 = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    img1 = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    mk = lambda hi: rng.integers(0, hi, (B, K)).astype(np.int32)
    return img0, img1, mk(W), mk(H), mk(W), mk(H)


def test_plain_cost_matches_pallas_interpret_with_nvalid(rng):
    img0, img1, xi0, yi0, xi1, yi1 = _inputs(rng)
    nvalid = np.array([17, 24], np.int32)
    ref = np.asarray(refine_cost_volume_pallas(*map(jnp.asarray, (img0, img1, xi0, yi0, xi1, yi1)), t, R,
                                               interpret=True, nvalid=jnp.asarray(nvalid)))
    args = (*map(torch.as_tensor, (img0, img1, xi0, yi0, xi1, yi1)), t, R, torch.as_tensor(nvalid))
    got = refine_cost_volume_plain(*args).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[0, 17:].any()
    np.testing.assert_array_equal(refine_cost_volume(*args).numpy(), got)


def test_plain_cost_matches_xla_taps(rng):
    img0, img1, xi0, yi0, xi1, yi1 = _inputs(rng, B=1)
    ref = np.asarray(_cost_volume_xla(*map(jnp.asarray, (img0[0], img1[0], xi0[0], yi0[0], xi1[0], yi1[0])), t, R))
    got = refine_cost_volume_plain(*map(torch.as_tensor, (img0, img1, xi0, yi0, xi1, yi1)), t, R,
                                   torch.tensor([xi0.shape[1]], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius", [4, 12])
def test_refine_matches_quality_matches_xla_path(radius):
    rng = np.random.default_rng(0)
    Hs, Ws = 96, 128
    img0 = rng.uniform(0, 255, (Hs, Ws)).astype(np.float32)
    img1 = np.roll(img0, 3, axis=1)
    K = 40
    xy0 = np.column_stack([rng.uniform(20, Ws - 20, K), rng.uniform(20, Hs - 20, K)]).round().astype(np.float32)
    xy1 = (xy0 + np.array([3.0, 0.0]) + rng.uniform(-2, 2, (K, 2))).astype(np.float32)
    valid = rng.random(K) > 0.25
    jo, jok, jq = jrefine(*map(jnp.asarray, (img0, img1, xy0, xy1, valid)), JRefineConfig(radius=radius, cost_path="xla"))
    for path in ("auto", "plain"):
        to, tok, tq = refine_matches_quality(*(torch.as_tensor(a)[None] for a in (img0, img1, xy0, xy1, valid)),
                                             RefineConfig(radius=radius, cost_path=path))
        np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(tq[0].numpy(), np.asarray(jq), atol=1e-5)
    assert np.asarray(jok).sum() > 10


SCALES = (1.0, 1.2, 1.44, 1.7)


def _zoomed_pair(rng, Hs=96, Ws=128, zoom=1.2):
    """A smooth textured frame 0 and frame 1 = frame 0 enlarged ``zoom``x
    about the centre (forward motion onto a fronto-parallel wall), with
    keypoints and their estimates in frame 1."""
    base = rng.uniform(0, 255, (Hs, Ws)).astype(np.float32)
    for axis in (0, 1):  # two [1, 2, 1] / 4 passes a side: gradients at sub-pixel shifts
        for _ in range(2):
            base = (np.roll(base, 1, axis) + 2 * base + np.roll(base, -1, axis)) / 4
    c = np.array([(Ws - 1) / 2, (Hs - 1) / 2])
    ys, xs = np.mgrid[0:Hs, 0:Ws].astype(np.float64)
    sx, sy = c[0] + (xs - c[0]) / zoom, c[1] + (ys - c[1]) / zoom  # frame-1 pixel -> frame-0 position
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    at = lambda y, x: base[np.clip(y, 0, Hs - 1), np.clip(x, 0, Ws - 1)]
    img1 = ((1 - fx) * (1 - fy) * at(y0, x0) + fx * (1 - fy) * at(y0, x0 + 1) + (1 - fx) * fy * at(y0 + 1, x0)
            + fx * fy * at(y0 + 1, x0 + 1)).astype(np.float32)
    K = 48
    xy0 = np.column_stack([rng.uniform(30, Ws - 30, K), rng.uniform(28, Hs - 28, K)]).round()
    xy1 = c + (xy0 - c) * zoom + rng.uniform(-2, 2, (K, 2))
    valid = rng.random(K) > 0.2
    return base, img1, xy0.astype(np.float32), xy1.astype(np.float32), valid


def test_refine_scales_match_xla_path():
    """Scales (1.0, 1.2, 1.44, 1.7), the wide-baseline stack's, radius 4,
    against the JAX XLA path on a frame pair zoomed 1.2x. Frame 0's upscale
    is ``jax.image.resize`` "linear" on one side and ``F.interpolate``
    bilinear on the other: they differ by float32 rounding (3e-5 on these
    0-255 images), which moves SAD sums by little more and can swap a
    scale whose ratio ties another's to that rounding. So at least 90% of
    the keypoints must pick the same ok flag, and where both are ok the
    refined coordinates agree to 0.05 px and the quality to 0.01 for at least
    90% of them; most keypoints pass the gate, and scales other than 1.0 win
    some."""
    rng = np.random.default_rng(1)
    img0, img1, xy0, xy1, valid = _zoomed_pair(rng)
    jo, jok, jq = (np.asarray(a) for a in jrefine(*map(jnp.asarray, (img0, img1, xy0, xy1, valid)),
                                                  JRefineConfig(radius=4, cost_path="xla", scales=SCALES)))
    to, tok, tq = (a[0].numpy() for a in refine_matches_quality(
        *(torch.as_tensor(a)[None] for a in (img0, img1, xy0, xy1, valid)), RefineConfig(radius=4, scales=SCALES)))
    assert (tok == jok).mean() >= 0.9
    both = tok & jok
    assert both.sum() >= 0.5 * valid.sum()
    close = (np.abs(to - jo).max(-1) < 0.05) & (np.abs(tq - jq) < 0.01)
    assert close[both].mean() >= 0.9
    np.testing.assert_array_equal(to[~tok], xy1[~tok])
    one = refine_matches_quality(*(torch.as_tensor(a)[None] for a in (img0, img1, xy0, xy1, valid)),
                                 RefineConfig(radius=4))
    assert (one[2][0].numpy() < tq - 1e-6).any()  # some keypoint found a deeper valley at another scale


def test_refine_scale_one_alone_equals_default():
    rng = np.random.default_rng(2)
    img0, img1, xy0, xy1, valid = _zoomed_pair(rng, zoom=1.0)
    args = [torch.as_tensor(a)[None] for a in (img0, img1, xy0, xy1, valid)]
    a = refine_matches_quality(*args, RefineConfig(radius=4))
    b = refine_matches_quality(*args, RefineConfig(radius=4, scales=(1.0,)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
