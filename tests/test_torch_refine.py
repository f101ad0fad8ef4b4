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
