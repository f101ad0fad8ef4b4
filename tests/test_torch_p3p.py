"""P3P (Grunert) of the port against the JAX package.

- ``solve_quartic`` and ``p3p_grunert`` on the same inputs. The quartic's
  roots agree slot by slot to float32 rounding of Ferrari's closed form
  (complex64 on both sides, 1e-3 relative to the roots' size), but for the
  sign of an imaginary part: a square root of a value on the negative real
  axis may take the other branch, which swaps a conjugate pair. P3P reads
  only the near-real roots. The poses are matched up to order: in float32
  a root near a double root is ill-conditioned, and the two frameworks'
  roundings (XLA fuses the coefficient arithmetic) then decide whether it
  counts as real and where Newton takes it. So on random triples at least
  85% must agree (the same number of valid poses, each within 1e-2 of one
  of the other side's), and the port must recover the true pose in at
  least 90% of them and in no fewer than the JAX solver less two (in float32
  both miss about 3%).
- The P3P branch of ``solve_pnp_ransac`` with the JAX draws handed over, as
  tests/test_torch_pnp.py does for the DLT-6 branch: poses to 1e-4, inlier
  counts within 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.geometry import pnp as jpnp
from forest_slam_tpu_torch.core.camera import PinholeCamera
from forest_slam_tpu_torch.core.lie import se3_exp
from forest_slam_tpu_torch.geometry import pnp as tpnp
from _torch_threads import one_torch_thread  # noqa: F401

KMAT = np.array([[643.2, 0, 479.5], [0, 643.2, 299.5], [0, 0, 1]], np.float32)


def _pose(xi=(0.02, -0.01, 0.15, 0.01, -0.02, 0.005)):
    return se3_exp(torch.as_tensor(np.asarray(xi, np.float64))).numpy()


def _triples(rng, n):
    """n triples of points in front of the camera, their unit bearings under
    the pose ``T`` and ``T``."""
    T = _pose()
    X = np.stack([rng.uniform(-4, 4, (n, 3)), rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(3, 25, (n, 3))], -1)
    pc = X @ T[:3, :3].T + T[:3, 3]
    f = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    return X.astype(np.float32), f.astype(np.float32), T


def test_solve_quartic_matches():
    rng = np.random.default_rng(3)
    c = rng.normal(size=(5, 64)).astype(np.float32)
    c[:, :8] = np.array([1, -10, 35, -50, 24], np.float32)[:, None]  # roots 1, 2, 3, 4
    c[:, 8:12] = np.array([1, 0, -5, 0, 4], np.float32)[:, None]  # biquadratic: q = 0
    j = np.asarray(jpnp._solve_quartic(*map(jnp.asarray, c)))
    t = tpnp.solve_quartic(*map(torch.as_tensor, c)).numpy()
    # the same roots in the same slots, conjugate pairs either way round
    tol = 1e-3 * (1 + np.abs(j)).max()
    np.testing.assert_allclose(t.real, j.real, rtol=1e-3, atol=tol)
    np.testing.assert_allclose(np.abs(t.imag), np.abs(j.imag), rtol=1e-3, atol=tol)
    np.testing.assert_allclose(np.sort(t[0].real), [1, 2, 3, 4], atol=1e-3)
    np.testing.assert_allclose(np.sort(t[8].real), [-2, -1, 1, 2], atol=1e-3)


def test_p3p_grunert_matches_up_to_order():
    rng = np.random.default_rng(0)
    n = 64
    X, f, T = _triples(rng, n)
    j = np.asarray(jax.jit(jax.vmap(jpnp._p3p_grunert))(jnp.asarray(X), jnp.asarray(f)))  # (n, 4, 3, 4)
    t = tpnp.p3p_grunert(torch.as_tensor(X), torch.as_tensor(f)).numpy()
    assert t.shape == (n, 4, 3, 4)
    jv = np.isfinite(j).all((-1, -2))
    tv = np.isfinite(t).all((-1, -2))

    def agree(i):
        if jv[i].sum() != tv[i].sum():
            return False
        return all(min(np.abs(a - b).max() for b in j[i][jv[i]]) < 1e-2 for a in t[i][tv[i]])

    def found(P, v, i):
        return any(np.abs(a - T[:3]).max() < 1e-3 for a in P[i][v[i]])

    assert sum(agree(i) for i in range(n)) >= 0.85 * n
    t_found = sum(found(t, tv, i) for i in range(n))
    assert t_found >= 0.9 * n
    assert t_found >= sum(found(j, jv, i) for i in range(n)) - 2


def test_p3p_ransac_matches_with_injected_draws(monkeypatch):
    rng = np.random.default_rng(1)
    jc = JCam(K=jnp.asarray(KMAT), dist=jnp.zeros(5), width=960, height=600)
    tc = PinholeCamera(K=torch.as_tensor(KMAT), dist=torch.zeros(5), width=960, height=600)
    N, Hyp = 300, 128
    T = _pose()
    X = np.column_stack([rng.uniform(-4, 4, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 25, N)])
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * KMAT[0, 0] + KMAT[:2, 2] + rng.normal(size=(N, 2)) * 0.2
    bad = rng.random(N) < 0.6  # a wide-baseline inlier rate
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    X, uv = X.astype(np.float32), uv.astype(np.float32)
    valid = rng.random(N) > 0.05
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (Hyp, N)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, N).astype(np.float32)
    weights = rng.uniform(0.05, 1.0, N).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape))
    jr = jax.jit(lambda X, uv, v, w: jpnp.solve_pnp_ransac(X, uv, v, jc, jax.random.PRNGKey(0), n_hypotheses=Hyp,
                                                           weights=w, minimal="p3p"))(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(weights))
    tr = tpnp.solve_pnp_ransac(torch.as_tensor(X)[None], torch.as_tensor(uv)[None], torch.as_tensor(valid)[None], tc,
                               n_hypotheses=Hyp, weights=torch.as_tensor(weights)[None], minimal="p3p",
                               gumbel=torch.as_tensor(G)[None], uniform=torch.as_tensor(U)[None])
    assert bool(jr.ok) and bool(tr.ok[0])
    np.testing.assert_allclose(tr.R[0].numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t[0].numpy(), np.asarray(jr.t), atol=1e-4)
    assert abs(int(tr.n_inliers[0]) - int(jr.n_inliers)) <= 2
    np.testing.assert_allclose(tr.t[0].numpy(), T[:3, 3], atol=0.05)


def test_unknown_minimal_solver_raises():
    with pytest.raises(ValueError, match="minimal"):
        tpnp.solve_pnp_ransac(torch.zeros(1, 8, 3), torch.zeros(1, 8, 2), torch.ones(1, 8, dtype=torch.bool),
                              PinholeCamera(K=torch.as_tensor(KMAT), dist=torch.zeros(5), width=960, height=600),
                              n_hypotheses=4, minimal="epnp")
