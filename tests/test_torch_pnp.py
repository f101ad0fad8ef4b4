"""PnP-RANSAC of the port against the JAX package, with injected draws.

The JAX solver draws its minimal-sample Gumbel noise and its preemptive
subset uniforms from ``jax.random``; the test replaces those two functions
so both sides consume the same numpy draws. Differences left: the JAX
minimal-sample gather is a bf16 hi/lo one-hot product (exact to ~2^-16
relative), its SPD inverse is an unrolled Cholesky (the port's an LU), and
its Gauss-Newton Jacobian comes from jacfwd (the port's is analytic). So
poses agree to 1e-4 and inlier sets to within a point or two.
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


def _cams(dist=np.zeros(5, np.float32)):
    return (JCam(K=jnp.asarray(KMAT), dist=jnp.asarray(dist), width=960, height=600),
            PinholeCamera(K=torch.as_tensor(KMAT), dist=torch.as_tensor(dist), width=960, height=600))


def _problem(rng, N=320, outliers=0.3):
    X = np.column_stack([rng.uniform(-4, 4, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 25, N)])
    xi = np.array([0.02, -0.01, 0.15, 0.01, -0.02, 0.005])
    T = se3_exp(torch.as_tensor(xi)).numpy()
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * KMAT[0, 0] + KMAT[:2, 2]
    uv += rng.normal(size=uv.shape) * 0.2
    bad = rng.random(N) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    valid = rng.random(N) > 0.05
    return X.astype(np.float32), uv.astype(np.float32), valid, T


def test_nullspace_and_orthogonalize_match(rng):
    A = rng.normal(size=(16, 12, 12)).astype(np.float32)
    j = np.asarray(jax.jit(jpnp.nullspace_inverse_iteration, static_argnums=1)(jnp.asarray(A), 12))
    t = tpnp.nullspace_inverse_iteration(torch.as_tensor(A), 12).numpy()
    cos = np.abs((j * t).sum(-1))
    assert cos.min() > 1 - 1e-4, cos.min()
    X, uv, valid, T = _problem(rng)
    P = (T[:3] * 1.7).astype(np.float32)
    jo = np.asarray(jpnp.orthogonalize_pose(jnp.asarray(P), jnp.asarray(X), jnp.asarray(valid)))
    to = tpnp.orthogonalize_pose(torch.as_tensor(P), torch.as_tensor(X), torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(to, jo, atol=1e-5)


@pytest.mark.parametrize("dist", [np.zeros(5, np.float32), np.array([-0.03, 0.01, 5e-4, -5e-4, 0], np.float32)])
def test_gauss_newton_analytic_jacobian_matches_jacfwd(rng, dist):
    jc, tc = _cams(dist)
    X, uv, valid, T = _problem(rng, outliers=0.0)
    T0 = (se3_exp(torch.tensor([0.01, 0.0, -0.02, 0.003, 0.0, 0.002], dtype=torch.float64)) @ torch.as_tensor(T)).float().numpy()
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.asarray(jax.vmap(lambda p: jpnp.project_points(p, jc))(jnp.asarray(pc, jnp.float32)))
    j = np.asarray(jpnp._gauss_newton_refine(jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                                            jc, 1.0, iters=8))
    t = tpnp.gauss_newton_refine(torch.as_tensor(T0), torch.as_tensor(X), torch.as_tensor(np.array(uv)), torch.as_tensor(valid),
                                 tc, 1.0, iters=8).numpy()
    np.testing.assert_allclose(t, j, atol=2e-4)
    np.testing.assert_allclose(t, T, atol=2e-3)


def test_solve_pnp_ransac_matches_with_injected_draws(rng, monkeypatch):
    jc, tc = _cams()
    X, uv, valid, T = _problem(rng)
    N, Hyp = X.shape[0], 256
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (Hyp, N)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, N).astype(np.float32)
    weights = rng.uniform(0.05, 1.0, N).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape))
    solve = jax.jit(lambda X, uv, v, w: jpnp.solve_pnp_ransac(X, uv, v, jc, jax.random.PRNGKey(0),
                                                              n_hypotheses=Hyp, weights=w))
    jr = solve(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(weights))
    tr = tpnp.solve_pnp_ransac(torch.as_tensor(X)[None], torch.as_tensor(uv)[None], torch.as_tensor(valid)[None], tc,
                               n_hypotheses=Hyp, weights=torch.as_tensor(weights)[None],
                               gumbel=torch.as_tensor(G)[None], uniform=torch.as_tensor(U)[None])
    assert bool(jr.ok) and bool(tr.ok[0])
    np.testing.assert_allclose(tr.R[0].numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t[0].numpy(), np.asarray(jr.t), atol=1e-4)
    assert abs(int(tr.n_inliers[0]) - int(jr.n_inliers)) <= 2
    assert (tr.inliers[0].numpy() != np.asarray(jr.inliers)).sum() <= 2
    np.testing.assert_allclose(tr.t[0].numpy(), T[:3, 3], atol=0.05)


def test_stable_topk_order():
    from forest_slam_tpu_torch.geometry.ransac import stable_topk

    counts = torch.tensor([[3, 5, 5, 1, 5, 3]])
    assert stable_topk(counts, 4).tolist() == [[1, 2, 4, 0]]
    ref = jax.lax.top_k(jnp.asarray(counts.numpy()), 4)[1]
    assert np.asarray(ref).tolist() == [[1, 2, 4, 0]]
