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


def _raw_poses(rng, n, near_singular):
    """(n, 3, 4) raw DLT-like poses s [R | t] + noise, s of either sign; near
    singular: M's smallest singular value set to 1e-3 of the others."""
    R = np.stack([se3_exp(torch.as_tensor(rng.normal(size=6) * [0.1, 0.1, 0.1, 1, 1, 1])).numpy()[:3, :3]
                  for _ in range(n)])
    M = R * rng.uniform(0.3, 3.0, (n, 1, 1)) * rng.choice([-1.0, 1.0], (n, 1, 1)) + rng.normal(size=(n, 3, 3)) * 0.05
    if near_singular:
        U, S, Vh = np.linalg.svd(M)
        S[:, 2] = 1e-3 * S[:, 0]
        M = U @ (S[..., None] * Vh)
    return np.concatenate([M, rng.normal(size=(n, 3, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("near_singular", [False, True])
def test_one_polar_factor_gives_orthogonalize_pose(rng, near_singular):
    """csrc/pnp_refine.cu takes one polar factor of each start: the second
    SVD (of -M) and the depth-majority flip of orthogonalize_pose give the
    same R and t, so the flip's choice never matters. Points on both sides
    of the camera, so that about half of the poses take the flip."""
    P = torch.as_tensor(_raw_poses(rng, 400, near_singular))
    X = torch.as_tensor(rng.normal(size=(400, 50, 3)) * [3, 3, 10] + [0, 0, 1], dtype=torch.float32)
    valid = torch.as_tensor(rng.random((400, 50)) > 0.2)
    R, t = tpnp._svd_pose(P[..., :3], P[..., 3], 1.0)
    z = (R[:, None, 2] * X).sum(-1) + t[:, 2:3]
    flipped = (((z < 0) & valid).sum(-1) > ((z > 0) & valid).sum(-1)).float().mean()
    assert 0.2 < flipped < 0.8, flipped
    got = tpnp.orthogonalize_pose(P, X, valid)
    torch.testing.assert_close(got, torch.cat([R, t[..., None]], -1), rtol=0, atol=1e-6)
    torch.testing.assert_close(got[..., :3] @ got[..., :3].transpose(-1, -2), torch.eye(3).expand(400, 3, 3),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("minimal, n_starts, identity", [("dlt6", 3, 48.0), ("dlt6", 3, 0.0), ("dlt6", 1, 48.0),
                                                         ("dlt6", 8, 48.0), ("p3p", 3, 48.0)])
def test_refine_and_select_takes_the_plain_version_on_the_cpu(rng, monkeypatch, minimal, n_starts, identity):
    """solve_pnp_ransac hands its top-k starts to pnp_kernel.refine_and_select,
    which on CPU tensors is refine_and_select_plain (equal outputs) and
    launches nothing."""
    from forest_slam_tpu_torch.geometry import pnp_kernel

    _, tc = _cams()
    X, uv, valid, T = _problem(rng, N=300)
    Hyp = 128
    G = torch.as_tensor(-np.log(-np.log(rng.uniform(1e-12, 1.0, (2, Hyp, 300)))), dtype=torch.float32)
    U = torch.as_tensor(rng.uniform(1e-9, 1.0, (2, 300)), dtype=torch.float32)
    seen = []
    real = pnp_kernel.refine_and_select
    monkeypatch.setattr(pnp_kernel, "refine_and_select", lambda *a: seen.append(a) or real(*a))
    launches = real.launches
    two = lambda a: torch.as_tensor(np.stack([a, a[::-1].copy()]))  # noqa: E731
    res = tpnp.solve_pnp_ransac(two(X), two(uv), two(valid), tc, n_hypotheses=Hyp, n_starts=n_starts,
                                identity_prior_anneal=identity, gumbel=G, uniform=U, minimal=minimal)
    assert len(seen) == 1 and seen[0][2].shape == (2, n_starts)
    plain = pnp_kernel.refine_and_select_plain(*seen[0])
    for a, b in zip(res, plain):
        assert torch.equal(a, b)
    assert real.launches == launches
    assert bool(res.ok.all()) and (res.t[0] - torch.as_tensor(T[:3, 3], dtype=torch.float32)).abs().max() < 0.05


def _chip_smoke():
    """chip_smoke.py, whose PnP agreement check the card tests use."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_candidates_plain_reports_gated_counts():
    """candidates_plain's ``gated`` list gets each refinement step's gated
    counts (pairs, starts) and changes none of its outputs."""
    from forest_slam_tpu_torch.geometry import pnp_kernel

    args = _chip_smoke().pnp_stage_args(torch.device("cpu"), 3, 300, "dlt6", 48.0, n_hypotheses=64)
    gated = []
    counted = pnp_kernel.candidates_plain(*args[:-1], gated=gated)
    for a, b in zip(counted, pnp_kernel.candidates_plain(*args[:-1])):
        assert torch.equal(a, b)
    assert len(gated) == 8 and all(g.shape == (3, 4) for g in gated)
    assert all(bool((g <= args[5].sum(-1, keepdim=True)).all()) for g in gated)


def test_pnp_degenerate_maps_candidates_to_starts():
    """Candidates [3 refined starts, the unrefined first start, the refined
    identity]: a candidate is degenerate where its start gated one or two
    points in a step (start 1: two, the identity: one; start 2 none, which
    leaves its step exactly zero); -1 stands for any start."""
    gated = [torch.tensor([[100.0, 2.0, 0.0, 1.0]]).expand(6, 4), torch.tensor([[90.0, 50.0, 0.0, 80.0]]).expand(6, 4)]
    chosen = torch.tensor([0, 1, 2, 3, 4, -1])
    assert _chip_smoke().pnp_degenerate(gated, chosen, 3).tolist() == [False, True, False, False, True, True]


@pytest.mark.parametrize("camera", ["synthetic", "botanic"])
def test_pnp_refine_agreement_passes_the_plain_version_and_fails_a_moved_pose(camera):
    """chip_smoke.pnp_refine_agreement, which the card tests and the smoke
    run hold the kernel to: the plain version's own result agrees on every
    pair; a translation moved by 1e-3 in a pair with no degenerate start,
    or inlier counts off by three, do not."""
    from forest_slam_tpu_torch.geometry import pnp_kernel

    cs = _chip_smoke()
    args = cs.pnp_stage_args(torch.device("cpu"), 4, 400, "dlt6", 48.0, n_hypotheses=1024, camera=camera)
    ref = pnp_kernel.refine_and_select_plain(*args)
    a = cs.pnp_refine_agreement(ref, args)
    assert a["ok"] and a["apart"] == 0 and a["max_R_err"] == 0 and a["max_t_err"] == 0, a
    gated = []
    pnp_kernel.candidates_plain(*args[:-1], gated=gated)
    clean = ~cs.pnp_degenerate(gated, torch.full((4,), -1), 3)
    assert bool(clean.any())
    moved = ref._replace(t=ref.t.clone())
    moved.t[int(torch.nonzero(clean)[0]), 0] += 1e-3
    assert not cs.pnp_refine_agreement(moved, args)["ok"]
    assert not cs.pnp_refine_agreement(ref._replace(n_inliers=ref.n_inliers + 3), args)["ok"]
