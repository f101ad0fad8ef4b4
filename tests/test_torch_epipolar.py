"""Essential-matrix estimation and two-view geometry of the port against the
JAX package, float32, with the RANSAC draws injected.

The JAX side draws its minimal samples' Gumbel noise from
``jax.random.gumbel``; the tests replace it so both sides consume the same
numpy draws. Scenes as tests/test_geometry.py builds them (256 points at
4-12 m, noise 5e-4, 20% or 30% outliers, threshold 1/640). What differs:
the 9x9 inverse of the 8-point nullspace iteration (an unrolled Cholesky
there, LU here), the order of small sums, and the polish's Jacobian (jacfwd
there, analytic here). Tolerances: Sampson errors to rtol 1e-4 (atol
1e-10; the squared threshold is 2.4e-6); the same minimal samples, the
per-hypothesis inlier counts within 1 on 97% of the hypotheses (an
ill-conditioned sample's 8-point nullspace moves with the inverse's
rounding), the same winner and its inlier sets within one point;
after the refit on those inliers (one point more or less moves it), E up
to sign to 1e-3 and inlier sets that differ on at most 3% of the points,
all within 30% of the threshold; whole estimates: inlier sets within one
point, E up to sign, poses and the polish to 1e-4 (recoverPose, given the
same E, to 1e-5); triangulated points to 1e-3 relative. The polish pins
the step along t, which the JAX polish leaves to rounding
(test_polish_keeps_the_sign_of_t).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from forest_slam_tpu.geometry import epipolar as jep
from forest_slam_tpu.geometry import pnp as jpnp
from forest_slam_tpu.geometry import ransac as jransac
from forest_slam_tpu.geometry import triangulation as jtri
from forest_slam_tpu_torch.geometry import epipolar as tep
from forest_slam_tpu_torch.geometry import pnp as tpnp
from forest_slam_tpu_torch.geometry import ransac as transac
from forest_slam_tpu_torch.geometry import triangulation as ttri

N, HYP, THR = 256, 1024, 1.0 / 640.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: with test workers
    sharing the cores, OpenMP's threads contend and slow these ops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_view(rng, n=N, noise=0.0, outlier_frac=0.0):
    """tests/test_geometry.py:synthetic_two_view: x1 = R x0 + t, normalised
    coordinates, the first ``outlier_frac`` of the points replaced."""
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 12], size=(n, 3))
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
    t = rng.normal(size=3) * 0.3
    x0 = pts[:, :2] / pts[:, 2:3]
    p1 = pts @ R.T + t
    x1 = p1[:, :2] / p1[:, 2:3]
    if noise:
        x0 = x0 + rng.normal(scale=noise, size=x0.shape)
        x1 = x1 + rng.normal(scale=noise, size=x1.shape)
    n_out = int(n * outlier_frac)
    if n_out:
        x1[:n_out] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    return x0.astype(np.float32), x1.astype(np.float32), R, t, pts


def gumbel(rng, shape):
    return -np.log(-np.log(rng.uniform(1e-12, 1.0, shape))).astype(np.float32)


def rot_err_deg(Ra, Rb):
    return np.degrees(np.linalg.norm(Rotation.from_matrix(np.asarray(Ra, np.float64).T @ Rb).as_rotvec()))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_estimates(G, x0, x1, valid):
    """The JAX side's minimal samples, raw 8-point hypotheses and their
    inlier counts, find_essential_ransac and estimate_relative_pose, with
    jax.random.gumbel handing out G (traced: a constant G would have XLA
    fold the draws' sort at compile time, for tens of seconds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: G.reshape(shape))
        key = jax.random.PRNGKey(0)
        idx = jransac.ransac_sample_indices(key, valid, HYP, 8)
        Es = jpnp.nullspace_inverse_iteration(jep._epipolar_rows(x0[idx], x1[idx]), 9).reshape(-1, 3, 3)
        errs = jax.vmap(lambda E: jep.sampson_error(E, x0, x1))(Es)
        counts = jnp.sum((errs < THR * THR) & valid[None], axis=1)
        return dict(idx=idx, Es=Es, counts=counts, ransac=jep.find_essential_ransac(x0, x1, valid, key, THR, HYP),
                    pose=jep.estimate_relative_pose(x0, x1, valid, key, THR, HYP))


jax_refine = jax.jit(lambda *a: jep.refine_pose_sampson(*a, THR))


@pytest.fixture(scope="module")
def scenes():
    """Both scenes and the JAX side's estimates of each (one compile)."""
    rng = np.random.default_rng(0)
    run = jax.jit(_jax_estimates)
    out = {}
    for name, frac in (("general", 0.2), ("outliers", 0.3)):
        x0, x1, R, t, _ = two_view(rng, noise=5e-4, outlier_frac=frac)
        valid = rng.random(N) > 0.03
        G = gumbel(rng, (HYP, N))
        out[name] = dict(x0=x0, x1=x1, R=R, t=t, valid=valid, G=G,
                         jax=run(*(jnp.asarray(v) for v in (G, x0, x1, valid))))
    return out


def test_sampson_and_essential_from_pose(scenes):
    s = scenes["general"]
    rng = np.random.default_rng(1)
    R = Rotation.from_rotvec(rng.normal(size=(4, 3)) * 0.1).as_matrix().astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    for i in range(4):
        Ej = np.asarray(jep.essential_from_pose(jnp.asarray(R[i]), jnp.asarray(t[i])))
        Et = tep.essential_from_pose(_t(R[i]), _t(t[i]))
        np.testing.assert_allclose(Et.numpy(), Ej, rtol=1e-6, atol=1e-6)
        ej = np.asarray(jep.sampson_error(jnp.asarray(Ej), jnp.asarray(s["x0"]), jnp.asarray(s["x1"])))
        et = tep.sampson_error(Et, _t(s["x0"]), _t(s["x1"])).numpy()
        np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-10)
        x0h = jnp.concatenate([jnp.asarray(s["x0"]), jnp.ones((N, 1))], -1)
        x1h = jnp.concatenate([jnp.asarray(s["x1"]), jnp.ones((N, 1))], -1)
        sj = np.asarray(jep._signed_sampson(jnp.asarray(R[i]), jnp.asarray(t[i]), x0h, x1h))
        st = tep.signed_sampson(_t(R[i]), _t(t[i]), _t(s["x0"]), _t(s["x1"])).numpy()
        np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-9)
    # the true pose: Sampson zero up to the noise
    E = tep.essential_from_pose(_t(s["R"]), _t(s["t"]))
    assert tep.sampson_error(E, _t(s["x0"][60:]), _t(s["x1"][60:])).max() < 1e-5


def test_triangulation_matches(scenes):
    rng = np.random.default_rng(2)
    x0, x1, R, t, pts = two_view(rng, n=64)
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P1 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    Xj = np.asarray(jtri.triangulate_linear(jnp.asarray(P0), jnp.asarray(P1), jnp.asarray(x0), jnp.asarray(x1)))
    Xt = ttri.triangulate_linear(_t(P0), _t(P1), _t(x0), _t(x1)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(Xt, pts, rtol=1e-3, atol=2e-3)
    zj = np.asarray(jtri.depths_in_camera(jnp.asarray(P1), jnp.asarray(Xj)))
    np.testing.assert_allclose(ttri.depths_in_camera(_t(P1), _t(Xj)).numpy(), zj, rtol=1e-6, atol=1e-5)
    # batched over pairs
    Xb = ttri.triangulate_linear(_t(np.stack([P0, P0])), _t(np.stack([P1, P1])), _t(np.stack([x0, x0])),
                                 _t(np.stack([x1, x1])))
    np.testing.assert_allclose(Xb[1].numpy(), Xt, rtol=1e-6, atol=1e-6)


def test_eight_point_ransac_same_winner_and_inliers(scenes):
    s = scenes["outliers"]
    x0, x1, valid = (jnp.asarray(s[k]) for k in ("x0", "x1", "valid"))
    idx_j, counts_j, Ej_all, res_j = (s["jax"][k] for k in ("idx", "counts", "Es", "ransac"))
    tx0, tx1, tvalid, tG = _t(s["x0"])[None], _t(s["x1"])[None], _t(s["valid"], torch.bool)[None], _t(s["G"])[None]
    idx_t = transac.ransac_sample_indices(tG, tvalid, 8)
    Es = tpnp.nullspace_inverse_iteration(tep.epipolar_rows(tpnp._gather(tx0, idx_t), tpnp._gather(tx1, idx_t)), 9)
    counts_t = ((tep.sampson_error(Es.reshape(1, HYP, 3, 3), tx0[:, None], tx1[:, None]) < THR * THR)
                & tvalid[:, None]).sum(-1)[0].numpy()
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    counts_j = np.asarray(counts_j)
    assert (np.abs(counts_t - counts_j) <= 1).mean() >= 0.97
    assert counts_t.argmax() == counts_j.argmax() and abs(counts_t.max() - counts_j.max()) <= 1
    # the winner's inlier sets
    win = int(counts_j.argmax())
    win_t = (tep.sampson_error(Es[0, win].reshape(3, 3), tx0[0], tx1[0]) < THR * THR) & tvalid[0]
    win_j = (jep.sampson_error(Ej_all[win], x0, x1) < THR * THR) & valid
    assert (win_t.numpy() != np.asarray(win_j)).sum() <= 1
    # after the refit on those inliers: E close; inlier sets differ only at
    # points on the threshold (the refit moves with the winner's set)
    res_t = tep.find_essential_ransac(tx0, tx1, tvalid, THR, tG)
    Ej, Et = np.asarray(res_j.E), res_t.E[0].numpy()
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < 1e-3
    inl_j = np.asarray(res_j.inliers)
    differ = res_t.inliers[0].numpy() != inl_j
    ratio = np.asarray(jep.sampson_error(res_j.E, x0, x1))[differ] / (THR * THR)
    assert differ.sum() <= 0.03 * N and (np.abs(np.log(ratio)) < 0.3).all()
    win = win_t.numpy()
    assert win[: int(0.3 * N)].mean() < 0.1 and win[int(0.3 * N):].mean() > 0.9


def test_recover_pose_matches(scenes):
    s = scenes["general"]
    E = tep.essential_from_pose(_t(s["R"]), _t(s["t"] / np.linalg.norm(s["t"])))
    E = E + 1e-3 * torch.as_tensor(np.random.default_rng(3).normal(size=(3, 3)), dtype=torch.float32)
    mask = s["valid"].copy()
    mask[: int(0.2 * N)] = False
    pj = jep.recover_pose(jnp.asarray(E.numpy()), jnp.asarray(s["x0"]), jnp.asarray(s["x1"]), jnp.asarray(mask))
    pt = tep.recover_pose(E[None], _t(s["x0"])[None], _t(s["x1"])[None], _t(mask, torch.bool)[None])
    np.testing.assert_allclose(pt.R[0].numpy(), np.asarray(pj.R), atol=1e-5)
    np.testing.assert_allclose(pt.t[0].numpy(), np.asarray(pj.t), atol=1e-5)
    assert int(pt.n_cheirality[0]) == int(pj.n_cheirality) > 0.9 * mask.sum()
    assert rot_err_deg(pt.R[0].numpy(), s["R"]) < 1.0
    assert np.dot(pt.t[0].numpy(), s["t"] / np.linalg.norm(s["t"])) > 0.99


def test_refine_pose_sampson_matches(scenes):
    s = scenes["outliers"]
    dR = Rotation.from_rotvec([0.01, -0.008, 0.005]).as_matrix()
    R0 = (dR @ s["R"]).astype(np.float32)
    t0 = s["t"] / np.linalg.norm(s["t"]) + np.array([0.03, -0.02, 0.01])
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    Rj, tj = jax_refine(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(s["x0"]), jnp.asarray(s["x1"]), jnp.asarray(s["valid"]))
    Rt, tt = tep.refine_pose_sampson(_t(R0)[None], _t(t0)[None], _t(s["x0"])[None], _t(s["x1"])[None],
                                     _t(s["valid"], torch.bool)[None], THR)
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-4)
    assert rot_err_deg(Rt[0].numpy(), s["R"]) < 0.2


@pytest.mark.parametrize("scene", ["general", "outliers"])
def test_estimate_relative_pose_matches(scenes, scene):
    s = scenes[scene]
    rj = s["jax"]["pose"]
    rt = tep.estimate_relative_pose(_t(s["x0"])[None], _t(s["x1"])[None], _t(s["valid"], torch.bool)[None], THR,
                                    _t(s["G"])[None])
    assert bool(rj.ok) and bool(rt.ok[0])
    np.testing.assert_allclose(rt.R[0].numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t[0].numpy(), np.asarray(rj.t), atol=1e-4)
    assert abs(int(rt.n_inliers[0]) - int(rj.n_inliers)) <= 1
    assert (rt.inliers[0].numpy() != np.asarray(rj.inliers)).sum() <= 1
    Ej, Et = np.asarray(rj.E), rt.E[0].numpy()
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < 1e-4
    assert rot_err_deg(rt.R[0].numpy(), s["R"]) < 0.2
    t_dir = s["t"] / np.linalg.norm(s["t"])
    assert np.degrees(np.arccos(np.clip(abs(rt.t[0].numpy() @ t_dir), -1, 1))) < 2.0


def test_estimate_relative_pose_batches_pairs(scenes):
    """Two pairs in one call give each pair's lone result."""
    a, b = scenes["general"], scenes["outliers"]
    stack = lambda k, dt=torch.float32: _t(np.stack([a[k], b[k]]), dt)  # noqa: E731
    both = tep.estimate_relative_pose(stack("x0"), stack("x1"), stack("valid", torch.bool), THR,
                                      stack("G"))
    for i, s in enumerate((a, b)):
        one = tep.estimate_relative_pose(_t(s["x0"])[None], _t(s["x1"])[None], _t(s["valid"], torch.bool)[None],
                                         THR, _t(s["G"])[None])
        torch.testing.assert_close(both.R[i], one.R[0], rtol=0, atol=1e-6)
        assert torch.equal(both.inliers[i], one.inliers[0])


# scenes (seeds of two_view, 30% outliers) on which the JAX polish returns -t
JAX_POLISH_FLIPS = (5, 23, 34)


@pytest.mark.parametrize("seed", JAX_POLISH_FLIPS + (1,))
def test_polish_keeps_the_sign_of_t(seed):
    """The polish's six step parameters hold a gauge (a step along t only
    rescales t). The JAX polish leaves that direction to its 1e-10 damping,
    so rounding sets the step along t; on these scenes it passes -1 and
    normalising t + dt returns about -t, undoing recoverPose's cheirality
    choice, with the rotation off by up to 1.4 degrees (ROADMAP.md Queue C).
    The port pins the gauge: t stays on the truth's side, the rotation
    within 0.2 degrees of the truth, the consensus at least the JAX
    polish's; where JAX does not flip, the two agree to 1e-4."""
    rng = np.random.default_rng(100 + seed)
    x0, x1, R, t, _ = two_view(rng, noise=5e-4, outlier_frac=0.3)
    valid = np.ones(N, bool)
    R0 = (Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix() @ R).astype(np.float32)
    t0 = t / np.linalg.norm(t) + rng.normal(size=3) * 0.03
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    Rj, tj = jax_refine(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid))
    Rt, tt = tep.refine_pose_sampson(_t(R0)[None], _t(t0)[None], _t(x0)[None], _t(x1)[None],
                                     _t(valid, torch.bool)[None], THR)
    Rj, tj, Rt, tt = np.asarray(Rj), np.asarray(tj), Rt[0].numpy(), tt[0].numpy()

    def inliers(R_, t_):
        return int((tep.sampson_error(tep.essential_from_pose(_t(R_), _t(t_)), _t(x0), _t(x1)) < THR * THR).sum())

    assert (float(tj @ t0) < 0) == (seed in JAX_POLISH_FLIPS)
    assert float(tt @ (t / np.linalg.norm(t))) > 0.99
    assert rot_err_deg(Rt, R) < 0.2
    assert inliers(Rt, tt) >= inliers(Rj, tj)
    if seed not in JAX_POLISH_FLIPS:
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(tt, tj, atol=1e-4)
