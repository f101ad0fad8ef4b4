"""Nister's 5-point solver of the port against the JAX package.

Scenes of tests/test_geometry.py, cut to 200 points: a general one (noise
5e-4, 20% outliers) and a planar one (noise 2e-4), each with the Gumbel
draws of 128 RANSAC hypotheses. One JAX compile serves every comparison:
the JAX package's candidates of the RANSAC's 128 minimal samples and its
estimate_relative_pose share the candidate graph. The port solves in
float64 on a 1024-point t grid; the JAX package in float32 on a 256-point
grid. So the candidate sets differ:

- the JAX float32 solve finds no candidate at all on some samples (its
  unrolled Cholesky meets a negative pivot of the singular 9x9 matrix and
  the basis comes out NaN; 29 of the 128 general and 90 of the 128 planar
  samples) and, on planar samples, returns candidates off the essential
  manifold; the port's candidates are all essential matrices that fit the
  5 points, and it leaves no sample empty, on the RANSAC's samples or on
  128 samples of inliers alone;
- every JAX candidate that is an essential matrix (singular values equal
  and the third zero, to 1e-3 relative) is matched by a port candidate,
  up to sign, within 1e-2 in every entry of the unit-norm E, on at least
  90% of the samples (96.1% general, 94.5% planar).

Through RANSAC, recoverPose and the polish with the same draws (128
hypotheses), the final consensus counts agree within 1; on the planar scene the port's 5-point pose is within 0.3
degrees of the truth in rotation and 2 degrees in translation direction,
tests/test_geometry.py's bounds.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from forest_slam_tpu.geometry import epipolar as jep
from forest_slam_tpu.geometry import fivepoint as jfp
from forest_slam_tpu.geometry import ransac as jransac
from forest_slam_tpu_torch.geometry import epipolar as tep
from forest_slam_tpu_torch.geometry import fivepoint as tfp
from forest_slam_tpu_torch.geometry import ransac as transac
from _torch_threads import one_torch_thread  # noqa: F401

N, S, HYP, THR = 200, 128, 128, 1.0 / 640.0


def two_view(rng, planar, noise, outlier_frac=0.0):
    """tests/test_geometry.py's scenes: points at 4-12 m, or on the plane
    z = 6 + 0.3 x - 0.2 y; x1 = R x0 + t in normalised coordinates."""
    if planar:
        xy = rng.uniform([-2, -1.5], [2, 1.5], size=(N, 2))
        pts = np.concatenate([xy, (6.0 + 0.3 * xy[:, 0] - 0.2 * xy[:, 1])[:, None]], axis=1)
    else:
        pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 12], size=(N, 3))
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
    t = rng.normal(size=3) * 0.3
    x0 = pts[:, :2] / pts[:, 2:3]
    p1 = pts @ R.T + t
    x1 = p1[:, :2] / p1[:, 2:3]
    x0 = x0 + rng.normal(scale=noise, size=x0.shape)
    x1 = x1 + rng.normal(scale=noise, size=x1.shape)
    n_out = int(N * outlier_frac)
    if n_out:
        x1[:n_out] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    return x0.astype(np.float32), x1.astype(np.float32), R, t


def _jax_side(G, x0, x1):
    """The JAX package's 5-point candidates of the RANSAC's minimal samples
    and its estimate_relative_pose, with jax.random.gumbel handing out G:
    one compile, the candidate graph shared by both."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: G.reshape(shape))
        valid = jnp.ones((N,), bool)
        idx = jransac.ransac_sample_indices(jax.random.PRNGKey(0), valid, HYP, 5)
        cands = jax.vmap(jfp.five_point_candidates)(x0[idx], x1[idx])
        return idx, cands, jep.estimate_relative_pose(x0, x1, valid, jax.random.PRNGKey(0), THR, HYP, minimal="5pt")


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(0)
    run = jax.jit(_jax_side)
    out = {}
    for name, planar, noise, frac in (("general", False, 5e-4, 0.2), ("planar", True, 2e-4, 0.0)):
        x0, x1, R, t = two_view(rng, planar, noise, frac)
        clean = np.stack([rng.choice(np.arange(int(N * frac), N), 5, replace=False) for _ in range(S)])
        G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, N)))).astype(np.float32)
        idx, cands, pose = run(*(jnp.asarray(v) for v in (G, x0, x1)))
        out[name] = dict(x0=x0, x1=x1, R=R, t=t, G=G, clean_samples=clean, samples=np.asarray(idx),
                         jax_candidates=tuple(np.asarray(v) for v in cands), jax_pose=pose)
    return out


def _essential(E, tol):
    """(..., 3, 3) -> singular values equal and the third zero, to ``tol``
    relative."""
    s = np.linalg.svd(E.astype(np.float64), compute_uv=False)
    return (np.abs(s[..., 0] - s[..., 1]) < tol * s[..., 0]) & (s[..., 2] < tol * s[..., 0])


def _port_candidates(s, samples):
    """The port's candidates of minimal samples (S, 5): each one an
    essential matrix through its 5 points."""
    a, b = s["x0"][samples], s["x1"][samples]
    tE, tok = tfp.five_point_candidates(torch.as_tensor(a), torch.as_tensor(b))
    tE, tok = tE.numpy(), tok.numpy()
    assert tE.dtype == np.float32 and tE.shape == (S, 10, 3, 3) and tok.shape == (S, 10)
    assert _essential(tE[tok], 1e-5).all()
    ah = np.concatenate([a, np.ones((S, 5, 1), np.float32)], -1).astype(np.float64)
    bh = np.concatenate([b, np.ones((S, 5, 1), np.float32)], -1).astype(np.float64)
    epi = np.abs(np.einsum("sni,srij,snj->srn", bh, tE.astype(np.float64), ah)).max(-1)
    assert epi[tok].max() < 1e-5
    return tE, tok


@pytest.mark.parametrize("scene", ["general", "planar"])
def test_candidates_match_jax(scenes, scene):
    """On samples of inliers alone the port leaves no sample without a
    candidate. On RANSAC's samples (the same on both sides), it leaves no
    more samples empty than the JAX package, and matches its candidates."""
    s = scenes[scene]
    _, tok = _port_candidates(s, s["clean_samples"])
    assert tok.any(1).all()
    idx_t = transac.ransac_sample_indices(torch.as_tensor(s["G"]), torch.ones(N, dtype=torch.bool), 5).numpy()
    np.testing.assert_array_equal(idx_t, s["samples"])
    tE, tok = _port_candidates(s, s["samples"])
    jE, jok = s["jax_candidates"]
    assert (~tok.any(1)).sum() <= (~jok.any(1)).sum()
    # every essential JAX candidate matched, up to sign and order
    j_ess = jok & _essential(np.nan_to_num(jE), 1e-3)
    matched = []
    for i in range(S):
        cands = tE[i][tok[i]]
        ok = True
        for r in np.where(j_ess[i])[0]:
            d = np.minimum(np.abs(cands - jE[i, r]).max((-2, -1)), np.abs(cands + jE[i, r]).max((-2, -1)))
            ok &= bool(len(d)) and d.min() < 1e-2
        matched.append(ok)
    print(f"{scene}: JAX essential candidates {j_ess.sum()}, port candidates {tok.sum()}, samples matched "
          f"{np.mean(matched):.3f}, empty samples JAX {(~jok.any(1)).sum()} port {(~tok.any(1)).sum()}")
    assert np.mean(matched) >= 0.9, np.mean(matched)
    assert j_ess.sum() > S // 2, j_ess.sum()  # the comparison is not vacuous


def test_building_blocks_match_jax(scenes):
    """The constraint matrix of one basis, the degree-10 determinant and its
    roots are the same computations as the JAX package's (float32 here)."""
    rng = np.random.default_rng(1)
    basis = rng.normal(size=(4, 3, 3)).astype(np.float32)
    Bx, By = rng.normal(size=(2, 3, 4)).astype(np.float32)
    Bc = rng.normal(size=(3, 5)).astype(np.float32)

    @jax.jit
    def jax_blocks(basis, Bx, By, Bc):
        d = jfp._det_b_poly(Bx, By, Bc)
        return jfp._constraint_matrix(basis), d, jfp._real_roots_deg10(d)

    Cj, dj, (rj, vj) = jax.tree.map(np.asarray, jax_blocks(*(jnp.asarray(v) for v in (basis, Bx, By, Bc))))
    Ct = tfp.constraint_matrix(torch.as_tensor(basis)).numpy()
    np.testing.assert_allclose(Ct, Cj, rtol=1e-5, atol=1e-5 * np.abs(Cj).max())
    dt = tfp.det_b_poly(*(torch.as_tensor(v) for v in (Bx, By, Bc))).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5 * np.abs(dj).max())
    rt, vt = tfp.real_roots_deg10(torch.as_tensor(dj.astype(np.float64)))
    true = np.sort(np.roots(dj[::-1].astype(np.float64)))
    true = np.sort(true[np.abs(true.imag) < 1e-9].real)
    np.testing.assert_allclose(np.sort(rt.numpy()[vt.numpy()]), true, rtol=1e-5)
    np.testing.assert_allclose(np.sort(rj[vj]), true, rtol=1e-3)


def test_ransac_counts_and_planar_pose(scenes):
    for name in ("general", "planar"):
        s = scenes[name]
        pj = s["jax_pose"]
        x0, x1 = torch.as_tensor(s["x0"])[None], torch.as_tensor(s["x1"])[None]
        pose = tep.estimate_relative_pose(x0, x1, torch.ones((1, N), dtype=torch.bool), THR,
                                          torch.as_tensor(s["G"])[None], minimal="5pt")
        assert bool(pose.ok[0]) and bool(pj.ok)
        assert abs(int(pose.n_inliers[0]) - int(pj.n_inliers)) <= 1, (name, int(pose.n_inliers[0]), int(pj.n_inliers))
        rot = np.degrees(np.linalg.norm(Rotation.from_matrix(pose.R[0].double().numpy().T @ s["R"]).as_rotvec()))
        t_dir = s["t"] / np.linalg.norm(s["t"])
        t_err = np.degrees(np.arccos(np.clip(abs(pose.t[0].double().numpy() @ t_dir), -1, 1)))
        assert rot < (0.3 if name == "planar" else 0.2) and t_err < 2.0, (name, rot, t_err)
