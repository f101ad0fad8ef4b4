"""The port's bundle adjustment (backend/ba.py) against the JAX package's.

A seeded problem: 4 poses stepping 0.3 m forward with small turns, 60
landmarks 3-20 m ahead seen by every pose (2 observations in 10 masked
out), pixel noise 0.3 px and 5 mismatches of 15 px; the initial poses and
points perturbed (0.02 rad/m, 0.05 m); the camera with Brown-Conrady
distortion; stereo depths with 1% noise where measured. Held:

- the analytic Jacobian blocks at zero update (3x6 in the pose's left
  twist, 3x3 in the point, pixel and depth rows) against ``jax.jacfwd`` of
  the JAX ``_residual_one``: to 1e-5 of each block's largest entry
  (reading 3.5e-7; entries reach 1.4e3 px per unit), residuals to 1e-3 px
  (reading 6.1e-5);
- ``ba_solve`` (6 iterations) with depths; with depths, a pose prior and
  Huber; pixel-only with a prior and Huber; and without the gauge, with
  depths and a prior: poses to 1e-4 and points to 2e-3 (readings 4.1e-6
  and 7.0e-4, the latter a far landmark of the pixel-only problem), final
  costs to 1e-5 relative (reading 7.0e-7), initial costs to 1e-6, and each
  cost lower than the start. Each configuration is well posed: pixel-only
  BA with one pose fixed leaves the scale free and no gauge leaves the whole
  frame free, and there the float32 solves of both packages land up to
  0.07 m from a float64 solve and from each other, so those two take a
  prior of weight 10 that pins them;
- a batch of two problems gives each problem's own solve.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import ba as jba
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu_torch.backend import ba as tba
from forest_slam_tpu_torch.core.camera import PinholeCamera, project_points
from forest_slam_tpu_torch.core.lie import se3_exp

KMAT = np.array([[320.0, 0, 159.5], [0, 320.0, 119.5], [0, 0, 1]], np.float32)
DIST = np.array([-0.03, 0.01, 5e-4, -5e-4, 0.0], np.float32)
M, P = 4, 60


def _cams():
    return (JCam(K=jnp.asarray(KMAT), dist=jnp.asarray(DIST), width=320, height=240),
            PinholeCamera(K=torch.as_tensor(KMAT), dist=torch.as_tensor(DIST), width=320, height=240))


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.uniform(-4, 4, P), rng.uniform(-2, 2, P), rng.uniform(3, 20, P)])
    T_cw = []
    for m in range(M):
        xi = np.array([0.0, 0.0, -0.3 * m, 0.0, 0.01 * m, 0.0])
        T_cw.append(se3_exp(torch.as_tensor(xi)).numpy())
    T_cw = np.stack(T_cw)
    pc = np.einsum("mij,pj->mpi", T_cw[:, :3, :3], X) + T_cw[:, None, :3, 3]
    _, tc = _cams()
    uv = project_points(torch.as_tensor(pc), tc._replace(K=tc.K.double(), dist=tc.dist.double())).numpy()
    uv = uv + rng.normal(0, 0.3, uv.shape)
    bad = rng.choice(M * P, 5, replace=False)
    uv.reshape(-1, 2)[bad] += 15.0
    mask = np.ones((M, P), bool)
    mask.reshape(-1)[rng.choice(M * P, 10, replace=False)] = False
    depths = pc[..., 2] * (1 + rng.normal(0, 0.01, (M, P)))
    depth_mask = rng.random((M, P)) > 0.2
    T0 = T_cw @ se3_exp(torch.as_tensor(np.concatenate([rng.normal(0, 0.05, (M, 3)), rng.normal(0, 0.02, (M, 3))], 1))).numpy()
    T0[0] = T_cw[0]
    X0 = X + rng.normal(0, 0.05, X.shape)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(poses=f32(T0), points=f32(X0), observations=f32(uv), mask=mask, depths=f32(depths),
                depth_mask=depth_mask)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def test_jacobian_blocks_match_jacfwd(problem):
    jc, tc = _cams()
    T, X, obs, z, hz = (problem["poses"], problem["points"], problem["observations"], problem["depths"],
                        problem["depth_mask"].astype(np.float32))

    def per_obs(T, X, ob, zm, h):
        f = lambda xi, dX: jba._residual_one(xi, dX, T, X, ob, zm, h, 25.0, jc)
        z6, z3 = jnp.zeros(6), jnp.zeros(3)
        return f(z6, z3), jax.jacfwd(f, argnums=0)(z6, z3), jax.jacfwd(f, argnums=1)(z6, z3)

    blocks = jax.jit(jax.vmap(jax.vmap(per_obs, in_axes=(None, 0, 0, 0, 0)), in_axes=(0, None, 0, 0, 0)))
    jr, jJp, jJx = (np.asarray(a) for a in blocks(T, X, obs, z, hz))
    tr, tJp, tJx = tba.residual_blocks(*(torch.as_tensor(a)[None] for a in (T, X, obs, z, hz)), 25.0, tc)
    np.testing.assert_allclose(tr[0].numpy(), jr, atol=1e-3)
    for t, j in ((tJp[0].numpy(), jJp), (tJx[0].numpy(), jJx)):
        scale = np.abs(j).max((-2, -1), keepdims=True)
        assert (np.abs(t - j) / scale).max() < 1e-5, (np.abs(t - j) / scale).max()


CONFIGS = {
    "depths": dict(depths=True),
    "prior_huber": dict(depths=True, pose_prior_weight=2.0, huber_px=1.0),
    "pixel_prior_huber": dict(depths=False, pose_prior_weight=10.0, huber_px=1.0),
    "no_gauge_prior": dict(depths=True, pose_prior_weight=10.0, fix_first=False),
}


def _solve_both(problem, depths=True, pose_prior_weight=0.0, huber_px=0.0, fix_first=True):
    jc, tc = _cams()
    kw = dict(pose_prior_weight=pose_prior_weight, huber_px=huber_px)
    names = ("poses", "points", "observations", "mask") + (("depths", "depth_mask") if depths else ())
    jp = jba.BAProblem(cam=jc, **{k: jnp.asarray(problem[k]) for k in names}, **kw)
    tp = tba.BAProblem(cam=tc, **{k: torch.as_tensor(problem[k]) for k in names}, **kw)
    jres = jax.jit(lambda p: jba.ba_solve(p, iters=6, fix_first=fix_first))(jp)
    return jres, tba.ba_solve(tp, iters=6, fix_first=fix_first), tp


@pytest.mark.parametrize("config", list(CONFIGS))
def test_ba_solve_matches_jax(problem, config):
    jres, tres, _ = _solve_both(problem, **CONFIGS[config])
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-6)
    np.testing.assert_allclose(float(tres.final_cost), float(jres.final_cost), rtol=1e-5)
    assert float(tres.final_cost) < float(tres.initial_cost)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses), atol=1e-4)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), atol=2e-3)
    if CONFIGS[config].get("fix_first", True):
        np.testing.assert_allclose(tres.poses[0].numpy(), problem["poses"][0], atol=1e-6)


def test_batch_solves_each_problem(problem):
    other = _problem(seed=1)
    _, tc = _cams()
    names = ("poses", "points", "observations", "mask", "depths", "depth_mask")
    batch = tba.BAProblem(cam=tc, huber_px=1.0,
                          **{k: torch.stack([torch.as_tensor(problem[k]), torch.as_tensor(other[k])]) for k in names})
    res = tba.ba_solve(batch, iters=6)
    for b, prob in enumerate((problem, other)):
        one = tba.ba_solve(tba.BAProblem(cam=tc, huber_px=1.0, **{k: torch.as_tensor(prob[k]) for k in names}), iters=6)
        np.testing.assert_allclose(res.poses[b].numpy(), one.poses.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(res.final_cost[b]), float(one.final_cost), rtol=1e-6)
