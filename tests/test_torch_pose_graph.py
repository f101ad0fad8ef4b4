"""The port's pose graph (backend/pose_graph.py) against the JAX package's.

A seeded random graph of 12 poses on a drifting walk: 11 odometry edges
measured with noise and 4 loop edges, one of them disabled (weight 0), and
one edge whose measurement equals the poses' relative motion exactly (its
residual is the log of the identity, the small-angle branch of so3_log).
Held:

- each edge's residual and 6x6 Jacobian blocks at zero update, the port's
  ``torch.func.jacfwd`` (forward mode through se3_exp, se3_log and so3_log
  at xi = 0) against ``jax.jacfwd``: residuals to 1e-5 (reading 1.7e-6),
  blocks to 1e-4 (reading 6.4e-5; each side is up to 8e-5 from the same
  blocks in float64, so the bound is float32's own error), all finite,
  and the exact edge's residual below 1e-5;
- ten Gauss-Newton steps: the port solves in float64 (see
  backend/pose_graph.py); against the JAX solver in float32 the refined
  poses to 2e-4 and the costs to 1e-4 relative, against it in float64
  (``enable_x64``) to 1e-9 and 1e-9 relative; node 0 exactly where it was;
- a graph whose residual rotations end near 2e-4 rad: the JAX package's
  float32 ``se3_log`` returns NaN there (1 - cos theta rounds to 0), so its
  final cost is NaN and its steps are dropped; the port's cost falls below
  1e-6 of the start and its poses end within 3e-4 of the truth (ROADMAP
  Queue C);
- a graph whose step goes non-finite leaves the poses unchanged, as the JAX
  solver does;
- ``odometry_edges`` equal to the JAX function's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import pose_graph as jpg
from forest_slam_tpu_torch.backend import pose_graph as tpg
from forest_slam_tpu_torch.core.lie import se3_exp

N = 12


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    steps = np.concatenate([rng.normal(0, 0.02, (N - 1, 3)) + [0, 0, 0.5], rng.normal(0, 0.05, (N - 1, 3))], 1)
    T = [np.eye(4)]
    for xi in steps:
        T.append(T[-1] @ se3_exp(torch.as_tensor(xi)).numpy())
    truth = np.stack(T)
    ei = list(range(N - 1)) + [0, 2, 3, 5]
    ej = list(range(1, N)) + [9, 11, 10, 7]
    Z = []
    for e, (i, j) in enumerate(zip(ei, ej)):
        rel = np.linalg.inv(truth[i]) @ truth[j]
        Z.append(rel @ se3_exp(torch.as_tensor(rng.normal(0, 0.01, 6))).numpy())
    w = np.ones(len(ei), np.float32)
    w[N - 1:] = 3.0
    w[-1] = 0.0
    drift = truth @ se3_exp(torch.as_tensor(rng.normal(0, 0.03, (N, 6)))).numpy()
    drift[0] = truth[0]
    Z[4] = np.linalg.inv(drift[ei[4]]) @ drift[ej[4]]  # edge 4 agrees with the initial poses exactly
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(drift), np.asarray(ei, np.int32), np.asarray(ej, np.int32), f32(np.stack(Z)), w


@pytest.fixture(scope="module")
def graph():
    return _graph()


def test_edge_jacobians_match_jacfwd(graph):
    poses, ei, ej, Z, _ = graph
    Zinv = np.linalg.inv(Z).astype(np.float32)
    zero = jnp.zeros(6)

    def one(Ti, Tj, Zi):
        f = lambda a, b: jpg._edge_error(a, b, Ti, Tj, Zi)
        return f(zero, zero), jax.jacfwd(f, argnums=0)(zero, zero), jax.jacfwd(f, argnums=1)(zero, zero)

    jr, jJi, jJj = jax.jit(jax.vmap(one))(poses[ei], poses[ej], Zinv)
    tr, tJi, tJj = tpg.edge_jacobians(*(torch.as_tensor(a) for a in (poses[ei], poses[ej], Zinv)))
    assert torch.isfinite(tJi).all() and torch.isfinite(tJj).all()
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(jJi), atol=1e-4)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(jJj), atol=1e-4)
    assert np.abs(tr[4].numpy()).max() < 1e-5  # so3_log's small-angle branch


def test_optimize_matches_jax(graph):
    poses, ei, ej, Z, w = graph
    jres = jax.jit(jpg.optimize_pose_graph)(jpg.PoseGraph(*(jnp.asarray(a) for a in (poses, ei, ej, Z, w))))
    tres = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.as_tensor(a) for a in (poses, ei, ej, Z, w))))
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses), atol=2e-4)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(tres.final_cost), float(jres.final_cost), rtol=1e-4, atol=1e-6)
    assert float(tres.final_cost) < 0.2 * float(tres.initial_cost)
    np.testing.assert_array_equal(tres.poses[0].numpy(), poses[0])


def test_optimize_matches_jax_in_float64(graph):
    poses, ei, ej, Z, w = graph
    with jax.enable_x64(True):
        jres = jpg.optimize_pose_graph(jpg.PoseGraph(*(jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
                                                       for a in (poses, ei, ej, Z, w))))
        jp, jc0, jc1 = (np.asarray(x) for x in jres)
    tres = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.as_tensor(a).double() if a.dtype == np.float32
                                                   else torch.as_tensor(a) for a in (poses, ei, ej, Z, w))))
    np.testing.assert_allclose(tres.poses.numpy(), jp, atol=1e-9)
    np.testing.assert_allclose([float(tres.initial_cost), float(tres.final_cost)], [jc0, jc1], rtol=1e-9)


def test_float32_log_band_port_converges():
    n = 8
    step = se3_exp(torch.tensor([0.0, 0.0, 0.5, 0.0, 0.05, 0.0], dtype=torch.float64))
    truth = torch.stack([torch.linalg.matrix_power(step, k) for k in range(n)])
    ei, ej = list(range(n - 1)) + [0, 2], list(range(1, n)) + [n - 1, 6]
    Z = torch.stack([torch.linalg.inv(truth[i]) @ truth[j] for i, j in zip(ei, ej)])
    Z[-1] = Z[-1] @ se3_exp(torch.tensor([0, 0, 0, 0, 2e-4, 0], dtype=torch.float64))
    w = np.ones(len(ei), np.float32)
    w[n - 1:] = 3.0
    drift = truth @ se3_exp(torch.as_tensor(np.random.default_rng(5).normal(0, 0.02, (n, 6))))
    drift[0] = truth[0]
    args = (drift.float().numpy(), np.asarray(ei, np.int32), np.asarray(ej, np.int32), Z.float().numpy(), w)
    jres = jpg.optimize_pose_graph(jpg.PoseGraph(*(jnp.asarray(a) for a in args)))
    tres = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.as_tensor(a) for a in args)))
    assert np.isnan(float(jres.final_cost))
    assert float(tres.final_cost) < 1e-6 * float(tres.initial_cost)
    assert (tres.poses.double() - truth).abs().max() < 3e-4


def test_non_finite_step_keeps_poses(graph):
    poses, ei, ej, Z, w = graph
    bad = Z.copy()
    bad[2, 0, 3] = np.nan
    args = (poses, ei, ej, bad, w)
    jres = jpg.optimize_pose_graph(jpg.PoseGraph(*(jnp.asarray(a) for a in args)), iters=1)
    tres = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.as_tensor(a) for a in args)), iters=1)
    np.testing.assert_array_equal(np.asarray(jres.poses), poses)
    np.testing.assert_array_equal(tres.poses.numpy(), poses)


def test_odometry_edges_match(graph):
    poses = graph[0]
    j = jpg.odometry_edges(jnp.asarray(poses), weight=2.0)
    t = tpg.odometry_edges(torch.as_tensor(poses), weight=2.0)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert t[0].dtype == torch.int32 and t[3].dtype == torch.float32
