"""Lie and camera functions of the port against the JAX package in float64.

Same numpy inputs on both sides; JAX runs with 64-bit enabled inside each
test. Tolerance 1e-12 absolute: the formulas are the same, so only float64
rounding of differently ordered sums may differ. ``remap_bilinear`` runs in
float32 on both sides (its image is cast to float32): 1e-4 on 0-255
values, samples outside the image 0 on both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
def enable_x64():
    return jax.enable_x64(True)

from forest_slam_tpu.core import camera as jcam
from forest_slam_tpu.core import lie as jlie
from forest_slam_tpu_torch.core import camera as tcam
from forest_slam_tpu_torch.core import lie as tlie

TOL = 1e-12


def _poses(rng, n):
    xi = rng.normal(size=(n, 6)) * np.array([1, 1, 1, 0.5, 0.5, 0.5])
    with enable_x64():
        return np.asarray(jlie.se3_exp(jnp.asarray(xi))), xi


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def test_se3_exp_matrix_inverse_compose(rng):
    T, xi = _poses(rng, 8)
    with enable_x64():
        np.testing.assert_allclose(tlie.se3_exp(_t(xi)).numpy(), T, atol=TOL)
        R, t = T[:, :3, :3], T[:, :3, 3]
        np.testing.assert_allclose(tlie.se3_matrix(_t(R), _t(t)).numpy(),
                                   np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t))), atol=TOL)
        np.testing.assert_allclose(tlie.se3_inverse(_t(T)).numpy(),
                                   np.asarray(jlie.se3_inverse(jnp.asarray(T))), atol=TOL)
        np.testing.assert_allclose(tlie.se3_compose(_t(T[:4]), _t(T[4:])).numpy(),
                                   np.asarray(jlie.se3_compose(jnp.asarray(T[:4]), jnp.asarray(T[4:]))), atol=TOL)


def test_se3_exp_small_angle_branch():
    xi = np.array([[0.1, -0.2, 0.3, 1e-6, -2e-6, 3e-6], [0.0] * 6])
    with enable_x64():
        np.testing.assert_allclose(tlie.se3_exp(_t(xi)).numpy(), np.asarray(jlie.se3_exp(jnp.asarray(xi))), atol=TOL)


def test_se3_chain_prefix_product(rng):
    T, _ = _poses(rng, 7)
    init = T[0]
    with enable_x64():
        ref = np.asarray(jlie.se3_chain(jnp.asarray(T[1:]), initial=jnp.asarray(init)))
        np.testing.assert_allclose(tlie.se3_chain(_t(T[1:]), initial=_t(init)).numpy(), ref, atol=1e-11)
        ref0 = np.asarray(jlie.se3_chain(jnp.asarray(T)))
        np.testing.assert_allclose(tlie.se3_chain(_t(T)).numpy(), ref0, atol=1e-11)


def test_so3_orthonormalize(rng):
    T, _ = _poses(rng, 5)
    R = T[:, :3, :3] + rng.normal(size=(5, 3, 3)) * 1e-2
    with enable_x64():
        np.testing.assert_allclose(tlie.so3_orthonormalize(_t(R)).numpy(),
                                   np.asarray(jlie.so3_orthonormalize(jnp.asarray(R))), atol=TOL)


def _cams(dist):
    K = np.array([[640.0, 0, 479.5], [0, 645.0, 299.5], [0, 0, 1]])
    with enable_x64():
        jc = jcam.PinholeCamera(K=jnp.asarray(K), dist=jnp.asarray(dist), width=960, height=600)
    tc = tcam.PinholeCamera(K=_t(K), dist=_t(dist), width=960, height=600)
    return jc, tc


@pytest.mark.parametrize("dist", [[0.0] * 5, [-0.05, 0.01, 1e-3, -2e-3, 1e-4]])
def test_project_undistort_backproject(rng, dist):
    jc, tc = _cams(np.asarray(dist))
    pts = np.column_stack([rng.uniform(-3, 3, 50), rng.uniform(-2, 2, 50), rng.uniform(2, 30, 50)])
    with enable_x64():
        ref = np.asarray(jcam.project_points(jnp.asarray(pts), jc))
        got = tcam.project_points(_t(pts), tc).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-9)
        np.testing.assert_allclose(tcam.undistort_points(_t(ref), tc).numpy(),
                                   np.asarray(jcam.undistort_points(jnp.asarray(ref), jc)), atol=TOL)
        z = pts[:, 2]
        np.testing.assert_allclose(tcam.backproject_depth(_t(ref), _t(z), tc).numpy(),
                                   np.asarray(jcam.backproject_depth(jnp.asarray(ref), jnp.asarray(z), jc)), atol=1e-9)


def test_stereo_rig_baseline():
    T = np.eye(4)
    T[0, 3] = 0.25
    _, tc = _cams(np.zeros(5))
    rig = tcam.StereoRig(tc, tc, _t(T))
    assert float(rig.baseline) == 0.25


@pytest.mark.parametrize("scale", [1.0, 1e-5, 0.0])
def test_so3_exp(rng, scale):
    w = rng.normal(size=(16, 3)) * scale  # scale 1e-5 and 0 take the Taylor branch
    with enable_x64():
        ref = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(tlie.so3_exp(_t(w)).numpy(), ref, atol=TOL)


def test_remap_bilinear(rng):
    img = rng.uniform(0, 255, size=(20, 30)).astype(np.float32)
    src = rng.uniform([-3, -3], [33, 23], size=(12, 17, 2)).astype(np.float32)  # some samples outside
    src[0, :4] = [[0, 0], [29, 19], [29.5, 10], [-0.5, 5]]  # corners and half-outside edges
    ref = np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(src)))
    got = tcam.remap_bilinear(torch.as_tensor(img), torch.as_tensor(src)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (ref == 0).any()
    # batched: each image with its own map, and one map broadcast over images
    imgs = np.stack([img, img[::-1].copy()])
    maps = np.stack([src, src[::-1].copy()])
    ref2 = np.asarray(jcam.remap_bilinear(jnp.asarray(imgs[1]), jnp.asarray(maps[1])))
    np.testing.assert_allclose(tcam.remap_bilinear(torch.as_tensor(imgs), torch.as_tensor(maps))[1].numpy(), ref2,
                               atol=1e-4)
    np.testing.assert_allclose(tcam.remap_bilinear(torch.as_tensor(imgs), torch.as_tensor(src))[0].numpy(), ref,
                               atol=1e-4)


def _rotations(rng, n, angles):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    w = axes * np.asarray(angles, np.float64).reshape(-1, 1)
    with enable_x64():
        return np.asarray(jlie.so3_exp(jnp.asarray(w))), w


def test_quaternions(rng):
    q = rng.normal(size=(12, 4))
    q[0] = [0, 0, 0, 1]
    q[1] = [0, 0, 0, -3]
    R, _ = _rotations(rng, 8, rng.uniform(0, np.pi, 8))
    # half turns: the pivot is a diagonal entry (ties between two of them)
    R = np.concatenate([R, np.diag([1.0, -1, -1])[None], np.diag([-1.0, 1, -1])[None], np.diag([-1.0, -1, 1])[None]])
    with enable_x64():
        for name in ("quat_normalize", "quat_to_matrix"):
            np.testing.assert_allclose(getattr(tlie, name)(_t(q)).numpy(),
                                       np.asarray(getattr(jlie, name)(jnp.asarray(q))), atol=TOL)
        np.testing.assert_allclose(tlie.quat_multiply(_t(q[:6]), _t(q[6:])).numpy(),
                                   np.asarray(jlie.quat_multiply(jnp.asarray(q[:6]), jnp.asarray(q[6:]))), atol=TOL)
        ref = np.asarray(jlie.quat_from_matrix(jnp.asarray(R)))
        got = tlie.quat_from_matrix(_t(R)).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL)
        T = np.tile(np.eye(4), (len(R), 1, 1))
        T[:, :3, :3] = R
        np.testing.assert_allclose(tlie.quat_from_matrix(_t(T)).numpy(), ref, atol=TOL)
    assert (got[:, 3] >= 0).all()
    np.testing.assert_allclose(tlie.quat_to_matrix(_t(got)).numpy(), R, atol=1e-12)


def test_se3_orthonormalize_and_transform_points(rng):
    T, _ = _poses(rng, 5)
    Tn = T + rng.normal(size=T.shape) * 1e-2
    pts = rng.normal(size=(5, 7, 3))
    with enable_x64():
        np.testing.assert_allclose(tlie.se3_orthonormalize(_t(Tn)).numpy(),
                                   np.asarray(jlie.se3_orthonormalize(jnp.asarray(Tn))), atol=TOL)
        np.testing.assert_allclose(tlie.se3_transform_points(_t(T), _t(pts)).numpy(),
                                   np.asarray(jlie.se3_transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=TOL)


# angles across so3_log's branches: general, the small-angle series (below
# about 1.4e-3), zero, and the near-pi axis recovery (above pi - 1e-3)
LOG_ANGLES = {"general": (0.3, 1.0, 2.0, 3.0), "small": (1e-7, 1e-5, 1e-4, 1.3e-3), "zero": (0.0,) * 4,
              "near_pi": (np.pi - 1e-4, np.pi - 5e-4, np.pi - 9e-4, np.pi - 2e-5)}


@pytest.mark.parametrize("branch", list(LOG_ANGLES))
def test_so3_log_se3_log(rng, branch):
    R, w = _rotations(rng, 4, LOG_ANGLES[branch])
    T = np.array(_poses(rng, 4)[0])
    T[:, :3, :3] = R
    with enable_x64():
        ref = np.asarray(jlie.so3_log(jnp.asarray(R)))
        np.testing.assert_allclose(tlie.so3_log(_t(R)).numpy(), ref, atol=TOL)
        np.testing.assert_allclose(tlie.se3_log(_t(T)).numpy(), np.asarray(jlie.se3_log(jnp.asarray(T))), atol=1e-11)
    if branch != "near_pi":  # near pi the reference's axis is accurate to about sqrt(eps)
        np.testing.assert_allclose(ref, w, atol=1e-9)


def test_so3_log_float32_branch_tests_and_gradients(rng):
    """In float32 the branch tests decide alike (cos theta > 1 - 1e-6 is
    compared in float32 on both sides); values to 2e-6. Gradients of
    so3_log (what the back end differentiates) equal jax.jacfwd's in
    float64 at the identity, in the small-angle series, at a general angle
    and near pi: finite everywhere, to 1e-9."""
    angles = (0.0, 5e-4, 1.2e-3, 1.6e-3, 0.5, np.pi - 5e-4, np.pi - 2e-3)
    R, _ = _rotations(rng, len(angles), angles)
    R32 = R.astype(np.float32)
    np.testing.assert_allclose(tlie.so3_log(torch.as_tensor(R32)).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R32))), atol=2e-6)
    with enable_x64():
        jac = jax.jit(jax.jacfwd(jlie.so3_log))
        for Ri in R:
            ref = np.asarray(jac(jnp.asarray(Ri)))
            got = torch.autograd.functional.jacobian(tlie.so3_log, _t(Ri)).numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, ref, atol=1e-9)
