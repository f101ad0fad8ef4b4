"""The port's dense stereo (stereo/disparity.py, depth.py, rectify.py, the
undistortion and gray conversion of core/camera.py, and the runner's
``dense_depth`` route) against the JAX package on the same inputs.

Tolerances:
- SGM on integer-valued images: every cost up to the winner-take-all is a
  multiple of 0.25 below 2^22, so sums are exact in any order: the integer
  disparity equal on every pixel, the parabola offsets and the validity
  equal (held to 1e-6); on a rendered (float) pair the same, within 1e-5
  (measured bit-equal), and the map as accurate as the JAX package's own
  test asks (tests/test_stereo_disparity.py);
- depth, keypoint lookup and back-projection: 1e-6 relative;
- undistortion maps within 1e-4 px, remapped images within 1e-3 gray
  levels, gray conversion within 1e-4;
- rectification: rotations within 1e-9 (the same float64 host arithmetic),
  maps within 1e-4 px, rectified images within 1e-3;
- the runner's dense route on three 224x160 frames rounded to integers (a
  camera's 8-bit frames): keypoints equal, dense depths equal (exact SGM),
  all marked valid; given the same matches and RANSAC draws, PnP validity
  equal and relative poses within 1e-3, the chain within 2e-3, as
  tests/test_torch_pipeline.py holds the sparse route; the port's whole
  runner tracks every pair of a six-frame clip within 0.05 m ATE.
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.core import camera as JC
from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import learned_frontend as jlearned_frontend
from forest_slam_tpu.frontend.learned import LearnedFrontend as JLearned
from forest_slam_tpu.frontend.learned import LearnedFrontendConfig as JLFConfig
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JSPConfig
from forest_slam_tpu.io.synthetic import make_corridor_world, render_sequence, render_view
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo import depth as JD
from forest_slam_tpu.stereo import rectify as JR
from forest_slam_tpu.stereo.disparity import SgmConfig as JSgm
from forest_slam_tpu.stereo.disparity import sgm_disparity as jsgm
from forest_slam_tpu_torch.core import camera as TC
from forest_slam_tpu_torch.frontend.base import FrontendFns, learned_frontend
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo import depth as TD
from forest_slam_tpu_torch.stereo import rectify as TR
from forest_slam_tpu_torch.stereo.disparity import SgmConfig, sgm_disparity

H, W = 160, 224


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_cam(jcam):
    return TC.PinholeCamera(K=_t(jcam.K), dist=_t(jcam.dist), width=jcam.width, height=jcam.height)


def _port_rig(jrig):
    return TC.StereoRig(_port_cam(jrig.left), _port_cam(jrig.right), _t(jrig.T_left_right))


def _shifted_pair(seed, h, w, shift):
    """Integer images: a random texture and the same texture ``shift``
    columns over, with +-3 gray levels of noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + 2 * shift)).astype(np.float32)
    right = np.clip(base[:, shift:-shift] + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.float32)
    return base[:, 2 * shift:], right


@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("uniqueness", [0.0, 10.0])
def test_sgm_integer_images_exact(subpixel, uniqueness):
    pairs = [_shifted_pair(s, 48, 64, 4 + s) for s in range(2)]
    jc = JSgm(num_disparities=16, subpixel=subpixel, uniqueness_ratio=uniqueness)
    ref = np.stack([np.asarray(jsgm(jnp.asarray(l), jnp.asarray(r), jc)) for l, r in pairs])
    got = sgm_disparity(_t([p[0] for p in pairs]), _t([p[1] for p in pairs]),
                        SgmConfig(num_disparities=16, subpixel=subpixel, uniqueness_ratio=uniqueness)).numpy()
    np.testing.assert_array_equal(np.floor(got), np.floor(ref))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert 0.4 < (ref >= 0).mean() < 1.0 and (ref != np.floor(ref)).any() == subpixel


def test_sgm_rendered_pair():
    seq = render_sequence(n_frames=1, height=H, width=W, seed=5)
    il, ir = np.array(seq.images_left[0]), np.array(seq.images_right[0])
    ref = np.asarray(jsgm(jnp.asarray(il), jnp.asarray(ir), JSgm(num_disparities=48)))
    got = sgm_disparity(_t(il)[None], _t(ir)[None], SgmConfig(num_disparities=48))[0].numpy()
    np.testing.assert_array_equal(np.floor(got), np.floor(ref))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # tests/test_stereo_disparity.py's accuracy against the rendered depth
    d_gt = float(seq.rig.left.fx) * float(seq.rig.baseline) / np.asarray(seq.depths_left[0])
    m = (got > 0) & (d_gt > 1.0) & (d_gt < 46.0)
    m[:, :52] = False
    assert m.mean() > 0.5 and np.median(np.abs(got - d_gt)[m]) < 0.5


def test_depth_functions():
    disp = np.array([[[0.0, -1.0, 2.0, 16.0], [0.5, 3.25, -1.0, 40.0]]], np.float32).repeat(2, 0)
    disp[1] *= 1.5
    fx, b = np.float32(150.08), np.float32(0.25)
    ref = np.stack([np.asarray(JD.disparity_to_depth(jnp.asarray(d), fx, b)) for d in disp])
    depth = TD.disparity_to_depth(_t(disp), torch.tensor(fx), torch.tensor(b))
    np.testing.assert_allclose(depth.numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(depth.numpy()[0, 0, :2], [fx * b / 0.1] * 2, rtol=1e-6)  # 0 and -1 clamp to 0.1
    rng = np.random.default_rng(0)
    dmap = rng.uniform(0.5, 30.0, (2, 12, 16)).astype(np.float32)
    dmap[0, 3, 5] = 2000.0
    xy = rng.uniform(-2, 18, (2, 20, 2)).astype(np.float32)
    xy[:, 0] = [5.9, 3.99]  # truncation, not rounding
    ref_z = np.stack([np.asarray(JD.depth_at_keypoints(jnp.asarray(dmap[i]), jnp.asarray(xy[i]))) for i in range(2)])
    z = TD.depth_at_keypoints(_t(dmap), _t(xy))
    np.testing.assert_array_equal(z.numpy(), ref_z)
    assert z[0, 0] == 2000.0
    K = np.array([[150.08, 0, 111.5], [0, 150.08, 79.5], [0, 0, 1]], np.float32)
    jcam = JC.PinholeCamera.create(K, None, 16, 12)
    pts, ok = TD.backproject_keypoints(_t(xy), _t(dmap), _port_cam(jcam), 1.0, 25.0)
    for i in range(2):
        rp, rok = JD.backproject_keypoints(jnp.asarray(xy[i]), jnp.asarray(dmap[i]), jcam, 1.0, 25.0)
        np.testing.assert_allclose(pts[i].numpy(), np.asarray(rp), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(rok))
    assert not ok.all() and ok.any()


def test_undistort_and_gray():
    K = np.array([[150.0, 0, 110.2], [0, 148.0, 81.3], [0, 0, 1]], np.float32)
    jcam = JC.PinholeCamera.create(K, np.array([-0.21, 0.05, 0.001, -0.0008, 0.002], np.float32), W, H)
    cam = _port_cam(jcam)
    ref_map = np.asarray(JC.undistort_map(jcam))
    got_map = TC.undistort_map(cam).numpy()
    assert got_map.shape == (H, W, 2) and np.abs(ref_map - np.mgrid[0:H, 0:W][::-1].transpose(1, 2, 0)).max() > 5
    np.testing.assert_allclose(got_map, ref_map, atol=1e-4)
    world = make_corridor_world(jax.random.PRNGKey(2))
    img = np.asarray(render_view(world, jnp.eye(4), jnp.asarray(K), H, W)[0])
    ref = np.asarray(JC.undistort_image(jnp.asarray(img), jcam))
    got = TC.undistort_image(_t(img)[None].expand(2, -1, -1), cam)
    np.testing.assert_allclose(got[1].numpy(), ref, atol=1e-3)
    bgr = np.random.default_rng(1).integers(0, 256, (H, W, 3)).astype(np.uint8)
    np.testing.assert_allclose(TC.bgr_to_gray(_t(bgr)).numpy(), np.asarray(JC.bgr_to_gray(jnp.asarray(bgr))),
                               atol=1e-4)


def _rotated_rig(baseline=0.25, yaw_deg=2.0, pitch_deg=1.0):
    """tests/test_rectify.py's rig: the right camera yawed and pitched."""
    f = 0.67 * W
    K = np.array([[f, 0, W / 2 - 0.5], [0, f, H / 2 - 0.5], [0, 0, 1]], np.float32)
    cam = JC.PinholeCamera.create(K, None, W, H)
    a, b = np.deg2rad(yaw_deg), np.deg2rad(pitch_deg)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = (Ry @ Rx).astype(np.float32)
    T[0, 3] = baseline
    return JC.StereoRig(left=cam, right=cam, T_left_right=jnp.asarray(T))


def test_rectify_rotated_rig():
    jrig = _rotated_rig()
    ref = JR.stereo_rectify(jrig)
    got = TR.stereo_rectify(_port_rig(jrig))
    np.testing.assert_allclose(got.R_left, ref.R_left, atol=1e-9)
    np.testing.assert_allclose(got.R_right, ref.R_right, atol=1e-9)
    np.testing.assert_allclose(got.map_left.numpy(), np.asarray(ref.map_left), atol=1e-4)
    np.testing.assert_allclose(got.map_right.numpy(), np.asarray(ref.map_right), atol=1e-4)
    np.testing.assert_allclose(got.rig.left.K.numpy(), np.asarray(ref.rig.left.K), atol=1e-6)
    np.testing.assert_allclose(got.rig.T_left_right.numpy(), np.asarray(ref.rig.T_left_right), atol=1e-6)
    # rectified extrinsics: identity rotation, +x baseline; R_left R_rl = R_right
    assert np.allclose(got.R_left @ np.asarray(jrig.T_left_right, np.float64)[:3, :3], got.R_right, atol=1e-6)
    world = make_corridor_world(jax.random.PRNGKey(5))
    img_l = render_view(world, jnp.eye(4), jrig.left.K, H, W)[0]
    img_r = render_view(world, jrig.T_left_right, jrig.right.K, H, W)[0]
    rl, rr = JR.rectify_images(ref, img_l[None], img_r[None])
    tl, tr = TR.rectify_images(got, np.asarray(img_l)[None], np.asarray(img_r)[None])
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(rr), atol=1e-3)


# --- the runner's dense route --------------------------------------------------

K_PTS, N_FRAMES, HYP = 128, 3, 128


def _flagship_jax(K):
    state = serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())["params"]
    params = {"superpoint": {"params": {"net": state["superpoint"]["params"]}}, "superglue": state["superglue"]}
    fe = JLearned(JLFConfig(
        superpoint=JSPConfig(stem_stride=4, max_keypoints=K, topk_method="exact", nms_backend="xla",
                             dtype=jnp.float32, desc_sample_dtype=jnp.float32),
        superglue=JSGConfig(gnn_impl="xla", sinkhorn_impl="xla"),
    ))
    return jlearned_frontend(fe), params


def _port_frontend():
    return learned_frontend(load_learned_frontend(
        FLAGSHIP_PATH, (H, W), K_PTS, device="cpu",
        superpoint_overrides={"dtype": torch.float32, "desc_sample_dtype": torch.float32}))


def _configs():
    kw = dict(n_hypotheses=HYP, compose_mode="odometry", match_refine_radius=12, dense_depth=True)
    return (jst.StereoConfig(sgm=JSgm(num_disparities=48), **kw), tst.StereoConfig(sgm=SgmConfig(num_disparities=48),
                                                                                   **kw))


@pytest.fixture(scope="module")
def dense_run():
    seq = render_sequence(n_frames=N_FRAMES, height=H, width=W, seed=11, speed=0.15)
    il, ir = (np.round(np.array(x, np.float32)) for x in (seq.images_left, seq.images_right))
    jrig, trig = seq.rig, _port_rig(seq.rig)
    jcfg, tcfg = _configs()
    jfront, params = _flagship_jax(K_PTS)
    jfeats, jz, jzok = jst._extract_chunk(jnp.asarray(il), jnp.asarray(ir), jrig, jcfg, jfront, params)
    tfeats, tz, tzok = tst.frame_features(_t(il), _t(ir), trig, tcfg, _port_frontend())

    P = N_FRAMES - 1
    sl = lambda f, a, b: type(f)(*(x[a:b] for x in f))
    match_fn = jax.jit(lambda f0, f1: jfront.match(params, f0, f1, (H, W)))
    jm = np.stack([np.asarray(match_fn(jax.tree.map(lambda a: a[i], jfeats), jax.tree.map(lambda a: a[i + 1], jfeats)))
                   for i in range(P)])
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K_PTS)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K_PTS).astype(np.float32)
    given = JFrontendFns(extract=None, match=lambda fp, f0, f1, shape: fp, name="given")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape))
    mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape))
    pair_fn = jax.jit(lambda pf, pz, pok, cf, m, a, b: jst._pair_from_slab(
        pf, pz, pok, cf, jax.random.PRNGKey(0), jrig, jcfg, given, m, (H, W), a, b))
    at = lambda tree, i: jax.tree.map(lambda a: a[i], tree)
    jpairs = [pair_fn(at(jfeats, i), jz[i], jzok[i], at(jfeats, i + 1), jnp.asarray(jm[i]), jnp.asarray(il[i]),
                      jnp.asarray(il[i + 1])) for i in range(P)]
    mp.undo()
    tgiven = FrontendFns(extract=None, match=lambda f0, f1, shape: torch.as_tensor(jm))
    tpairs = tst.pair_from_slab(sl(tfeats, 0, P), tz[:P], tzok[:P], sl(tfeats, 1, N_FRAMES), trig, tcfg, tgiven,
                                (H, W), _t(il[:P]), _t(il[1:]), gumbel=_t(G).expand(P, -1, -1),
                                uniform=_t(U).expand(P, -1))
    return dict(jfeats=jfeats, jz=jz, jzok=jzok, tfeats=tfeats, tz=tz, tzok=tzok, jpairs=jpairs, tpairs=tpairs)


def test_dense_features_and_depths_match(dense_run):
    r = dense_run
    np.testing.assert_array_equal(r["tfeats"].xy.numpy(), np.asarray(r["jfeats"].xy))
    np.testing.assert_array_equal(r["tfeats"].valid.numpy(), np.asarray(r["jfeats"].valid))
    assert r["tzok"].all() and np.asarray(r["jzok"]).all()
    np.testing.assert_allclose(r["tz"].numpy(), np.asarray(r["jz"]), rtol=1e-6)
    gated = (r["tz"] > 0.1) & (r["tz"] < 1000.0) & r["tfeats"].valid
    assert gated.sum(-1).min() > 30


def test_dense_pair_phase_matches(dense_run):
    tp = dense_run["tpairs"]
    for i, jp in enumerate(dense_run["jpairs"]):
        np.testing.assert_array_equal(tp.valid[i].numpy(), np.asarray(jp.valid))
        assert bool(jp.ok) and bool(tp.ok[i])
        np.testing.assert_allclose(tp.rel[i].numpy(), np.asarray(jp.rel), atol=1e-3)
        assert abs(int(tp.n_inliers[i]) - int(jp.n_inliers)) <= 2
    jpairs = jax.tree.map(lambda *a: jnp.stack(a), *dense_run["jpairs"])
    jchain = np.asarray(jst._chain_and_map(jpairs, jnp.eye(4), len(dense_run["jpairs"])).pose)
    np.testing.assert_allclose(tst.chain_and_map(tp, torch.eye(4)).pose.numpy(), jchain, atol=2e-3)


def test_dense_runner_tracks_a_clip(monkeypatch):
    """The port's whole batched runner with dense depth on six integer
    frames: every pair tracked, ATE within 0.05 m; sparse stereo never runs."""
    from forest_slam_tpu_torch.eval.metrics import ape_translation
    from forest_slam_tpu_torch.io.tum import Trajectory

    seq = render_sequence(n_frames=6, height=H, width=W, seed=11, speed=0.15)
    il, ir = (_t(np.round(np.array(x, np.float32))) for x in (seq.images_left, seq.images_right))
    _, tcfg = _configs()
    g = torch.Generator()
    g.manual_seed(0)
    monkeypatch.setattr(tst, "sparse_depth_at_keypoints", lambda *a, **k: pytest.fail("sparse stereo ran"))
    out = tst.run_stereo_vo_device(il, ir, _port_rig(seq.rig), tcfg, g, _port_frontend(), frame_batch=4)
    assert bool(out.ok.all())
    ts = np.arange(6) * 0.1
    err = ape_translation(Trajectory.from_matrices(ts[1:], out.pose.double().numpy()),
                          Trajectory.from_matrices(ts, np.array(seq.T_world_cam, np.float64)), align=True,
                          with_scale=False).rmse
    assert err < 0.05, err

