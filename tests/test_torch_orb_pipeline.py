"""The ORB stereo path against the JAX package on a short rendered clip.

Three 224x160 corridor frames, ORB with the bench's quick configuration
(512 features, 4 levels: at this size the levels past the fourth hold no
keypoint inside the 16 px margin, and tests/test_torch_orb.py holds all 8
levels against JAX; the JAX side on its XLA detection path), sparse depth at
the ORB keypoints, mutual-NN Hamming matching with max distance 64, no match
refinement, and PnP-RANSAC with the same injected draws on both sides. Phase
by phase:

- features and sparse depths: keypoints in the same slots for at least 98%
  of the valid ones, depths to 1e-4 relative where both sides hold the same
  keypoint;
- matches: at least 97% of ``matches0`` equal;
- given the same matches: validity equal and gated relative poses (then the
  chained trajectory) to 1e-3;
- the host entry point ``run_stereo_vo`` with no front end runs ORB on the
  CPU tensors it is given and returns the trajectory of frames 1..N-1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JSparse
from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.frontend.base import FrontendFns, orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

H, W, N_FRAMES, HYP, K = 160, 224, 3, 128, 512


@pytest.fixture(scope="module")
def run():
    seq = render_sequence(n_frames=N_FRAMES, height=H, width=W, seed=11, speed=0.15)
    il, ir = np.array(seq.images_left, np.float32), np.array(seq.images_right, np.float32)
    jrig = seq.rig
    jcfg = jst.StereoConfig(orb=JOrbConfig(n_levels=4, detect_backend="xla"), sparse=JSparse(num_disparities=48),
                            n_hypotheses=HYP, compose_mode="odometry")
    tcfg = tst.StereoConfig(orb=OrbConfig(n_levels=4), sparse=SparseStereoConfig(num_disparities=48),
                            n_hypotheses=HYP, compose_mode="odometry")
    jfront = jorb_frontend(jcfg.orb, jcfg.max_match_distance)
    feat_fn = jax.jit(lambda l, r: jst._frame_features(l, r, jrig, jcfg, jfront, None))
    jslab = [feat_fn(jnp.asarray(il[i]), jnp.asarray(ir[i])) for i in range(N_FRAMES)]

    tfront = orb_frontend(tcfg.orb, tcfg.max_match_distance)
    cam = PinholeCamera(K=torch.as_tensor(np.array(jrig.left.K)), dist=torch.zeros(5), width=W, height=H)
    trig = StereoRig(cam, cam, torch.as_tensor(np.array(jrig.T_left_right)))
    tfeats, tz, tzok = tst.frame_features(torch.as_tensor(il), torch.as_tensor(ir), trig, tcfg, tfront)

    match_fn = jax.jit(lambda f0, f1: jfront.match(None, f0, f1, (H, W)))
    jm = np.stack([np.asarray(match_fn(jslab[i][0], jslab[i + 1][0])) for i in range(N_FRAMES - 1)])
    sl = lambda f, a, b: type(f)(*(x[a:b] for x in f))
    tm = tfront.match(sl(tfeats, 0, N_FRAMES - 1), sl(tfeats, 1, N_FRAMES), (H, W)).numpy()

    # the pair phase given the same matches and draws on both sides
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)
    given = JFrontendFns(extract=None, match=lambda fp, f0, f1, shape: fp, name="given")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape))
    mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape))
    pair_fn = jax.jit(lambda pf, pz, pok, cf, m: jst._pair_from_slab(
        pf, pz, pok, cf, jax.random.PRNGKey(0), jrig, jcfg, given, m, (H, W)))
    jpairs = [pair_fn(*jslab[i], jslab[i + 1][0], jnp.asarray(jm[i])) for i in range(N_FRAMES - 1)]
    mp.undo()
    tgiven = FrontendFns(extract=None, match=lambda f0, f1, shape: torch.as_tensor(jm))
    P = N_FRAMES - 1
    tpairs = tst.pair_from_slab(
        sl(tfeats, 0, P), tz[:P], tzok[:P], sl(tfeats, 1, N_FRAMES), trig, tcfg, tgiven, (H, W),
        gumbel=torch.as_tensor(G).expand(P, -1, -1), uniform=torch.as_tensor(U).expand(P, -1),
    )
    return dict(il=il, ir=ir, trig=trig, tcfg=tcfg, jslab=jslab, tfeats=tfeats, tz=tz, tzok=tzok, jm=jm, tm=tm,
                jpairs=jpairs, tpairs=tpairs)


def test_features_and_depths_match(run):
    for i, (jf, jz, jzok) in enumerate(run["jslab"]):
        jxy, jv = np.asarray(jf.xy), np.asarray(jf.valid)
        txy, tv = run["tfeats"].xy[i].numpy(), run["tfeats"].valid[i].numpy()
        same = (jxy == txy).all(-1) & jv & tv
        assert jv.sum() > 200 and same.sum() >= 0.98 * jv.sum()
        ok = same & np.asarray(jzok) & run["tzok"][i].numpy()
        assert ok.sum() > 0.9 * (same & np.asarray(jzok)).sum() and ok.sum() > 100
        np.testing.assert_allclose(run["tz"][i].numpy()[ok], np.asarray(jz)[ok], rtol=1e-4)


def test_matches_agree(run):
    jm, tm = run["jm"], run["tm"]
    assert (jm >= 0).sum(-1).min() > 50
    assert (jm == tm).mean() >= 0.97, (jm == tm).mean()


def test_gated_poses_match(run):
    tp = run["tpairs"]
    for i, jp in enumerate(run["jpairs"]):
        assert bool(jp.ok) and bool(tp.ok[i])
        assert (tp.valid[i].numpy() == np.asarray(jp.valid)).mean() >= 0.98
        np.testing.assert_allclose(tp.rel[i].numpy(), np.asarray(jp.rel), atol=1e-3)
    jchain = np.asarray(jst._chain_and_map(jax.tree.map(lambda *a: jnp.stack(a), *run["jpairs"]),
                                           jnp.eye(4), N_FRAMES - 1).pose)
    np.testing.assert_allclose(tst.chain_and_map(tp, torch.eye(4)).pose.numpy(), jchain, atol=2e-3)


def test_run_stereo_vo_defaults_to_orb(run):
    ts = np.arange(N_FRAMES) * 0.1
    traj, outs = tst.run_stereo_vo(torch.as_tensor(run["il"]), torch.as_tensor(run["ir"]), ts, run["trig"],
                                   run["tcfg"], seed=0)
    assert outs.pose.device.type == "cpu"
    assert tuple(outs.pose.shape) == (N_FRAMES - 1, 4, 4) and bool(outs.ok.all())
    np.testing.assert_array_equal(traj.timestamps, ts[1:])
    np.testing.assert_allclose(traj.positions, outs.pose[:, :3, 3].double().numpy())
    with pytest.raises(NotImplementedError, match="scan"):
        tst.run_stereo_vo(run["il"], run["ir"], ts, run["trig"], run["tcfg"], mode="scan")
    with pytest.raises(NotImplementedError, match="bundle adjustment"):
        tst.run_stereo_vo(run["il"], run["ir"], ts, run["trig"], run["tcfg"], ba=object())
