"""The whole slice against the JAX package on a short rendered clip.

Three 224x160 corridor frames, the flagship checkpoint (SuperPoint at
float32 on both sides, so keypoints coincide; the matcher in the fused
kernel's bf16 numerics on both sides), K=128, sparse depth, refine radius 12
and PnP-RANSAC with the same injected draws. Phase by phase:

- features and sparse depths: keypoints identical, depths to 1e-4 relative;
- matches: at least 97% of ``matches0`` equal (bf16 roundings in the GNN may
  flip near-tie assignments);
- given the same matches: refined observations to 1e-3 px, validity equal,
  and gated relative poses (then the chained trajectory) to 1e-3; the same
  with the refinement's filter and quality sampling off and P3P as the
  minimal solver (validity equal, poses to 1e-3).
"""

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import learned_frontend as jlearned_frontend
from forest_slam_tpu.frontend.learned import LearnedFrontend as JLearned
from forest_slam_tpu.frontend.learned import LearnedFrontendConfig as JLFConfig
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JSGConfig
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JSPConfig
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JSparse
from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.frontend.base import FrontendFns, learned_frontend
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig
from _torch_threads import one_torch_thread  # noqa: F401

H, W, K, N_FRAMES, HYP = 160, 224, 128, 3, 128


@pytest.fixture(scope="module")
def run():
    seq = render_sequence(n_frames=N_FRAMES, height=H, width=W, seed=11, speed=0.15)
    il, ir = np.array(seq.images_left, np.float32), np.array(seq.images_right, np.float32)
    jrig = seq.rig
    jcfg = jst.StereoConfig(sparse=JSparse(num_disparities=48), n_hypotheses=HYP, compose_mode="odometry",
                            match_refine_radius=12)
    tcfg = tst.StereoConfig(sparse=SparseStereoConfig(num_disparities=48), n_hypotheses=HYP,
                            compose_mode="odometry", match_refine_radius=12)
    state = serialization.msgpack_restore(open(FLAGSHIP_PATH, "rb").read())["params"]
    params = {"superpoint": {"params": {"net": state["superpoint"]["params"]}}, "superglue": state["superglue"]}
    fe = JLearned(JLFConfig(
        superpoint=JSPConfig(stem_stride=4, max_keypoints=K, topk_method="exact", nms_backend="xla",
                             dtype=jnp.float32, desc_sample_dtype=jnp.float32),
        superglue=JSGConfig(gnn_impl="fused_interpret", sinkhorn_impl="xla"),
    ))
    jfront = jlearned_frontend(fe)
    feat_fn = jax.jit(lambda l, r: jst._frame_features(l, r, jrig, jcfg, jfront, params))
    jslab = [feat_fn(jnp.asarray(il[i]), jnp.asarray(ir[i])) for i in range(N_FRAMES)]

    tfe = load_learned_frontend(FLAGSHIP_PATH, (H, W), K, device="cpu",
                                superpoint_overrides={"dtype": torch.float32, "desc_sample_dtype": torch.float32})
    tfront = learned_frontend(tfe)
    K_ = np.array(jrig.left.K)
    cam = PinholeCamera(K=torch.as_tensor(K_), dist=torch.zeros(5), width=W, height=H)
    trig = StereoRig(cam, cam, torch.as_tensor(np.array(jrig.T_left_right)))
    tfeats, tz, tzok = tst.frame_features(torch.as_tensor(il), torch.as_tensor(ir), trig, tcfg, tfront)

    # matches on both sides
    match_fn = jax.jit(lambda p, f0, f1: jfront.match(p, f0, f1, (H, W)))
    jm = np.stack([np.asarray(match_fn(params, jslab[i][0], jslab[i + 1][0])) for i in range(N_FRAMES - 1)])
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
    pair_fn = jax.jit(lambda pf, pz, pok, cf, m, a, b: jst._pair_from_slab(
        pf, pz, pok, cf, jax.random.PRNGKey(0), jrig, jcfg, given, m, (H, W), a, b))
    jpairs = [pair_fn(*jslab[i], jslab[i + 1][0], jnp.asarray(jm[i]), jnp.asarray(il[i]), jnp.asarray(il[i + 1]))
              for i in range(N_FRAMES - 1)]
    mp.undo()
    tgiven = FrontendFns(extract=None, match=lambda f0, f1, shape: torch.as_tensor(jm))
    P = N_FRAMES - 1
    tpairs = tst.pair_from_slab(
        sl(tfeats, 0, P), tz[:P], tzok[:P], sl(tfeats, 1, N_FRAMES), trig, tcfg, tgiven, (H, W),
        torch.as_tensor(il[:P]), torch.as_tensor(il[1:]),
        gumbel=torch.as_tensor(G).expand(P, -1, -1), uniform=torch.as_tensor(U).expand(P, -1),
    )
    # refined observations of the JAX refiner on the same inputs
    from forest_slam_tpu.frontend.refine import RefineConfig, refine_matches_quality

    refine_fn = jax.jit(lambda *a: refine_matches_quality(*a, RefineConfig(radius=12, cost_path="xla")))
    jobs = []
    for i in range(P):
        pf, pz, pok = jslab[i]
        m = jnp.asarray(jm[i])
        valid = (m >= 0) & pok & (pz > 0.1) & (pz < 1000.0) & pf.valid
        obs = jslab[i + 1][0].xy[jnp.where(m >= 0, m, 0)]
        jobs.append(refine_fn(jnp.asarray(il[i]), jnp.asarray(il[i + 1]), pf.xy, obs, valid))
    def pairs_with(**switches):
        """Both pair phases again with other StereoConfig switches."""
        jc, tc = jcfg._replace(**switches), tcfg._replace(**switches)
        mp = pytest.MonkeyPatch()
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape))
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape))
        fn = jax.jit(lambda pf, pz, pok, cf, m, a, b: jst._pair_from_slab(
            pf, pz, pok, cf, jax.random.PRNGKey(0), jrig, jc, given, m, (H, W), a, b))
        jp = [fn(*jslab[i], jslab[i + 1][0], jnp.asarray(jm[i]), jnp.asarray(il[i]), jnp.asarray(il[i + 1]))
              for i in range(P)]
        mp.undo()
        tp = tst.pair_from_slab(
            sl(tfeats, 0, P), tz[:P], tzok[:P], sl(tfeats, 1, N_FRAMES), trig, tc, tgiven, (H, W),
            torch.as_tensor(il[:P]), torch.as_tensor(il[1:]),
            gumbel=torch.as_tensor(G).expand(P, -1, -1), uniform=torch.as_tensor(U).expand(P, -1),
        )
        return jp, tp

    return dict(jslab=jslab, tfeats=tfeats, tz=tz, tzok=tzok, jm=jm, tm=tm, jpairs=jpairs, tpairs=tpairs, jobs=jobs,
                pairs_with=pairs_with)


def test_features_and_depths_match(run):
    for i, (jf, jz, jzok) in enumerate(run["jslab"]):
        np.testing.assert_array_equal(run["tfeats"].xy[i].numpy(), np.asarray(jf.xy))
        np.testing.assert_array_equal(run["tfeats"].valid[i].numpy(), np.asarray(jf.valid))
        np.testing.assert_array_equal(run["tzok"][i].numpy(), np.asarray(jzok))
        ok = np.asarray(jzok)
        assert ok.sum() > 30
        np.testing.assert_allclose(run["tz"][i].numpy()[ok], np.asarray(jz)[ok], rtol=1e-4)


def test_matches_agree(run):
    jm, tm = run["jm"], run["tm"]
    assert (jm >= 0).sum(-1).min() > 30
    assert (jm == tm).mean() >= 0.97, (jm == tm).mean()


def test_refined_observations_and_poses_match(run):
    tp = run["tpairs"]
    rels = []
    for i, jp in enumerate(run["jpairs"]):
        np.testing.assert_array_equal(tp.valid[i].numpy(), np.asarray(jp.valid))
        v = np.asarray(jp.valid)
        assert bool(jp.ok) and bool(tp.ok[i])
        np.testing.assert_allclose(tp.rel[i].numpy(), np.asarray(jp.rel), atol=1e-3)
        assert abs(int(tp.n_inliers[i]) - int(jp.n_inliers)) <= 2
        rels.append(np.asarray(jp.rel))
    jchain = np.asarray(jst._chain_and_map(jax.tree.map(lambda *a: jnp.stack(a), *run["jpairs"]),
                                           jnp.eye(4), len(rels)).pose)
    tchain = tst.chain_and_map(tp, torch.eye(4)).pose.numpy()
    np.testing.assert_allclose(tchain, jchain, atol=2e-3)


def test_refined_observations_match(run):
    tp = run["tpairs"]
    for i, (obs, ok, _) in enumerate(run["jobs"]):
        ok = np.asarray(ok)
        assert ok.sum() > 20
        np.testing.assert_allclose(tp.obs[i].numpy(), np.asarray(obs), atol=1e-3)


def test_refine_switches_off_and_p3p_match(run):
    """match_refine_filter and pnp_quality_sampling off (refinement failures
    stay in the PnP input set, uniform draws) with the P3P solver."""
    jpairs, tp = run["pairs_with"](match_refine_filter=False, pnp_quality_sampling=False, pnp_minimal="p3p")
    for i, jp in enumerate(jpairs):
        np.testing.assert_array_equal(tp.valid[i].numpy(), np.asarray(jp.valid))
        assert np.asarray(jp.valid).sum() > np.asarray(run["jpairs"][i].valid).sum()  # the filter was off
        assert bool(jp.ok) and bool(tp.ok[i])
        np.testing.assert_allclose(tp.rel[i].numpy(), np.asarray(jp.rel), atol=1e-3)
        assert abs(int(tp.n_inliers[i]) - int(jp.n_inliers)) <= 2


def test_stereo_config_switches_default_as_the_reference():
    j, t = jst.StereoConfig(), tst.StereoConfig()
    for f in ("match_refine_filter", "pnp_quality_sampling", "match_refine_scales", "photo_norm", "pnp_minimal",
              "dense_depth"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dense_depth is False and t.sgm.num_disparities == 96
    # The port leaves out the reference's lr_max_diff, which nothing reads
    # (no left-right check is computed); every other SGM field matches.
    assert set(t.sgm._fields) == set(j.sgm._fields) - {"lr_max_diff"}
    for f in t.sgm._fields:
        assert getattr(t.sgm, f) == getattr(j.sgm, f), f
