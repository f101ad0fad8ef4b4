"""The port's sequential stereo runners against the JAX package's scan.

Seven corridor frames at 224x160 (0.25 m a frame). The JAX scan is given
the port's ORB features (384 features, 4 levels) through a front end that
looks them up by frame index, written into pixel (0, 0) of each left frame
(outside ORB's 16 px margin; both sides see the same images) and matches
them with its own Hamming matcher; sparse depth over 48 disparities is each
side's own; every pair takes the same Gumbel and preemptive draws. Held:

- the port's scan against the JAX scan: the same tracking and match
  counts, inlier counts within 2 (reading 0), chained poses to 1e-4
  (reading 4.5e-6), map points to 1e-3 relative;
- with the same draws the port's scan equals its batched runner bit for
  bit, sparse and dense (SGM over 48 disparities: the scan keeps the whole
  depth map and reads it at the keypoints, the batched runner reads it as
  it extracts);
- streaming in chunks of 3 equals the scan exactly, the file holds the
  returned trajectory (to the TUM file's 6 decimals), and ``on_chunk``
  sees the trajectory grow chunk by chunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.core.camera import StereoRig as JRig
from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JSparse
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io.synthetic import render_sequence
from forest_slam_tpu_torch.io.tum import read_tum
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.disparity import SgmConfig
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

H, W, N_FRAMES, HYP = 160, 224, 7, 256
ORB = dict(n_features=384, n_levels=4)
CFG = tst.StereoConfig(orb=OrbConfig(**ORB), sparse=SparseStereoConfig(num_disparities=48), n_hypotheses=HYP,
                       compose_mode="odometry")


def draws(n_pairs, K, seed=0):
    rng = np.random.default_rng(seed)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)
    return G, U, torch.as_tensor(G).expand(n_pairs, -1, -1), torch.as_tensor(U).expand(n_pairs, -1)


@pytest.fixture(scope="module")
def clip():
    seq = render_sequence(N_FRAMES, H, W, seed=5, speed=0.25, device="cpu")
    il = seq.images_left.clone()
    il[:, 0, 0] = torch.arange(N_FRAMES, dtype=torch.float32)  # the frame index, for the JAX look-up
    return seq, il, seq.images_right


def _jax_rig(rig):
    cam = JCam(K=jnp.asarray(rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    return JRig(cam, cam, jnp.asarray(rig.T_left_right.numpy()))


def test_scan_matches_jax_scan(clip):
    seq, il, ir = clip
    front = orb_frontend(CFG.orb)
    feats = front.extract(il)
    table = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                           for k, x in zip(feats._fields, feats)))
    jmatch = jorb_frontend(JOrbConfig(**ORB), 64).match
    jfront = JFrontendFns(extract=lambda fp, img: jax.tree.map(lambda a: a[img[0, 0].astype(jnp.int32)], table),
                          match=jmatch, name="given")
    G, U, Gt, Ut = draws(N_FRAMES - 1, feats.xy.shape[1])
    jcfg = jst.StereoConfig(orb=JOrbConfig(**ORB), sparse=JSparse(num_disparities=48), n_hypotheses=HYP,
                            compose_mode="odometry")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        jo = jst.run_stereo_vo_scan(jnp.asarray(il.numpy()), jnp.asarray(ir.numpy()), _jax_rig(seq.rig), jcfg,
                                    jax.random.PRNGKey(0), jfront, None)
    to = tst.run_stereo_vo_scan(il, ir, seq.rig, CFG, None, front, gumbel=Gt, uniform=Ut)
    assert to.ok.all()
    np.testing.assert_array_equal(to.ok.numpy(), np.asarray(jo.ok))
    np.testing.assert_array_equal(to.n_matches.numpy(), np.asarray(jo.n_matches))
    assert np.abs(to.n_inliers.numpy() - np.asarray(jo.n_inliers)).max() <= 2
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose), atol=1e-4)
    valid = np.asarray(jo.map_valid) & to.map_valid.numpy()
    assert valid.sum() > 0.9 * np.asarray(jo.map_valid).sum()
    np.testing.assert_allclose(to.map_points.numpy()[valid], np.asarray(jo.map_points)[valid], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dense", [False, True])
def test_scan_equals_batched_with_the_same_draws(clip, dense):
    seq, il, ir = clip
    cfg = CFG._replace(dense_depth=True, sgm=SgmConfig(num_disparities=48)) if dense else CFG
    rig = seq.rig
    front = orb_frontend(cfg.orb)
    K = cfg.orb.n_features
    _, _, Gt, Ut = draws(N_FRAMES - 1, K)
    scan = tst.run_stereo_vo_scan(il, ir, rig, cfg, None, front, gumbel=Gt, uniform=Ut)
    batched = tst.run_stereo_vo_device(il, ir, rig, cfg, None, front, gumbel=Gt, uniform=Ut)
    assert scan.ok.sum() >= N_FRAMES - 2
    for a, b in zip(scan, batched):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_streaming_equals_scan(clip, tmp_path):
    seq, il, ir = clip
    path = str(tmp_path / "stream.txt")
    seen = []
    traj_s, outs_s = tst.run_stereo_vo_streaming(il, ir, seq.timestamps, seq.rig, CFG, path, seed=3, chunk=3,
                                                 on_chunk=lambda ts, poses: seen.append((len(ts), poses.shape)))
    traj_r, outs_r = tst.run_stereo_vo(il, ir, seq.timestamps, seq.rig, CFG, seed=3, mode="scan")
    np.testing.assert_array_equal(outs_s.pose.numpy(), outs_r.pose.numpy())
    np.testing.assert_array_equal(outs_s.ok.numpy(), outs_r.ok.numpy())
    on_disk = read_tum(path)
    assert len(on_disk) == len(traj_s) == N_FRAMES - 1
    np.testing.assert_allclose(on_disk.positions, traj_s.positions, atol=1e-6)
    np.testing.assert_allclose(on_disk.timestamps, seq.timestamps[1:], atol=1e-6)
    assert [s[0] for s in seen] == [3, 6] and seen[-1][1] == (6, 4, 4)
    assert outs_s.pose.device.type == "cpu"
