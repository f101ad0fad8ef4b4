"""The port's sliding-window BA (backend/window.py) against the JAX package's.

- Track tables on hand-built matches: the JAX test's chain (frame 0
  keypoint 0 -> frame 1 keypoint 2 -> frame 2 keypoint 0, a track killed by
  a -1), and random matches with -1s, invalid keypoints and depths out of
  range over three 5-frame windows, every start frame with and without the
  anchor's (the ``targeted`` scatter and the rolls): equal to the JAX
  tables element for element.
- ``refine_trajectory_ba`` on the same artifacts: 13 frames of the
  corridor at 160x120 (0.25 m a frame), ORB (384 features, 4 levels),
  sparse depth over 32 disparities, run through the port's batched runner;
  the artifacts go to the JAX package as its own ``StereoArtifacts`` (uint32
  descriptor words), and back to the port through ``artifacts_from_numpy``,
  so both sides refine identical inputs. Three windows of 5 frames cover
  the 12 pairs, with tracks composed from the VO's matches only and with
  the anchors re-matched by each side's own Hamming matcher: refined poses
  within 5e-5 (metres and rotation entries; readings 3.6e-6 m and 4.1e-7),
  moved from the VO's, with a mean position error no worse than 1.05x the
  VO's (readings 0.192 and 0.160 m against the VO's 0.249 m).
- Frames past the last whole window ride rigidly on its corrected
  boundary pose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import window as jwin
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu_torch.backend import window as twin
from forest_slam_tpu_torch.core.lie import se3_orthonormalize
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io.synthetic import render_sequence
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

H, W, N_FRAMES = 120, 160, 13
ORB = dict(n_features=384, n_levels=4)


def test_compose_tracks_follows_matches():
    M, K = 3, 4
    xy = np.arange(M * K * 2, dtype=np.float32).reshape(M, K, 2)
    valid = np.ones((M, K), bool)
    matches = np.array([[2, -1, 0, 3], [3, 1, 0, -1]], np.int32)
    z = np.full((M, K), 5.0, np.float32)
    z_ok = np.ones((M, K), bool)
    j = jwin._compose_tracks(*(jnp.asarray(a) for a in (xy, valid, matches, z, z_ok)), jwin.WindowBAConfig())
    t = twin.compose_tracks(*(torch.as_tensor(a)[None] for a in (xy, valid, matches.astype(np.int64), z, z_ok)),
                            twin.WindowBAConfig())
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    m, o = t.mask[0].numpy(), t.obs[0].numpy()
    assert m[0].all() and m[1, 0] and (o[1, 0] == xy[1, 2]).all() and m[2, 0] and (o[2, 0] == xy[2, 0]).all()
    assert not m[1, 1] and not m[2, 1]


@pytest.mark.parametrize("include_anchor_start", [True, False])
def test_compose_tracks_multi_matches_jax(include_anchor_start):
    rng = np.random.default_rng(3)
    Wn, M, K = 3, 5, 7
    xy = rng.uniform(0, 100, (Wn, M, K, 2)).astype(np.float32)
    valid = rng.random((Wn, M, K)) > 0.1
    matches = rng.integers(-1, K, (Wn, M - 1, K)).astype(np.int32)
    z = rng.uniform(-0.5, 20, (Wn, M, K)).astype(np.float32)  # some below min_depth
    z_ok = rng.random((Wn, M, K)) > 0.1
    cfg = jwin.WindowBAConfig()
    j = jax.vmap(lambda *a: jwin._compose_tracks_multi(*a, cfg, include_anchor_start=include_anchor_start))(
        *(jnp.asarray(a) for a in (xy, valid, matches, z, z_ok)))
    tracks, start, axy, az = twin.compose_tracks_multi(
        *(torch.as_tensor(a) for a in (xy, valid, matches.astype(np.int64), z, z_ok)), twin.WindowBAConfig(),
        include_anchor_start=include_anchor_start)
    for a, b in zip((*tracks, start, axy, az), j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tracks.mask.sum() > 20


def _jax_artifacts(art):
    """The port's artifacts as the JAX package's StereoArtifacts."""
    f = art.feats
    feats = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                           for k, x in zip(f._fields, f)))
    return jwin.StereoArtifacts(xy=jnp.asarray(art.xy.numpy()), valid=jnp.asarray(art.valid.numpy()),
                                z=jnp.asarray(art.z.numpy()), z_ok=jnp.asarray(art.z_ok.numpy()),
                                matches=jnp.asarray(art.matches.numpy().astype(np.int32)), feats=feats)


@pytest.fixture(scope="module")
def vo():
    seq = render_sequence(N_FRAMES, H, W, seed=3, speed=0.25, device="cpu")
    cfg = tst.StereoConfig(orb=OrbConfig(**ORB), sparse=SparseStereoConfig(num_disparities=32), n_hypotheses=256,
                           compose_mode="odometry")
    g = torch.Generator().manual_seed(0)
    outs, art = tst.run_stereo_vo_device(seq.images_left, seq.images_right, seq.rig, cfg, g,
                                         tst.orb_frontend(cfg.orb, cfg.max_match_distance), return_artifacts=True)
    assert bool(outs.ok.all())
    jart = _jax_artifacts(art)
    back = twin.artifacts_from_numpy(jax.tree.map(np.asarray, jart))
    assert back.feats.desc.dtype == torch.int64 and torch.equal(back.feats.desc, art.feats.desc)
    return seq, outs, back, jart


@pytest.mark.parametrize("rematch", [False, True])
def test_refine_trajectory_ba_matches_jax(vo, rematch):
    seq, outs, art, jart = vo
    cam = seq.rig.left
    jcam = JCam(K=jnp.asarray(cam.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    cfg = jwin.WindowBAConfig(window=5)
    jfront = jorb_frontend(JOrbConfig(**ORB), 64) if rematch else None
    jref = jax.jit(lambda p, a: jwin.refine_trajectory_ba(p, a, jcam, cfg, frontend=jfront, fparams=None,
                                                          image_shape=(H, W)))(jnp.asarray(outs.pose.numpy()), jart)
    tfront = tst.orb_frontend(OrbConfig(**ORB), 64) if rematch else None
    tref = twin.refine_trajectory_ba(outs.pose, art, cam, twin.WindowBAConfig(window=5), frontend=tfront)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=5e-5)
    # 12 pairs: three windows of four steps cover them all; the poses moved
    assert tref.shape == outs.pose.shape and (tref - outs.pose).abs().max() > 1e-4
    gt = seq.T_world_cam
    rel_gt = torch.linalg.inv(gt[0]) @ gt[1:]
    err = lambda p: (p[:, :3, 3] - rel_gt[:, :3, 3]).norm(dim=-1).mean()
    assert err(tref) <= err(outs.pose) * 1.05, (float(err(tref)), float(err(outs.pose)))


def test_tail_rides_on_the_last_window(vo):
    """Ten frames: two windows cover frames 1..8, and frame 9 rides rigidly
    on the corrected frame 8."""
    seq, outs, art, _ = vo
    short = twin.StereoArtifacts(art.xy[:10], art.valid[:10], art.z[:10], art.z_ok[:10], art.matches[:9])
    poses = outs.pose[:9]
    ref = twin.refine_trajectory_ba(poses, short, seq.rig.left, twin.WindowBAConfig(window=5))
    rigid = se3_orthonormalize(poses)
    np.testing.assert_allclose(ref[8].numpy(), (ref[7] @ torch.linalg.inv(rigid[7]) @ rigid[8]).numpy(), atol=1e-5)
