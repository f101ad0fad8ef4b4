"""The port's relocalization (backend/relocalize.py) against the JAX
package's, on tests/test_relocalize.py's scene.

24 corridor frames at 224x160, 0.25 m a frame, frame 12 replaced by
uniform noise in both views; ORB (384 features, 4 levels), sparse depth
over 48 disparities, 512 hypotheses, odometry compose, through the port's
batched runner. Its trajectory, flags and artifacts go to both sides (the
JAX side gets them as its own ``StereoArtifacts``, uint32 descriptor
words), and every verification takes the same Gumbel and preemptive draws.

Held: the VO loses exactly the two pairs that touch the noise frame; both
sides make the same events (frame 13 repaired against a reference before
frame 12, here frame 10, with 35 inliers on both sides; inlier counts
within 2, reading 0) and
the same corrected poses to 1e-4 (reading 1.8e-6); the repair cuts the end
error below a third of the error before (readings 0.521 -> 0.108 m; the
JAX package's repair of the same inputs gives the same poses). The
absolute rule of tests/test_relocalize.py, below 0.1 m, is the JAX
package's reading in its own world; chip_smoke.py holds it at 960x600. A
chain with no loss comes back bit for bit, as the JAX package returns it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import relocalize as jrel
from forest_slam_tpu.backend import window as jwin
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu_torch.backend import relocalize as trel
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, default_rig, make_corridor_world, render_stereo
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

H, W, N_FRAMES, NOISE_FRAME, SPEED, HYP = 160, 224, 24, 12, 0.25, 512
ORB = dict(n_features=384, n_levels=4)


def corrupted_corridor(device="cpu"):
    """tests/test_relocalize.py's scene in the port's world: (left, right,
    rig, ground truth relative to frame 0)."""
    rig = default_rig(H, W, device=device)
    Ts = corridor_trajectory(N_FRAMES, speed=SPEED, device=device)
    il, ir, _ = render_stereo(make_corridor_world(3, device=device), Ts, rig, H, W)
    noise = torch.as_tensor(np.random.default_rng(9).uniform(0, 255, (H, W)), dtype=torch.float32, device=device)
    il[NOISE_FRAME] = noise
    ir[NOISE_FRAME] = noise
    return il, ir, rig, torch.linalg.inv(Ts[0]) @ Ts


def _jax_artifacts(art):
    f = art.feats
    feats = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                           for k, x in zip(f._fields, f)))
    return jwin.StereoArtifacts(xy=jnp.asarray(art.xy.numpy()), valid=jnp.asarray(art.valid.numpy()),
                                z=jnp.asarray(art.z.numpy()), z_ok=jnp.asarray(art.z_ok.numpy()),
                                matches=jnp.asarray(art.matches.numpy().astype(np.int32)), feats=feats)


@pytest.fixture(scope="module")
def corrupted_vo():
    il, ir, rig, gt = corrupted_corridor()
    cfg = tst.StereoConfig(orb=OrbConfig(**ORB), sparse=SparseStereoConfig(num_disparities=48), n_hypotheses=HYP,
                           compose_mode="odometry")
    outs, art = tst.run_stereo_vo_device(il, ir, rig, cfg, torch.Generator().manual_seed(0),
                                         orb_frontend(cfg.orb), return_artifacts=True)
    K = art.xy.shape[1]
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)
    return rig, gt, outs, art, G, U


def _run_both(corrupted_vo, ok):
    rig, gt, outs, art, G, U = corrupted_vo
    jcam = JCam(K=jnp.asarray(rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        jp, jev = jrel.relocalize_trajectory(outs.pose.numpy(), ok, _jax_artifacts(art), jcam,
                                             jax.random.PRNGKey(1), jorb_frontend(JOrbConfig(**ORB), 64), None,
                                             (H, W), jrel.RelocalizeConfig())
    tp, tev = trel.relocalize_trajectory(outs.pose, torch.as_tensor(ok), art, rig.left, orb_frontend(OrbConfig(**ORB)),
                                         (H, W), trel.RelocalizeConfig(), None, gumbel=torch.as_tensor(G),
                                         uniform=torch.as_tensor(U))
    return jp, jev, tp, tev


def test_noise_frame_loses_tracking(corrupted_vo):
    ok = corrupted_vo[2].ok.numpy()
    assert not ok[NOISE_FRAME - 1] and not ok[NOISE_FRAME]
    assert np.delete(ok, [NOISE_FRAME - 1, NOISE_FRAME]).all()


def test_relocalize_matches_jax(corrupted_vo):
    _, gt, outs, _, _, _ = corrupted_vo
    jp, jev, tp, tev = _run_both(corrupted_vo, outs.ok.numpy())
    assert tev.n_lost == jev.n_lost == 2
    np.testing.assert_array_equal(tev.frame, jev.frame)
    np.testing.assert_array_equal(tev.reference, jev.reference)
    assert np.abs(tev.n_inliers - jev.n_inliers).max() <= 2
    assert (tev.frame == NOISE_FRAME + 1).any() and (tev.reference < NOISE_FRAME).all()
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    end = gt[-1, :3, 3].double().numpy()
    before = np.linalg.norm(outs.pose[-1, :3, 3].double().numpy() - end)
    after = np.linalg.norm(tp[-1, :3, 3] - end)
    assert before > 0.25 and after < before / 3, (before, after)


def test_no_loss_returns_the_chain_bit_for_bit(corrupted_vo):
    outs = corrupted_vo[2]
    jp, jev, tp, tev = _run_both(corrupted_vo, np.ones(outs.ok.shape, bool))
    assert tev.n_lost == jev.n_lost == 0 and tev.n_repaired == 0 and tev.frame.size == 0
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp, outs.pose.double().numpy())
