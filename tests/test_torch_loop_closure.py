"""The port's loop closure (backend/loop_closure.py) against the JAX
package's.

- Signatures of ORB descriptors: the port's int64 words (32 bits each)
  against the JAX package's uint32 words, unpacked to +-1 bits, to 1e-6;
  a dtype test copied from JAX (``unsignedinteger``) would send the port's
  words down the float path, and the test would see it. Float descriptors
  (SuperPoint's) likewise.
- Candidates with tied similarities: twelve keyframes whose signatures
  repeat with period 4 (the ping-pong workload's exact recurrences), with
  entries that make every similarity exact in float32, so the recurrences
  tie at 1.0 bit for bit on both sides: the same pairs in the same order as
  ``jax.lax.top_k`` (the lower flat index first), the same values and
  proposal mask.
- ``verify_loops``: five corridor keyframes at 224x160 (0.15 m apart), ORB
  (384 features, 4 levels) with sparse depth from the port, handed to both
  sides; five candidate pairs 2-4 keyframes apart (one masked off by the
  proposal) through each side's Hamming matcher and PnP-RANSAC with the
  same Gumbel and preemptive draws: the same accepted flags (four accepted,
  with 34-68 inliers), inlier counts within 2 (reading 0), edges within
  1e-4 (reading 1.0e-6).
- No entry point of the back end or the stereo runners draws from torch's
  global generator: each refuses a call with neither a seeded generator
  nor both ``gumbel`` and ``uniform``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import loop_closure as jlc
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu_torch.backend import loop_closure as tlc
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io.synthetic import render_sequence
from forest_slam_tpu_torch.pipelines.stereo import frame_features, StereoConfig
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

H, W, HYP = 160, 224, 256
ORB = dict(n_features=384, n_levels=4)


def test_orb_signature_unpacks_int64_words():
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2**32, (3, 40, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random((3, 40)) > 0.2
    j = jax.vmap(jlc.descriptor_signature)(jnp.asarray(desc), jnp.asarray(valid))
    t = tlc.descriptor_signature(torch.as_tensor(desc.astype(np.int64)), torch.as_tensor(valid))
    assert t.shape == (3, 256)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    # the float path on the same words would be another signature altogether
    wrong = tlc.descriptor_signature(torch.as_tensor(desc.astype(np.float32)), torch.as_tensor(valid))
    assert wrong.shape == (3, 8)


def test_float_signature_matches():
    rng = np.random.default_rng(1)
    desc = rng.normal(size=(4, 50, 32)).astype(np.float32)
    valid = rng.random((4, 50)) > 0.3
    valid[3] = False  # no valid keypoint: the mean is 0, the signature 0
    j = jax.vmap(jlc.descriptor_signature)(jnp.asarray(desc), jnp.asarray(valid))
    t = tlc.descriptor_signature(torch.as_tensor(desc), torch.as_tensor(valid))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_tied_candidates_keep_the_jax_order():
    # entries +-0.25 over 16 dimensions: unit norm and every product exact
    # in float32, so equal similarities are equal bit for bit on both sides
    rng = np.random.default_rng(2)
    base = np.where(rng.random((4, 16)) > 0.5, 0.25, -0.25).astype(np.float32)
    sigs = base[np.arange(12) % 4]
    cfg = jlc.LoopClosureConfig(max_candidates=10, min_separation=2, min_similarity=0.5)
    jp, jv, jm = jlc.detect_loop_candidates(jnp.asarray(sigs), cfg)
    tp, tv, tm = tlc.detect_loop_candidates(torch.as_tensor(sigs), tlc.LoopClosureConfig(**cfg._asdict()))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tv[:8] == 1.0).all() and tp[:3].tolist() == [[0, 4], [0, 8], [1, 5]]


@pytest.fixture(scope="module")
def keyframes():
    seq = render_sequence(5, H, W, seed=4, speed=0.15, device="cpu")
    cfg = StereoConfig(orb=OrbConfig(**ORB), sparse=SparseStereoConfig(num_disparities=48))
    feats, z, z_ok = frame_features(seq.images_left, seq.images_right, seq.rig, cfg, orb_frontend(cfg.orb))
    return seq, feats, z, z_ok


def test_verify_loops_matches_jax(keyframes, monkeypatch):
    seq, feats, z, z_ok = keyframes
    K = feats.xy.shape[1]
    pairs = np.array([[0, 2], [1, 3], [0, 4], [2, 4], [0, 3]], np.int64)
    proposal = np.array([True, True, True, True, False])
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)
    cfg = jlc.LoopClosureConfig(n_hypotheses=HYP, min_inliers=25)
    jcam = JCam(K=jnp.asarray(seq.rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    jfeats = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                            for k, x in zip(feats._fields, feats)))
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape) + 0.0 * key[0].astype(jnp.float32))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape) + 0.0 * key[0].astype(jnp.float32))
    jfront = jorb_frontend(JOrbConfig(**ORB), 64)
    jZ, jn, jacc = jax.jit(lambda: jlc.verify_loops(
        jnp.asarray(pairs.astype(np.int32)), jnp.asarray(proposal), jfeats, jnp.asarray(z.numpy()),
        jnp.asarray(z_ok.numpy()), jcam, jax.random.PRNGKey(0), jfront, None, (H, W), cfg))()
    C = pairs.shape[0]
    tZ, tn, tacc = tlc.verify_loops(torch.as_tensor(pairs), torch.as_tensor(proposal), feats, z, z_ok, seq.rig.left,
                                    orb_frontend(OrbConfig(**ORB)), (H, W), tlc.LoopClosureConfig(**cfg._asdict()),
                                    None, gumbel=torch.as_tensor(G).expand(C, -1, -1),
                                    uniform=torch.as_tensor(U).expand(C, -1))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert np.abs(tn.numpy() - np.asarray(jn)).max() <= 2
    assert tacc[:2].all() and not tacc[4]
    ok = np.array(jacc)
    np.testing.assert_allclose(tZ.numpy()[ok], np.asarray(jZ)[ok], atol=1e-4)
    # the edge is T_i^-1 T_j: keyframe j sits ahead of keyframe i
    assert (tZ[torch.as_tensor(ok), 2, 3] > 0.2).all()


def _refuse(name):
    from forest_slam_tpu_torch.backend.relocalize import RelocalizeConfig, relocalize_trajectory
    from forest_slam_tpu_torch.pipelines import stereo

    if name == "verify_pairs":
        return tlc.verify_pairs(None, None, None, None, None, None, None, tlc.LoopClosureConfig(), None,
                                gumbel=torch.zeros(1, 8, 4))
    if name == "relocalize_trajectory":
        return relocalize_trajectory(torch.eye(4)[None], torch.ones(1, dtype=torch.bool), None, None, None, None,
                                     RelocalizeConfig(), None)
    if name == "run_stereo_vo_device":
        return stereo.run_stereo_vo_device(None, None, None, stereo.StereoConfig(), None, None,
                                           uniform=torch.zeros(1, 4))
    state = stereo.StereoState(None, None, None, torch.eye(4), None)
    return stereo.stereo_step(state, None, None, None, stereo.StereoConfig(), None)


@pytest.mark.parametrize("name", ["verify_pairs", "relocalize_trajectory", "run_stereo_vo_device", "stereo_step"])
def test_draws_need_a_seeded_source(name):
    with pytest.raises(ValueError, match="seeded generator"):
        _refuse(name)
