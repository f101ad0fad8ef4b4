"""The port's batched multi-sequence evaluation
(pipelines/batch_eval.py:run_batched_eval) on gloo ranks on the CPU, one
process per rank, against itself and against the JAX package's
run_batched_eval on the conftest's 8 virtual devices.

Four distinct sequences of six frames (seed s, speed 0.10 + 0.03 s), ORB at
3 levels and 128 hypotheses, in two cases: the JAX dry run's own
(64x96, 128 features), where no pair tracks, in the JAX package as in the
port, and a 160x224 one with 256 features, where every pair tracks, so the
comparisons hold real poses:

- on 4 ranks (1, 4) and 2 ranks (2, 1), each sequence's poses and ok flags
  equal, bit for bit, the one-rank run's and ``run_stereo_vo_device``'s on
  that sequence alone with the generator seeded from (seed, sequence);
- with the same draws handed to both sides (jax.random's gumbel and
  uniform replaced, as tests/test_torch_orb_pipeline.py does), the ok
  flags equal JAX's and the poses agree: relative poses to 1e-3 and the
  chain to 2e-3, that file's bounds;
- S not divisible by the data axis raises ValueError; the four ATEs are
  distinct, so a swap of sequences across ranks would show.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend import OrbConfig as JOrbConfig
from forest_slam_tpu.io.synthetic import render_sequence
from forest_slam_tpu.parallel import make_mesh as jmake_mesh
from forest_slam_tpu.pipelines import batch_eval as jbe
from forest_slam_tpu.pipelines.stereo import StereoConfig as JStereoConfig
from forest_slam_tpu.stereo import SgmConfig as JSgmConfig
from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.parallel import launch
from forest_slam_tpu_torch.pipelines.batch_eval import sequence_seed
from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device
from forest_slam_tpu_torch.stereo.disparity import SgmConfig
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_ranks

S, FRAMES, HYP = 4, 6, 128
SIZES = {"dryrun": (64, 96, 128), "tracking": (160, 224, 256)}
MESHES = [(1, 4), (2, 1)]


def _sequences(h, w):
    seqs = [render_sequence(FRAMES, height=h, width=w, seed=s, speed=0.10 + 0.03 * s) for s in range(S)]
    stack = lambda f: np.stack([np.asarray(f(q), np.float32) for q in seqs])
    return (stack(lambda q: q.images_left), stack(lambda q: q.images_right),
            np.stack([np.asarray(q.T_world_cam, np.float64) for q in seqs]), seqs[0].rig)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (h, w, nf) in SIZES.items():
        il, ir, gt, jrig = _sequences(h, w)
        cam = PinholeCamera(K=torch.as_tensor(np.array(jrig.left.K)), dist=torch.zeros(5), width=w, height=h)
        rig = StereoRig(cam, cam, torch.as_tensor(np.array(jrig.T_left_right)))
        cfg = StereoConfig(orb=OrbConfig(n_features=nf, n_levels=3), sgm=SgmConfig(num_disparities=32),
                           n_hypotheses=HYP, compose_mode="odometry")
        rng = np.random.default_rng(0)
        G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, nf)))).astype(np.float32)
        U = rng.uniform(1e-9, 1.0, nf).astype(np.float32)
        draws = dict(gumbel=torch.as_tensor(G).expand(S, FRAMES - 1, -1, -1),
                     uniform=torch.as_tensor(U).expand(S, FRAMES - 1, -1))
        out[name] = dict(seeded=(il, ir, gt, rig, cfg, None), drawn=(il, ir, gt, rig, cfg, draws), jrig=jrig, G=G, U=U)
    return out


@pytest.fixture(scope="module")
def runs(cases):
    calls = {f"{n}_{k}": cases[n][k] for n in SIZES for k in ("seeded", "drawn")}
    return {shape: launch.run(_torch_ranks.batch_eval, shape[0] * shape[1], "cpu", shape, calls)
            for shape in [(1, 1), *MESHES]}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_equals_one_rank_and_each_sequence(cases, runs, shape, size):
    out, one = runs[shape], runs[(1, 1)]
    assert not out["foreign_modules"]  # the ranks ran without JAX
    for kind in ("seeded", "drawn"):
        ates, oks, poses, ok = out[f"{size}_{kind}"]
        ates1, oks1, poses1, ok1 = one[f"{size}_{kind}"]
        assert poses.shape == (S, FRAMES - 1, 4, 4) and ok.shape == (S, FRAMES - 1)
        assert np.array_equal(poses, poses1) and np.array_equal(ok, ok1)
        assert ates == ates1 and oks == oks1
    il, ir, gt, rig, cfg, _ = cases[size]["seeded"]
    ates, oks, poses, ok = out[f"{size}_seeded"]
    for s in range(S):
        gen = torch.Generator()
        gen.manual_seed(sequence_seed(0, s))
        ref = run_stereo_vo_device(torch.as_tensor(il[s]), torch.as_tensor(ir[s]), rig, cfg, gen,
                                   orb_frontend(cfg.orb, cfg.max_match_distance), frame_batch=6, pair_batch=5)
        assert np.array_equal(poses[s], ref.pose.double().numpy()), s
        assert np.array_equal(ok[s], ref.ok.numpy()), s
    if size == "tracking":
        assert ok.all()
    assert len({round(a, 6) for a in ates}) == S  # distinct: a swap across ranks would show


def test_indivisible_sequences_raise(runs):
    assert runs[(2, 1)]["odd"] == "3 sequences not divisible by data axis 2"
    assert runs[(1, 4)]["odd"] is None and runs[(1, 1)]["odd"] is None


def _relative(poses):
    prev = np.concatenate([np.broadcast_to(np.eye(4), (poses.shape[0], 1, 4, 4)), poses[:, :-1]], axis=1)
    return np.linalg.inv(prev) @ poses


@pytest.mark.parametrize("size", list(SIZES))
def test_matches_jax_batched_eval(cases, runs, size):
    c = cases[size]
    h, w, nf = SIZES[size]
    il, ir, gt, _, _, _ = c["drawn"]
    jcfg = JStereoConfig(orb=JOrbConfig(n_features=nf, n_levels=3), sgm=JSgmConfig(num_disparities=32),
                         n_hypotheses=HYP, compose_mode="odometry")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(c["G"]).reshape(shape))
    mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(c["U"]).reshape(shape))
    try:
        mesh = jmake_mesh(8)
        assert dict(mesh.shape) == {"data": 2, "model": 4}
        jres, jposes = jbe.run_batched_eval(jnp.asarray(il), jnp.asarray(ir), jnp.asarray(gt), c["jrig"], jcfg, mesh,
                                            frame_batch=6, pair_batch=5)
    finally:
        mp.undo()
    ates, oks, poses, ok = runs[(2, 1)][f"{size}_drawn"]
    assert oks == [r.ok_fraction for r in jres]
    np.testing.assert_allclose(_relative(poses), _relative(jposes), atol=1e-3)
    np.testing.assert_allclose(poses, jposes, atol=2e-3)
    np.testing.assert_allclose(ates, [r.ate_rmse for r in jres], atol=2e-3)
    if size == "tracking":
        assert all(o == 1.0 for o in oks)
