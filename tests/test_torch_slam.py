"""The slice whole: the port's ``run_stereo_slam`` against the JAX
package's, and the CLI's ``stereo`` and ``slam`` commands.

``run_stereo_slam`` with relocalization and window BA on
tests/test_relocalize.py's scene (24 corridor frames at 224x160, 0.25 m a
frame, frame 12 noise; tests/test_torch_relocalize.py renders it in the
port's world), windows of 6 frames (none anchored at the noise frame),
keyframe stride 4, loop closure with 8 candidates at least 2 keyframes
apart, similarity 0.5 and 25 inliers. The JAX runner is given the port's
ORB features (384 features, 4 levels) through a front end that looks them
up by the frame index written into pixel (0, 0) of each left frame (both
sides see the same images); sparse depth, matching, PnP, relocalization,
BA with anchor re-matching, loop verification and the pose graph are each
side's own, and every PnP of every stage takes the same Gumbel and
preemptive draws. Held: the same VO flags, candidates, accepted loops (none
here: keyframes 2 m apart fail the 25-inlier gate on both sides) and
repairs (frame 13); the VO and the corrected poses within 1e-4 (readings
3.5e-6 and 1.9e-6), and the end error after SLAM below the VO's (0.066
against 0.516 m).

Two readings behind the choices. With windows of 5 the window anchored at
the noise frame has no observation at its anchor, so its gauge is free and
the two packages' float32 solves land up to 0.09 m apart at equal cost.
With loops 1 keyframe apart one loop is accepted against the odometry edge
it duplicates, and the float32 Gauss-Newton of both pose graphs wanders
around the float64 solution (cost 0.0025 -> 0.0094 -> 0.0027 over three
JAX steps) and ends 3e-3 to 9e-3 m from it and from each other (ROADMAP
Queue C). The pose graph is held against JAX on its own in
tests/test_torch_pose_graph.py, loop verification in
tests/test_torch_loop_closure.py.

The JAX side compiles three PnP graphs (VO, relocalization, loop
verification), the BA and the pose graph: this file takes about 100 s.

Also: ``python -m forest_slam_tpu_torch.cli stereo --map-out --voxel --ba``
and ``slam --relocalize`` at ``--device cpu`` (the trajectory files, the
PLY map equal to ``accumulate_map`` of the same run), ``--relocalize``
without odometry compose exits 2, and the PLY writer, reader and voxel grid
against the JAX package's own (the same bytes, the same centroids).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.backend import mapping as jmapping
from forest_slam_tpu.backend.loop_closure import LoopClosureConfig as JLoop
from forest_slam_tpu.backend.relocalize import RelocalizeConfig as JReloc
from forest_slam_tpu.backend.window import WindowBAConfig as JWindow
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.core.camera import StereoRig as JRig
from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu.io import ply as jply
from forest_slam_tpu.pipelines import slam as jslam
from forest_slam_tpu.pipelines import stereo as jst
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JSparse
from forest_slam_tpu_torch.backend import mapping as tmapping
from forest_slam_tpu_torch.backend.loop_closure import LoopClosureConfig
from forest_slam_tpu_torch.backend.relocalize import RelocalizeConfig
from forest_slam_tpu_torch.backend.window import WindowBAConfig
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io import ply as tply
from forest_slam_tpu_torch.io.tum import read_tum
from forest_slam_tpu_torch.pipelines import slam as tslam
from forest_slam_tpu_torch.pipelines import stereo as tst
from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig
from test_torch_relocalize import H, NOISE_FRAME, N_FRAMES, W, corrupted_corridor

HYP = 512
ORB = dict(n_features=384, n_levels=4)
LOOP = dict(max_candidates=8, min_separation=2, min_similarity=0.5, min_inliers=25)
BA = dict(window=6)  # windows anchored at frames 0, 5, 10, 15, 20: none at the noise frame


@pytest.fixture(scope="module")
def runs():
    il, ir, rig, gt = corrupted_corridor()
    il[:, 0, 0] = torch.arange(N_FRAMES, dtype=torch.float32)  # the frame index, for the JAX look-up
    front = orb_frontend(OrbConfig(**ORB))
    feats = front.extract(il)
    K = feats.xy.shape[1]
    table = JOrbFeatures(*(jnp.asarray(x.numpy().astype(np.uint32) if k == "desc" else x.numpy())
                           for k, x in zip(feats._fields, feats)))
    jfront = JFrontendFns(extract=lambda fp, img: jax.tree.map(lambda a: a[img[0, 0].astype(jnp.int32)], table),
                          match=jorb_frontend(JOrbConfig(**ORB), 64).match, name="given")
    rng = np.random.default_rng(0)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    U = rng.uniform(1e-9, 1.0, K).astype(np.float32)

    jcam = JCam(K=jnp.asarray(rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    jcfg = jslam.SlamConfig(
        stereo=jst.StereoConfig(orb=JOrbConfig(**ORB), sparse=JSparse(num_disparities=48), n_hypotheses=HYP,
                                compose_mode="odometry"),
        loop=JLoop(**LOOP), keyframe_stride=4, ba=JWindow(**BA), relocalize=JReloc())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U).reshape(shape)
                   + 0.0 * key[0].astype(jnp.float32))
        jo = jslam.run_stereo_slam(jnp.asarray(il.numpy()), jnp.asarray(ir.numpy()),
                                   JRig(jcam, jcam, jnp.asarray(rig.T_left_right.numpy())), jcfg,
                                   jax.random.PRNGKey(0), jfront, None)

    cfg = tslam.SlamConfig(
        stereo=tst.StereoConfig(orb=OrbConfig(**ORB), sparse=SparseStereoConfig(num_disparities=48),
                                n_hypotheses=HYP, compose_mode="odometry"),
        loop=LoopClosureConfig(**LOOP), keyframe_stride=4, ba=WindowBAConfig(**BA),
        relocalize=RelocalizeConfig())
    n_pairs, C = N_FRAMES - 1, LOOP["max_candidates"]
    Gt, Ut = torch.as_tensor(G), torch.as_tensor(U)
    draws = tslam.SlamDraws(Gt.expand(n_pairs, -1, -1), Ut.expand(n_pairs, -1), Gt, Ut, Gt.expand(C, -1, -1),
                            Ut.expand(C, -1))
    to = tslam.run_stereo_slam(il, ir, rig, cfg, None, front, draws=draws)
    return jo, to, gt


def test_slam_matches_jax(runs):
    jo, to, gt = runs
    np.testing.assert_array_equal(to.vo.ok.numpy(), np.asarray(jo.vo.ok))
    assert not to.vo.ok[NOISE_FRAME - 1] and not to.vo.ok[NOISE_FRAME]
    assert to.n_relocalized == jo.n_relocalized >= 1
    np.testing.assert_array_equal(to.loop_pairs.numpy(), np.asarray(jo.loop_pairs))
    np.testing.assert_array_equal(to.loop_accepted.numpy(), np.asarray(jo.loop_accepted))
    assert int(to.n_loops) == int(jo.n_loops)
    np.testing.assert_allclose(to.vo.pose.numpy(), np.asarray(jo.vo.pose), atol=1e-4)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose), atol=1e-4)
    end = gt[-1, :3, 3].numpy()
    slam_end = np.linalg.norm(to.pose[-1, :3, 3].numpy() - end)
    vo_end = np.linalg.norm(to.vo.pose[-1, :3, 3].numpy() - end)
    assert slam_end < vo_end, (slam_end, vo_end)


def _cli(*argv):
    from forest_slam_tpu_torch.cli import main

    return main(list(argv))


def test_cli_stereo_writes_the_trajectory_and_map(tmp_path, capsys):
    out, ply = str(tmp_path / "est.txt"), str(tmp_path / "map.ply")
    assert _cli("stereo", "--synthetic", "9", "--out", out, "--map-out", ply, "--voxel", "0.3", "--ba",
                "--ba-window", "4", "--compose-mode", "odometry", "--device", "cpu") == 0
    said = capsys.readouterr().out
    assert "stereo: 8 poses" in said and "map:" in said
    assert len(read_tum(out)) == 8
    cloud = tply.read_ply(ply)
    np.testing.assert_array_equal(cloud, jply.read_ply(ply))
    # the map of the same run: the VO's map points (BA refines the poses only)
    from forest_slam_tpu_torch.io.synthetic import render_sequence

    seq = render_sequence(9, height=160, width=224, seed=0, device="cpu")
    cfg = tst.StereoConfig(sgm=tst.SgmConfig(num_disparities=48), compose_mode="odometry")
    _, outs = tst.run_stereo_vo(seq.images_left, seq.images_right, seq.timestamps, seq.rig, cfg, seed=0)
    want = tmapping.accumulate_map(outs.map_points.numpy(), outs.map_valid.numpy(), 0.3).astype(np.float32)
    np.testing.assert_allclose(cloud, want, atol=1e-6)


def test_cli_slam_runs_with_relocalization(tmp_path, capsys):
    out = str(tmp_path / "est.txt")
    assert _cli("slam", "--synthetic", "12", "--out", out, "--compose-mode", "odometry", "--relocalize",
                "--keyframe-stride", "4", "--loop-separation", "2", "--device", "cpu") == 0
    said = capsys.readouterr().out
    assert "slam: 11 poses" in said and "relocalized 0" in said
    assert len(read_tum(out)) == 11
    assert _cli("slam", "--synthetic", "4", "--out", str(tmp_path / "no.txt"), "--relocalize", "--device",
                "cpu") == 2
    assert not os.path.exists(tmp_path / "no.txt")


def test_ply_and_voxels_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3, (500, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    for colors in (None, rgb):
        a, b = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        tply.write_ply(a, pts, colors)
        jply.write_ply(b, pts, colors)
        assert open(a, "rb").read() == open(b, "rb").read()
        back = tply.read_ply(a, with_colors=True)
        np.testing.assert_array_equal(back[0], pts)
        if colors is None:
            assert back[1] is None
        else:
            np.testing.assert_array_equal(back[1], rgb)
    valid = rng.random((5, 100)) > 0.3
    frames = rng.normal(0, 2, (5, 100, 3))
    np.testing.assert_array_equal(tmapping.accumulate_map(frames, valid, 0.5),
                                  jmapping.accumulate_map(frames, valid, 0.5))
    np.testing.assert_array_equal(tmapping.voxel_downsample(pts, 0.25), jmapping.voxel_downsample(pts, 0.25))
    assert tmapping.voxel_downsample(np.zeros((0, 3)), 0.5).shape == (0, 3)
