"""Monocular VO of the port against the JAX package's runner.

Eight 224x160 frames of the corridor (the port's renderer, seed 3) along a
steady turn: 0.25 m a frame, the heading turning 4 degrees a frame, so each
pair's true rotation is 4 degrees. ORB at 384 features and 4 levels
(tests/test_pipeline_mono.py's setting), 128 hypotheses. The JAX runner
(``run_mono_vo_batched``, the 7 pairs in one batch, odometry mode, 8-point)
is given the port's ORB features through a front end that looks them up by
frame index, and matches them with its own Hamming matcher; both sides take
the same Gumbel draws for every pair. The extraction itself is held against
the JAX extractor in tests/test_torch_orb_extract.py, and the 5-point
solver against the JAX package's in tests/test_torch_fivepoint.py, so the
JAX runner is compiled once, for the 8-point solver.

Held against that run, for the port's odometry run and for its parity run
with the 8-point solver (the same estimates; parity chains the point
transforms, so each pair's camera motion is the inverse of its relative
transform): match counts equal, tracking equal, inlier counts within 1,
each pair's camera rotation within 0.5 degrees of JAX's (readings: 0 on six
pairs, 0.343 on the one whose inlier count differs by 1), the mean rotation
error against the turn below 1 degree (reading 0.79; an identity rotation
would be 4 degrees off) and no worse than JAX's +0.05 degrees, the mean
translation-direction error no worse than JAX's +1 degree (about 80 matches
a pair at a 1 px gate leave 2-32 degrees on both sides). The default parity
run (5-point): the JAX matcher's matches, every pair tracked, the mean
rotation error below 1.25 degrees (reading 0.93).

Also: the scan runner equals the batched one bit for bit on the CPU; the
learned front end (the flagship checkpoint at K=128) runs the mono path
through the plain versions of its kernels, no kernel counted as launched;
the CLI writes the TUM file and a metrics file whose rows are those of the
JAX package's ``write_metrics_jsonl``.
"""

import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.frontend.base import FrontendFns as JFrontendFns
from forest_slam_tpu.frontend.base import orb_frontend as jorb_frontend
from forest_slam_tpu.frontend.orb import OrbConfig as JOrbConfig
from forest_slam_tpu.frontend.orb import OrbFeatures as JOrbFeatures
from forest_slam_tpu.pipelines import mono as jmono
from forest_slam_tpu.utils.metrics import write_metrics_jsonl as jwrite_metrics
from forest_slam_tpu_torch.frontend.base import orb_frontend
from forest_slam_tpu_torch.frontend.orb import OrbConfig
from forest_slam_tpu_torch.io.synthetic import default_rig, make_corridor_world, render_stereo, turning_trajectory
from forest_slam_tpu_torch.pipelines import mono as tmono
from forest_slam_tpu_torch.utils.metrics import write_metrics_jsonl

N_FRAMES, H, W, HYP, K = 8, 160, 224, 128, 384
ORB = dict(n_features=K, n_levels=4)
YAW_STEP_DEG = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: with test workers
    sharing the cores, OpenMP's threads contend and slow these ops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Seq(NamedTuple):
    images_left: torch.Tensor
    timestamps: np.ndarray
    T_world_cam: torch.Tensor
    rig: object


@pytest.fixture(scope="module")
def seq():
    rig = default_rig(H, W, device="cpu")
    Ts = turning_trajectory(N_FRAMES, YAW_STEP_DEG, device="cpu")
    il, _, _ = render_stereo(make_corridor_world(3, device="cpu"), Ts, rig, H, W)
    s = Seq(images_left=il, timestamps=1.6e9 + np.arange(N_FRAMES) * 0.1, T_world_cam=Ts, rig=rig)
    G = -np.log(-np.log(np.random.default_rng(0).uniform(1e-12, 1.0, (HYP, K)))).astype(np.float32)
    return s, G


def _jax_given_features(feats):
    """A JAX front end whose images are frame indices (N, 1, 1) and whose
    features are the port's, with the JAX ORB matcher."""
    table = JOrbFeatures(*(jnp.asarray(np.asarray(x)) for x in (
        feats.xy, feats.response, feats.angle, feats.octave, feats.desc.numpy().astype(np.uint32), feats.valid)))
    match = jorb_frontend(JOrbConfig(**ORB), 64).match

    def extract(fparams, image):
        i = image[0, 0].astype(jnp.int32)
        return jax.tree.map(lambda a: a[i], table)

    return JFrontendFns(extract=extract, match=match, name="given")


@pytest.fixture(scope="module")
def runs(seq):
    """The JAX runner in odometry mode (8-point), and the port's runs:
    odometry, parity with the 8-point solver (the same estimates composed
    the other way), and parity with its default 5-point solver, each
    batched and as a scan."""
    s, G = seq
    feats = orb_frontend(OrbConfig(**ORB)).extract(s.images_left)
    jfront = _jax_given_features(feats)
    jcam = JCam(K=jnp.asarray(s.rig.left.K.numpy()), dist=jnp.zeros(5), width=W, height=H)
    Gt = torch.as_tensor(G).expand(N_FRAMES - 1, -1, -1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # G made to depend on the (traced) key, so XLA does not fold the draws' sort at compile time
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, *a, **k: jnp.asarray(G).reshape(shape) + 0.0 * key[0].astype(jnp.float32))
        jcfg = jmono.MonoConfig(orb=JOrbConfig(**ORB), n_hypotheses=HYP, compose_mode="odometry")
        j = jmono.run_mono_vo_batched(jnp.arange(N_FRAMES, dtype=jnp.float32)[:, None, None], jcam, jcfg,
                                      jax.random.PRNGKey(0), jfront, None, frame_chunk=N_FRAMES,
                                      pair_chunk=N_FRAMES - 1)
    out["jax"] = jax.tree.map(np.asarray, j)
    for name, mode, minimal in (("odometry", "odometry", "auto"), ("parity8", "parity", "8pt"),
                                ("parity", "parity", "auto")):
        tcfg = tmono.MonoConfig(orb=OrbConfig(**ORB), n_hypotheses=HYP, compose_mode=mode, minimal=minimal)
        traj, t = tmono.run_mono_vo(s.images_left, s.timestamps, s.rig.left, tcfg, gumbel=Gt)
        out[name] = dict(port=t, traj=traj)
        if name != "parity8":
            out[name]["scan"] = tmono.run_mono_vo(s.images_left, s.timestamps, s.rig.left, tcfg, gumbel=Gt,
                                                  mode="scan")[1]
    out["gt"] = s.T_world_cam
    return out


def _angle(R):
    return torch.rad2deg(torch.arccos(torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)))


def _camera_motion(pose, mode):
    """Each pair's camera motion (N-1, 4, 4) from chained poses: odometry
    chains camera motions, parity their inverses (point transforms)."""
    from forest_slam_tpu_torch.core.lie import se3_inverse

    P = torch.cat([torch.eye(4, dtype=torch.float64)[None], torch.as_tensor(np.array(pose), dtype=torch.float64)])
    rel = se3_inverse(P[:-1]) @ P[1:]
    return se3_inverse(rel) if mode == "parity" else rel


def _pair_errors(motion, gt):
    """Per-pair rotation error and translation-direction error (degrees) of
    camera motions (N-1, 4, 4) against the true ones."""
    from forest_slam_tpu_torch.core.lie import se3_inverse

    gt = gt.double()
    true = se3_inverse(gt[:-1]) @ gt[1:]
    rot = _angle(true[:, :3, :3].transpose(-1, -2) @ motion[:, :3, :3])
    unit = lambda v: v / v.norm(dim=-1, keepdim=True)  # noqa: E731
    tdir = torch.rad2deg(torch.arccos(torch.clamp((unit(motion[:, :3, 3]) * unit(true[:, :3, 3])).sum(-1), -1, 1)))
    return rot.numpy(), tdir.numpy()


def test_the_scene_turns(seq):
    from forest_slam_tpu_torch.core.lie import se3_inverse

    gt = seq[0].T_world_cam.double()
    np.testing.assert_allclose(_angle((se3_inverse(gt[:-1]) @ gt[1:])[:, :3, :3]).numpy(), YAW_STEP_DEG, rtol=1e-4)


@pytest.mark.parametrize("mode", ["parity", "odometry"])
def test_mono_runner_matches_jax(runs, mode):
    """The port against the JAX runner's odometry run (8-point, the same
    draws): odometry directly, parity through the port's parity run with
    the 8-point solver, whose chain composes the point transforms, so each
    pair's camera motion is the inverse of its relative transform."""
    j, t = runs["jax"], runs["odometry" if mode == "odometry" else "parity8"]["port"]
    assert t.pose.device.type == "cpu" and tuple(t.pose.shape) == (N_FRAMES - 1, 4, 4)
    np.testing.assert_array_equal(t.n_matches.numpy(), j.n_matches)
    assert (j.n_matches > 50).all()
    np.testing.assert_array_equal(t.ok.numpy(), j.ok)
    assert t.ok.all()
    d = t.n_inliers.numpy() - j.n_inliers
    m_t, m_j = _camera_motion(t.pose, mode), _camera_motion(j.pose, "odometry")
    rot_t, tdir_t = _pair_errors(m_t, runs["gt"])
    rot_j, tdir_j = _pair_errors(m_j, runs["gt"])
    diff = _angle(m_t[:, :3, :3].transpose(-1, -2) @ m_j[:, :3, :3]).numpy()
    print(f"{mode}: inliers port-JAX {d.tolist()}, rotation port vs JAX {diff.round(4).tolist()}, errors to the truth "
          f"port {rot_t.round(3).tolist()} JAX {rot_j.round(3).tolist()}, t direction port {tdir_t.round(2).tolist()} "
          f"JAX {tdir_j.round(2).tolist()}")
    assert np.abs(d).max() <= 1, d
    assert diff.max() < 0.5, diff
    assert rot_t.mean() < 1.0, rot_t
    assert rot_t.mean() <= rot_j.mean() + 0.05 and tdir_t.mean() <= tdir_j.mean() + 1.0, (rot_t, rot_j, tdir_t, tdir_j)


def test_parity_five_point_tracks_the_turn(runs):
    """The default parity run (the 5-point solver; the solver is held
    against the JAX package's in tests/test_torch_fivepoint.py): the JAX
    matcher's matches, every pair tracked, rotations close to the turn."""
    j, t = runs["jax"], runs["parity"]["port"]
    np.testing.assert_array_equal(t.n_matches.numpy(), j.n_matches)
    assert t.ok.all()
    rot, tdir = _pair_errors(_camera_motion(t.pose, "parity"), runs["gt"])
    print(f"parity 5-point: errors to the truth {rot.round(3).tolist()}, t direction {tdir.round(2).tolist()}")
    assert rot.mean() < 1.25, rot


@pytest.mark.parametrize("mode", ["parity", "odometry"])
def test_scan_equals_batched(runs, mode):
    a, b = runs[mode]["port"], runs[mode]["scan"]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_trajectory_and_metrics_lines(runs, seq, tmp_path):
    """The trajectory holds frames 1..N-1; the metrics file's rows equal
    those the JAX package's writer makes of the same outputs."""
    s, _ = seq
    traj, outs = runs["odometry"]["traj"], runs["odometry"]["port"]
    np.testing.assert_array_equal(traj.timestamps, s.timestamps[1:])
    np.testing.assert_allclose(traj.positions, outs.pose[:, :3, 3].double().numpy())
    write_metrics_jsonl(tmp_path / "port.jsonl", s.timestamps[1:], outs, extra={"run": "a"})
    jwrite_metrics(tmp_path / "jax.jsonl", s.timestamps[1:],
                   jmono.MonoStepOut(*(np.asarray(x) for x in outs)), extra={"run": "a"})
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()


def test_learned_frontend_mono_on_the_cpu(seq):
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.frontend import detect_kernel, gnn_kernel, refine_kernel, select_kernel
    from forest_slam_tpu_torch.frontend import sinkhorn_kernel
    from forest_slam_tpu_torch.stereo import sparse_kernel

    s, _ = seq
    wrappers = [detect_kernel.detect_pooled, gnn_kernel.gnn_layer, sinkhorn_kernel.sinkhorn_decode,
                select_kernel.nms_block_max, refine_kernel.refine_cost_volume, sparse_kernel.sparse_cost_rows]
    before = [w.launches for w in wrappers]
    fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), 128, device="cpu")
    cfg = tmono.MonoConfig(n_hypotheses=HYP)
    _, outs = tmono.run_mono_vo(s.images_left, s.timestamps, s.rig.left, cfg, frontend=learned_frontend(fe))
    assert [w.launches for w in wrappers] == before
    assert int(outs.ok.sum()) >= 0.8 * (N_FRAMES - 1) and bool(torch.isfinite(outs.pose).all())
    assert (outs.n_matches > 20).all()


def test_cli_mono_on_the_cpu(tmp_path, capsys):
    from forest_slam_tpu.io.tum import read_tum
    from forest_slam_tpu_torch.cli import main

    out, metrics = tmp_path / "est.txt", tmp_path / "m.jsonl"
    assert main(["mono", "--synthetic", "3", "--out", str(out), "--metrics-out", str(metrics), "--device", "cpu"]) == 0
    assert "mono: 2 poses -> " in capsys.readouterr().out
    traj = read_tum(str(out))
    assert len(traj) == 2 and np.isfinite(traj.positions).all()
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["frame"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"frame", "t", "n_matches", "n_inliers", "ok"}
    np.testing.assert_allclose([r["t"] for r in rows], traj.timestamps)
