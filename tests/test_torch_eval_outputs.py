"""The port's ground truth, evaluation outputs and CLI surface against the
JAX package's.

- ``nearest_indices``, ``extract_gt_trajectory`` and ``extract_gt_map`` on a
  bag with ground truth at twice the image rate and lidar scans with NaNs:
  equal to the JAX package's (poses 1e-9, points 1e-6).
- ``eval``: for the same TUM files the JSON of the port's CLI equals the JAX
  CLI's within 1e-9 (Sim(3) and SE(3), with RPE); ``evaluate_ate`` is
  equal.
- ``write_viewer_html`` and ``view``: the embedded data (trajectories,
  points, colours, the refresh header) equal the JAX package's after
  parsing, and the files are the same bytes.
- ``plot`` writes its four PNGs, and ``--debug-matches`` its PNGs (checked
  as written, not pixel by pixel).
- For every subcommand of the JAX CLI's parser, the port's parser has it,
  and every flag with the same ``dest`` and default; ``--device``, and
  ``--trace-out`` of ``stereo`` and ``slam``, are the port's own.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu import cli as jcli
from forest_slam_tpu.eval import association as jassoc
from forest_slam_tpu.eval import groundtruth as jgt
from forest_slam_tpu.eval import metrics as jmetrics
from forest_slam_tpu.eval import viewer as jviewer
from forest_slam_tpu.io import tum as jtum
from forest_slam_tpu_torch import cli
from forest_slam_tpu_torch.eval import association, groundtruth, metrics, viewer
from forest_slam_tpu_torch.io import ply, tum
from forest_slam_tpu_torch.io.rosbag import BagWriter

N = 40


def _run(main, *argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def _poses(n, seed, noise=0.0):
    """A curving path of n poses, 0.5 m a step; ``noise`` m of jitter."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    yaw = np.cumsum(np.full(n, 0.05))
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_euler("y", yaw[:, None]).as_matrix()
    step = np.stack([np.sin(yaw), np.zeros(n), np.cos(yaw)], axis=1) * 0.5
    T[:, :3, 3] = np.cumsum(step, axis=0) + rng.normal(0, noise, (n, 3))
    return T


@pytest.fixture(scope="module")
def gt_bag(tmp_path_factory):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    T = _poses(2 * N, 1)
    path = str(tmp_path_factory.mktemp("bags") / "gt.bag")
    w = BagWriter(path)
    for k in range(2 * N):  # ground truth at 20 Hz, images and scans at 10 Hz
        t = 1.6e9 + 0.05 * k
        q = Rotation.from_matrix(T[k, :3, :3]).as_quat()
        w.write("/gt_poses", "nav_msgs/Odometry", BagWriter.encode_odometry(T[k, :3, 3], q, t + 0.003), t + 0.003)
        if k % 2 == 0:
            img = rng.integers(0, 256, (8, 12), dtype=np.uint8)
            w.write("/dalsa_rgb/left/image_raw", "sensor_msgs/Image", BagWriter.encode_image(img, t, "mono8"), t)
            pts = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
            pts[rng.random(300) < 0.1, 1] = np.nan
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", BagWriter.encode_pointcloud2(pts, t + 0.01),
                    t + 0.01)
    w.close(compression="bz2", chunk_size=50000)
    return path


def test_nearest_indices_match_jax():
    rng = np.random.default_rng(0)
    ref = np.sort(np.concatenate([rng.uniform(0, 10, 50), [3.0, 3.0, 5.5]]))
    query = np.concatenate([rng.uniform(-1, 11, 200), ref[:5], [3.0, (ref[10] + ref[11]) / 2]])
    np.testing.assert_array_equal(association.nearest_indices(query, ref), jassoc.nearest_indices(query, ref))
    assert association.associate is metrics.associate


def test_gt_trajectory_and_map_match_jax(gt_bag, tmp_path):
    got, want = groundtruth.extract_gt_trajectory(gt_bag), jgt.extract_gt_trajectory(gt_bag)
    assert len(got) == N - 1
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    np.testing.assert_allclose(got.positions, want.positions, atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=1e-9, rtol=0)
    eye = groundtruth.extract_gt_trajectory(gt_bag, T_cam_sensor=np.eye(4))
    np.testing.assert_allclose(eye.positions, jgt.extract_gt_trajectory(gt_bag, T_cam_sensor=np.eye(4)).positions,
                               atol=1e-9, rtol=0)
    for stride, voxel in ((10, 0.5), (3, 2.0)):
        cloud, jcloud = (m.extract_gt_map(gt_bag, scan_stride=stride, voxel_size=voxel) for m in (groundtruth, jgt))
        assert cloud.shape == jcloud.shape and cloud.shape[0] > 100 and np.isfinite(cloud).all()
        np.testing.assert_allclose(cloud, jcloud, atol=1e-6, rtol=0)
    # through both CLIs: the same TUM file, the same PLY
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    assert _run(cli.main, "gt-traj", "--bag", gt_bag, "--out", a)[0] == 0
    assert _run(jcli.main, "gt-traj", "--bag", gt_bag, "--out", b)[0] == 0
    assert open(a).read() == open(b).read()
    assert _run(cli.main, "gt-map", "--bag", gt_bag, "--out", a + ".ply", "--scan-stride", "4")[0] == 0
    assert _run(jcli.main, "gt-map", "--bag", gt_bag, "--out", b + ".ply", "--scan-stride", "4")[0] == 0
    assert open(a + ".ply", "rb").read() == open(b + ".ply", "rb").read()


@pytest.fixture(scope="module")
def tum_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    ts = 100.0 + 0.1 * np.arange(N)
    gt, est = str(d / "gt.txt"), str(d / "est.txt")
    tum.write_tum(gt, tum.Trajectory.from_matrices(ts, _poses(N, 2)))
    noisy = _poses(N, 2, noise=0.05)
    noisy[:, :3, 3] *= 1.3  # a scale error, so Sim(3) and SE(3) differ
    tum.write_tum(est, tum.Trajectory.from_matrices(ts[1:] + 0.002, noisy[1:]))
    return est, gt


@pytest.mark.parametrize("flags", [[], ["--no-scale"], ["--rpe", "--rpe-delta", "2.0"],
                                   ["--no-scale", "--rpe", "--rpe-delta", "1.0"]])
def test_eval_json_matches_jax(tum_files, flags):
    est, gt = tum_files
    rc, said = _run(cli.main, "eval", "--est", est, "--gt", gt, *flags)
    jrc, jsaid = _run(jcli.main, "eval", "--est", est, "--gt", gt, *flags)
    got, want = json.loads(said), json.loads(jsaid)
    assert rc == jrc == 0 and got.keys() == want.keys()
    for part in got:
        assert got[part]["n"] == want[part]["n"] > 0
        for k, v in got[part].items():
            assert v == pytest.approx(want[part][k], abs=1e-9, rel=0), (part, k)
    ate = metrics.evaluate_ate(est, gt, with_scale="--no-scale" not in flags)
    assert ate == jmetrics.evaluate_ate(est, gt, with_scale="--no-scale" not in flags)
    assert ate.rmse == pytest.approx(got["ape"]["rmse"], abs=1e-12)


def _payload(path):
    html = open(path).read()
    start = html.index("const PAYLOAD = ") + len("const PAYLOAD = ")
    return json.loads(html[start:html.index(";\nconst canvas")]), html


@pytest.mark.parametrize("colors, refresh", [(None, None), ("u8", 2.0), ("f", 0.5)])
def test_viewer_matches_jax(tmp_path, tum_files, colors, refresh):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 5, (5000, 3)).astype(np.float32)
    cols = {None: None, "u8": rng.integers(0, 256, (5000, 3), dtype=np.uint8),
            "f": rng.random((5000, 3)).astype(np.float32)}[colors]
    est, gt = tum_files
    trajs = {"estimate": tum.read_tum(est), "gt": _poses(N, 3), "second": _poses(N, 4)[:, :3, 3]}
    jtrajs = {"estimate": jtum.read_tum(est), "gt": _poses(N, 3), "second": _poses(N, 4)[:, :3, 3]}
    a, b = str(tmp_path / "a.html"), str(tmp_path / "b.html")
    viewer.write_viewer_html(a, trajs, points=pts, point_colors=cols, max_points=1200, refresh_seconds=refresh)
    jviewer.write_viewer_html(b, jtrajs, points=pts, point_colors=cols, max_points=1200, refresh_seconds=refresh)
    (got, html), (want, jhtml) = _payload(a), _payload(b)
    assert got == want and html == jhtml
    assert [L["name"] for L in got["layers"]] == ["estimate", "gt", "second", "map"]
    assert len(got["layers"][-1]["data"]) == 3 * 1000  # subsampled by a stride of 5
    assert ('http-equiv="refresh"' in html) == (refresh is not None)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_view_command_matches_jax(tmp_path, tum_files):
    est, gt = tum_files
    cloud = str(tmp_path / "map.ply")
    rng = np.random.default_rng(2)
    ply.write_ply(cloud, rng.normal(0, 3, (800, 3)), rng.integers(0, 256, (800, 3), dtype=np.uint8))
    a, b = str(tmp_path / "a.html"), str(tmp_path / "b.html")
    args = ["--traj", est, "--traj", f"noisy={est}", "--gt", gt, "--map", cloud, "--max-points", "500"]
    assert _run(cli.main, "view", *args, "--out", a)[0] == 0
    assert _run(jcli.main, "view", *args, "--out", b)[0] == 0
    assert open(a).read() == open(b).read()
    got, _ = _payload(a)
    assert [L["name"] for L in got["layers"]] == ["estimate", "noisy", "ground truth", "map"]


def test_plot_writes_its_pngs(tmp_path, tum_files):
    pytest.importorskip("matplotlib")
    est, gt = tum_files
    rc, said = _run(cli.main, "plot", "--est", est, "--gt", gt, "--out-dir", str(tmp_path / "p"), "--prefix", "x_")
    assert rc == 0
    for name in ("traj", "ape", "xyz", "speeds"):
        data = open(tmp_path / "p" / f"x_{name}.png", "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 2000
    _, jsaid = _run(jcli.main, "plot", "--est", est, "--gt", gt, "--out-dir", str(tmp_path / "j"))
    stats = json.loads(said[:said.index("}") + 1])
    jstats = json.loads(jsaid[:jsaid.index("}") + 1])
    assert stats == pytest.approx(jstats, abs=1e-9)


@pytest.mark.parametrize("cmd, radius", [("stereo", "4"), ("mono", None)])
def test_debug_matches_writes_pngs(tmp_path, cmd, radius):
    pytest.importorskip("matplotlib")
    d = tmp_path / "dbg"
    extra = ["--match-refine-radius", radius] if radius else []
    rc, said = _run(cli.main, cmd, "--synthetic", "4", "--out", str(tmp_path / "e.txt"), "--debug-matches", str(d),
                    "--compose-mode", "odometry", "--device", "cpu", *extra)
    assert rc == 0
    pngs = sorted(os.listdir(d))
    assert pngs == [f"matches_{i:05d}.png" for i in range(3)]
    assert all(open(d / p, "rb").read(8) == b"\x89PNG\r\n\x1a\n" for p in pngs)
    assert said.count("debug-matches: pair") == 3


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, caught as its main() parses."""
    import argparse

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as e:
        jcli.main(["mono"])
    monkeypatch.undo()
    return e.value.args[0]


def _subcommands(parser):
    import argparse

    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: a.default for a in p._actions if a.dest != "help"} for name, p in sub.choices.items()}


def test_cli_has_every_flag_of_the_jax_cli(monkeypatch):
    want = _subcommands(_jax_parser(monkeypatch))
    got = _subcommands(cli.build_parser())
    assert set(got) == set(want) == {"mono", "stereo", "slam", "gt-traj", "gt-map", "eval", "plot", "view",
                                     "train-frontend", "distill-frontend"}
    for name, flags in want.items():
        for dest, default in flags.items():
            assert dest in got[name], (name, dest)
            assert got[name][dest] == default, (name, dest, got[name][dest], default)
        own = {"device", "trace_out"} if name in ("stereo", "slam") else {"device"}
        assert set(got[name]) - set(flags) <= own, (name, set(got[name]) - set(flags))
    assert "NOT_YET" not in vars(cli)
