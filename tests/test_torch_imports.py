"""Guards of the PyTorch/CUDA port.

- No module of forest_slam_tpu_torch, and not chip_smoke.py, imports jax,
  flax, msgpack, cv2 or the JAX package (checked in a fresh interpreter).
- chip_smoke.py fails, and prints no result line, where there is no CUDA
  card, and where it stands alone in a directory; the distillation entry
  point, ``run_mono_vo``, ``run_stereo_vo``, ``run_slam`` and ``python -m
  forest_slam_tpu_torch.cli mono|stereo|slam`` refuse to run without a card
  unless asked for the CPU; the CLI flags that the port once refused (the
  bag input, --max-frames, --frame-stride, --rectify, the viewer and the
  match plots) work on the CPU.
- The kernel build reports nvcc's own output when nvcc fails, and leaves no
  partial library behind.
"""

import os
import shutil
import subprocess
import sys

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "cv2", "forest_slam_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import forest_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(forest_slam_tpu_torch.__path__, "forest_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 67
    names = out.stdout.splitlines()[1].split()
    for mod in ("frontend.select_kernel", "frontend.attention_kernel", "frontend.learned", "frontend.superglue",
                "frontend.params", "train", "train.losses", "train.data", "train.trainer", "train.__main__",
                "train.distill", "stereo.disparity", "stereo.depth", "stereo.rectify", "geometry.epipolar",
                "geometry.fivepoint", "geometry.triangulation", "pipelines.mono", "utils.metrics", "cli",
                "backend", "backend.mapping", "backend.pose_graph", "backend.ba", "backend.window",
                "backend.loop_closure", "backend.relocalize", "io.ply", "pipelines.slam", "io.lz4f", "io.rosbag",
                "io.calib", "io.dataset", "native", "eval.association", "eval.groundtruth", "eval.viewer",
                "eval.plots", "utils.roofline", "bench", "parallel", "parallel.mesh", "parallel.launch",
                "parallel.dryrun", "pipelines.batch_eval"):
        assert "forest_slam_tpu_torch." + mod in names


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env={**_env(), "PYTHONPATH": ""},
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke test would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_distill_entry_point_needs_a_card_or_the_cpu(tmp_path):
    """``python -m forest_slam_tpu_torch.train.distill`` without ``--device
    cpu`` refuses to run where there is no card, before it reads a teacher."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.train.distill", "--teacher",
                          str(tmp_path / "absent.msgpack"), "--out", str(tmp_path / "out.msgpack"), "--steps", "1"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr and "absent.msgpack" not in out.stderr
    assert not (tmp_path / "out.msgpack").exists()


def test_mono_entry_points_need_a_card_or_the_cpu(tmp_path):
    import numpy as np
    import torch

    from forest_slam_tpu_torch.core.camera import PinholeCamera
    from forest_slam_tpu_torch.pipelines.mono import run_mono_vo

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cam = PinholeCamera.create(np.eye(3), width=8, height=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mono_vo(np.zeros((2, 8, 8), np.float32), [0.0, 0.1], cam)
    out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.cli", "mono", "--synthetic", "3", "--out",
                          str(tmp_path / "est.txt")], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr
    assert not (tmp_path / "est.txt").exists()


def test_stereo_and_slam_entry_points_need_a_card_or_the_cpu(tmp_path):
    import numpy as np
    import torch

    from forest_slam_tpu_torch.io.synthetic import default_rig
    from forest_slam_tpu_torch.pipelines.slam import run_slam
    from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rig = default_rig(8, 8, device="cpu")
    img = np.zeros((2, 8, 8), np.float32)
    for run in (run_stereo_vo, run_slam):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(img, img, [0.0, 0.1], rig)
    for cmd in ("stereo", "slam"):
        out = subprocess.run([sys.executable, "-m", "forest_slam_tpu_torch.cli", cmd, "--synthetic", "3", "--out",
                              str(tmp_path / "est.txt")], cwd=ROOT, env=_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and "--device cpu" in out.stderr
    assert not (tmp_path / "est.txt").exists()


@pytest.fixture(scope="module")
def small_bag(tmp_path_factory):
    """A 6-frame bgr8 stereo bag of 120x192 noise frames with ground truth,
    and the BotanicGarden rig at a fifth of its size for the CLI to read it
    with (the CLI's own rig is 600x960)."""
    import numpy as np
    import torch

    from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
    from forest_slam_tpu_torch.io import calib
    from forest_slam_tpu_torch.io.synthetic import write_stereo_bag

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 6, 120, 192)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("bag") / "small.bag")
    write_stereo_bag(path, frames[0], frames[1], 1.6e9 + 0.1 * np.arange(6), np.tile(np.eye(4), (6, 1, 1)))
    s = np.diag([0.2, 0.2, 1.0])
    cam = lambda K, d: PinholeCamera.create(s @ K, d, 192, 120, device="cpu")  # noqa: E731
    rig = StereoRig(cam(calib.BOTANIC_K_LEFT, calib.BOTANIC_DIST_LEFT), cam(calib.BOTANIC_K_RIGHT,
                                                                           calib.BOTANIC_DIST_RIGHT),
                    torch.as_tensor(calib.BOTANIC_T_LEFT_RIGHT, dtype=torch.float32))
    return path, rig


def _small_rig(monkeypatch, rig):
    """The small rig in place of the CLI's; returns the list that records
    each viewer write's refresh_seconds."""
    from forest_slam_tpu_torch.eval import viewer
    from forest_slam_tpu_torch.io import calib

    monkeypatch.setattr(calib, "botanic_garden_rig", lambda device="cuda": rig)
    monkeypatch.setattr(calib, "botanic_garden_left", lambda device="cuda": rig.left)
    writes, write = [], viewer.write_viewer_html

    def recorded(*a, **k):
        writes.append(k.get("refresh_seconds"))
        write(*a, **k)

    monkeypatch.setattr(viewer, "write_viewer_html", recorded)
    return writes


def _check_output(tmp_path, flags, said, n_poses, writes):
    from forest_slam_tpu_torch.io.tum import read_tum

    assert len(read_tum(str(tmp_path / "est.txt"))) == n_poses
    if "--viewer-out" in flags:
        html = open(tmp_path / "v.html").read()
        assert "const PAYLOAD" in html and "viewer ->" in said
        # follow mode rewrites the viewer with a refresh header after each chunk (stereo's streaming runner), then
        # writes the final one without it
        live = "--viewer-follow" in flags and "stereo: " in said
        assert writes == ([2.0] if live else []) + [None] and 'http-equiv="refresh"' not in html
    if "--debug-matches" in flags:
        pngs = os.listdir(tmp_path / "d")
        assert pngs and all(p.endswith(".png") for p in pngs)


@pytest.mark.parametrize("flags, n_poses", [(["--bag", "BAG"], 5), (["--bag", "BAG", "--max-frames", "2"], 1),
                                            (["--bag", "BAG", "--frame-stride", "2"], 2),
                                            (["--synthetic", "3", "--viewer-out", "v.html"], 2),
                                            (["--synthetic", "3", "--debug-matches", "d"], 2)])
def test_cli_refuses_flags_not_ported(tmp_path, capsys, monkeypatch, small_bag, flags, n_poses):
    """Each flag the port once refused now works on the CPU: the bag input
    (with --max-frames and --frame-stride), the viewer and the match plots."""
    from forest_slam_tpu_torch.cli import main

    if "--debug-matches" in flags:
        pytest.importorskip("matplotlib")
    writes = _small_rig(monkeypatch, small_bag[1])
    flags = [small_bag[0] if f == "BAG" else str(tmp_path / f) if f in ("v.html", "d") else f for f in flags]
    assert main(["mono", *flags, "--out", str(tmp_path / "est.txt"), "--device", "cpu", "--compose-mode",
                 "odometry"]) == 0
    said = capsys.readouterr().out
    assert ("native reader" in said) == ("--bag" in flags)
    _check_output(tmp_path, flags, said, n_poses, writes)


@pytest.mark.parametrize("cmd, flags, n_poses", [("stereo", ["--bag", "BAG"], 5),
                                                 ("stereo", ["--bag", "BAG", "--rectify"], 5),
                                                 ("stereo", ["--synthetic", "3", "--viewer-out", "v.html",
                                                             "--viewer-follow"], 2),
                                                 ("slam", ["--synthetic", "3", "--debug-matches", "d"], 2),
                                                 ("slam", ["--synthetic", "3", "--viewer-out", "v.html",
                                                           "--viewer-follow"], 2)])
def test_stereo_and_slam_cli_refuse_flags_not_ported(tmp_path, capsys, monkeypatch, small_bag, cmd, flags, n_poses):
    """Each flag the port once refused now works on the CPU: the bag input,
    --rectify, the viewer in follow mode (stereo's streaming runner; slam
    writes the viewer once, as the JAX CLI does) and the match plots."""
    from forest_slam_tpu_torch.cli import main

    if "--debug-matches" in flags:
        pytest.importorskip("matplotlib")
    writes = _small_rig(monkeypatch, small_bag[1])
    flags = [small_bag[0] if f == "BAG" else str(tmp_path / f) if f in ("v.html", "d") else f for f in flags]
    assert main([cmd, *flags, "--out", str(tmp_path / "est.txt"), "--device", "cpu", "--compose-mode",
                 "odometry"]) == 0
    said = capsys.readouterr().out
    assert f"{cmd}: {n_poses} poses" in said
    _check_output(tmp_path, flags, said, n_poses, writes)


def test_build_failure_reports_nvcc_output(tmp_path, monkeypatch):
    from forest_slam_tpu_torch import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: simulated compiler failure' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="simulated compiler failure"):
        _build.build()
    assert os.listdir(tmp_path / "build") == []


def test_library_name_follows_sources_and_flags(monkeypatch, tmp_path):
    from forest_slam_tpu_torch import _build

    a = _build.library_path()
    assert a == _build.library_path()
    assert [os.path.basename(p) for p in _build.sources()] == [
        "attention.cu", "detect.cu", "gnn_layer.cu", "pnp_refine.cu", "refine_cost.cu", "select.cu", "sinkhorn.cu",
        "sparse_cost.cu"]
    assert [os.path.basename(p) for p in _build.headers()] == ["attention_core.cuh", "cp_async.cuh", "device_setup.cuh"]
    # an edit to a shared header names a new library
    header = tmp_path / "attention_core.cuh"
    header.write_bytes(open(_build.headers()[0], "rb").read() + b"// edited\n")
    with monkeypatch.context() as m:
        m.setattr(_build, "headers", lambda: [str(header)])
        assert _build.library_path() != a
    assert _build.library_path() == a
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DEXTRA",))
    assert _build.library_path() != a
