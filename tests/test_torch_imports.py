"""Guards of the PyTorch/CUDA port.

- No module of forest_slam_tpu_torch, and not chip_smoke.py, imports jax,
  flax, msgpack, cv2 or the JAX package (checked in a fresh interpreter).
- chip_smoke.py fails, and prints no result line, where there is no CUDA
  card, and where it stands alone in a directory; the distillation entry
  point, ``run_mono_vo`` and ``python -m forest_slam_tpu_torch.cli mono``
  refuse to run without a card unless asked for the CPU; the CLI refuses
  the flags the port does not take yet, naming the roadmap item.
- The kernel build reports nvcc's own output when nvcc fails, and leaves no
  partial library behind.
"""

import os
import shutil
import subprocess
import sys

import pytest

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
    assert n_modules >= 53
    names = out.stdout.splitlines()[1].split()
    for mod in ("frontend.select_kernel", "frontend.attention_kernel", "frontend.learned", "frontend.superglue",
                "frontend.params", "train", "train.losses", "train.data", "train.trainer", "train.__main__",
                "train.distill", "stereo.disparity", "stereo.depth", "stereo.rectify", "geometry.epipolar",
                "geometry.fivepoint", "geometry.triangulation", "pipelines.mono", "utils.metrics", "cli"):
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


@pytest.mark.parametrize("flags", [["--bag", "a.bag"], ["--synthetic", "3", "--max-frames", "2"],
                                   ["--synthetic", "3", "--frame-stride", "2"],
                                   ["--synthetic", "3", "--viewer-out", "v.html"],
                                   ["--synthetic", "3", "--debug-matches", "d"]])
def test_cli_refuses_flags_not_ported(tmp_path, capsys, flags):
    from forest_slam_tpu_torch.cli import main

    assert main(["mono", *flags, "--out", str(tmp_path / "est.txt"), "--device", "cpu"]) == 2
    assert "Queue A item 9" in capsys.readouterr().err
    assert not (tmp_path / "est.txt").exists()


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
    assert len(_build.sources()) == 7
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
