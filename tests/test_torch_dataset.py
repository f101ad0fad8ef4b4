"""The port's bag loader (io/dataset.py) and calibration (io/calib.py) against
the JAX package's, and the CLI's ``stereo --bag`` end to end on the CPU.

- ``load_stereo_from_bag`` and ``load_mono_from_bag`` on mono8 and bgr8 bags
  of 120x192 frames drawn from a seeded numpy generator, with the
  BotanicGarden rig at a fifth of its size (K scaled; its real distortion
  and extrinsic) and with the full-size rig (600x960 output), with
  ``max_frames`` and
  ``frame_stride``: the port's float32 stacks (device cpu) within 1e-4 of
  the JAX package's, the timestamps equal. The JAX side reads with its
  Python parser (its native reader builds next to its own source, which
  these tests leave alone); on a lockstep bag that is the native path's
  result, which the port's native reader is also held to.
- The two pairing rules on a stream that is not lockstep: the native path
  pairs the i-th left with the i-th right message, the Python path each
  right with the left before it (as the JAX package's).
- ``preprocess_frames`` gives the undistorted frame back from a frame
  distorted by ``io/synthetic.py:distort_view`` (a smooth image, away from
  the border where a resampling reads outside the frame).
- The CLI's ``stereo --bag --frontend orb --compose-mode odometry --device
  cpu`` on an 8-frame 120x192 bag rendered by the port's io/synthetic.py at
  the scaled BotanicGarden rig and distorted by it, with ``gt-traj`` and
  ``eval`` from the same bag: every pair tracked and SE(3) ATE below 0.5 m
  (tests/test_cli_and_dataset.py's rules).
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu import native as jnative
from forest_slam_tpu.core.camera import PinholeCamera as JCam
from forest_slam_tpu.core.camera import StereoRig as JRig
from forest_slam_tpu.io import calib as jcalib
from forest_slam_tpu.io import dataset as jdataset
from forest_slam_tpu_torch import native
from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
from forest_slam_tpu_torch.io import calib, dataset
from forest_slam_tpu_torch.io.rosbag import BagWriter
from forest_slam_tpu_torch.io.synthetic import distort_view, write_stereo_bag

H, W = 120, 192  # the BotanicGarden rig's 600x960 at a fifth
N = 10
LEFT, RIGHT = dataset.LEFT_TOPIC, dataset.RIGHT_TOPIC


def small_rigs():
    """The BotanicGarden rig at a fifth of its size (K scaled; the real
    distortion and extrinsic) for both packages."""
    s = np.diag([W / calib.BOTANIC_WIDTH, H / calib.BOTANIC_HEIGHT, 1.0])
    kl, kr = s @ calib.BOTANIC_K_LEFT, s @ calib.BOTANIC_K_RIGHT
    port = StereoRig(PinholeCamera.create(kl, calib.BOTANIC_DIST_LEFT, W, H, device="cpu"),
                     PinholeCamera.create(kr, calib.BOTANIC_DIST_RIGHT, W, H, device="cpu"),
                     torch.as_tensor(calib.BOTANIC_T_LEFT_RIGHT, dtype=torch.float32))
    jax_rig = JRig(JCam.create(kl, calib.BOTANIC_DIST_LEFT, W, H), JCam.create(kr, calib.BOTANIC_DIST_RIGHT, W, H),
                   jnp.asarray(calib.BOTANIC_T_LEFT_RIGHT, jnp.float32))
    return port, jax_rig


def write_bag(path, encoding, n=N, seed=0, compression="none"):
    rng = np.random.default_rng(seed)
    shape = (n, H, W, 3) if encoding == "bgr8" else (n, H, W)
    left, right = rng.integers(0, 256, shape, dtype=np.uint8), rng.integers(0, 256, shape, dtype=np.uint8)
    w = BagWriter(str(path))
    for i in range(n):
        t = 1.6e9 + 0.1 * i
        w.write(LEFT, "sensor_msgs/Image", BagWriter.encode_image(left[i], t, encoding), t)
        w.write(RIGHT, "sensor_msgs/Image", BagWriter.encode_image(right[i], t, encoding), t)
    w.close(compression=compression)
    return str(path), left, right


@pytest.fixture(autouse=True)
def jax_python_reader(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def test_calibration_matches_jax():
    for name in ("BOTANIC_K_LEFT", "BOTANIC_K_RIGHT", "BOTANIC_DIST_LEFT", "BOTANIC_DIST_RIGHT",
                 "BOTANIC_T_LEFT_RIGHT", "BOTANIC_T_RGB0_VLP16"):
        np.testing.assert_array_equal(getattr(calib, name), getattr(jcalib, name))
    rig, jrig = calib.botanic_garden_rig("cpu"), jcalib.botanic_garden_rig()
    for a, b in ((rig.left, jrig.left), (rig.right, jrig.right)):
        np.testing.assert_array_equal(a.K.numpy(), np.asarray(b.K))
        np.testing.assert_array_equal(a.dist.numpy(), np.asarray(b.dist))
        assert (a.width, a.height) == (b.width, b.height) == (960, 600)
    np.testing.assert_array_equal(rig.T_left_right.numpy(), np.asarray(jrig.T_left_right))


@pytest.mark.parametrize("encoding, max_frames, stride", [("bgr8", None, 1), ("mono8", 4, 2), ("bgr8", 3, 3),
                                                          ("mono8", None, 4)])
def test_stereo_loader_matches_jax(tmp_path, encoding, max_frames, stride):
    path, left, _ = write_bag(tmp_path / "s.bag", encoding)
    rig, jrig = small_rigs()
    got = dataset.load_stereo_from_bag(path, rig, max_frames=max_frames, frame_stride=stride, device="cpu")
    want = jdataset.load_stereo_from_bag(path, jrig, max_frames=max_frames, frame_stride=stride)
    assert got.reader == "native"
    n = len(range(0, N, stride)[:max_frames])
    assert got.images_left.shape == (n, H, W) and got.images_left.dtype == torch.float32
    assert got.images_left.device.type == "cpu"
    np.testing.assert_allclose(got.images_left.numpy(), np.asarray(want.images_left), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.images_right.numpy(), np.asarray(want.images_right), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    # the Python parser on the same lockstep bag gives the same
    py = dataset.read_stereo_python(path, LEFT, RIGHT, max_frames, stride)
    lefts, _, times, reader = dataset.read_stereo(path, max_frames=max_frames, frame_stride=stride)
    assert reader == "native"
    np.testing.assert_array_equal(lefts, py[0])
    np.testing.assert_array_equal(lefts, left[::stride][:max_frames])
    np.testing.assert_array_equal(times, py[2])


@pytest.mark.parametrize("encoding", ["bgr8", "mono8"])
def test_mono_loader_matches_jax(tmp_path, encoding):
    path, left, _ = write_bag(tmp_path / "m.bag", encoding, compression="bz2")
    rig, jrig = small_rigs()
    got = dataset.load_mono_from_bag(path, rig.left, max_frames=4, frame_stride=2, device="cpu")
    want = jdataset.load_mono_from_bag(path, jrig.left, max_frames=4, frame_stride=2)
    assert got.reader == "native" and got.images.shape == (4, H, W)
    np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)


def test_full_size_rig_and_python_reader_match_jax(tmp_path, monkeypatch):
    """The full-size BotanicGarden rig (600x960 output) on 120x192 frames, on
    an lz4 bag that only the Python parser reads, and with the native reader
    switched off on a plain one."""
    rig, jrig = calib.botanic_garden_rig("cpu"), jcalib.botanic_garden_rig()
    path, _, _ = write_bag(tmp_path / "l.bag", "bgr8", n=3, compression="lz4")
    got = dataset.load_stereo_from_bag(path, rig, device="cpu")
    want = jdataset.load_stereo_from_bag(path, jrig)
    assert got.reader == "python" and got.images_left.shape == (3, 600, 960)
    np.testing.assert_allclose(got.images_left.numpy(), np.asarray(want.images_left), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.images_right.numpy(), np.asarray(want.images_right), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    plain, _, _ = write_bag(tmp_path / "p.bag", "mono8", n=6)
    small, _ = small_rigs()
    nat = dataset.load_stereo_from_bag(plain, small, frame_stride=2, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    py = dataset.load_stereo_from_bag(plain, small, frame_stride=2, device="cpu")
    assert (nat.reader, py.reader) == ("native", "python")
    torch.testing.assert_close(nat.images_left, py.images_left, rtol=0, atol=0)
    torch.testing.assert_close(nat.images_right, py.images_right, rtol=0, atol=0)
    np.testing.assert_array_equal(nat.timestamps, py.timestamps)


def test_pairing_rules_off_lockstep(tmp_path):
    """Left frames 0, 1, 2, right 0, left 3, right 1, 2, 3: the native path
    pairs by index on each topic, the Python path each right with the left
    before it (left 2 with right 0, left 3 with right 1)."""
    rng = np.random.default_rng(3)
    left, right = rng.integers(0, 256, (4, H, W), dtype=np.uint8), rng.integers(0, 256, (4, H, W), dtype=np.uint8)
    order = [(LEFT, 0), (LEFT, 1), (LEFT, 2), (RIGHT, 0), (LEFT, 3), (RIGHT, 1), (RIGHT, 2), (RIGHT, 3)]
    path = str(tmp_path / "o.bag")
    w = BagWriter(path)
    for k, (topic, i) in enumerate(order):
        img = (left if topic == LEFT else right)[i]
        w.write(topic, "sensor_msgs/Image", BagWriter.encode_image(img, 10.0 + i, "mono8"), 10.0 + 0.01 * k)
    w.close()
    lefts, rights, times, reader = dataset.read_stereo(path)
    assert reader == "native"
    np.testing.assert_array_equal(lefts, left)
    np.testing.assert_array_equal(rights, right)
    np.testing.assert_array_equal(times, 10.0 + np.arange(4))
    pl, pr, pt = dataset.read_stereo_python(path, LEFT, RIGHT, None, 1)
    np.testing.assert_array_equal(pl, left[[2, 3]])
    np.testing.assert_array_equal(pr, right[[0, 1]])
    np.testing.assert_array_equal(pt, [12.0, 13.0])
    rig, jrig = small_rigs()
    got = dataset.load_stereo_from_bag(path, rig, device="cpu")
    want = jdataset.load_stereo_from_bag(path, jrig)  # the JAX package's Python path
    assert got.images_left.shape[0] == 4 and np.asarray(want.images_left).shape[0] == 2


def test_preprocess_undoes_the_distortion():
    cam = calib.botanic_garden_left("cpu")
    gy, gx = torch.meshgrid(torch.arange(600.0), torch.arange(960.0), indexing="ij")
    img = 128.0 + 100.0 * torch.sin(gx / 37.0) * torch.cos(gy / 23.0)
    distorted = distort_view(img, cam)
    bgr = np.repeat(distorted.numpy()[None, :, :, None], 3, axis=3)
    back = dataset.preprocess_frames(bgr, cam, device="cpu")[0]
    assert not torch.allclose(distorted, img, atol=1.0)  # the distortion moves pixels (up to 7.5 px)
    err = (back - img).abs()[10:-10, 10:-10]
    assert err.max().item() < 0.5, err.max().item()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dataset.preprocess_frames(bgr, cam, device="cuda")


def _cli(*argv):
    from forest_slam_tpu_torch.cli import main

    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def test_cli_stereo_bag_end_to_end(tmp_path, monkeypatch):
    from forest_slam_tpu_torch.core.lie import se3_compose
    from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, make_corridor_world, render_view

    rig, _ = small_rigs()
    monkeypatch.setattr(calib, "botanic_garden_rig", lambda device="cuda": rig)
    world = make_corridor_world(seed=21, device="cpu")
    Ts = corridor_trajectory(8, speed=0.3, device="cpu")
    il = distort_view(render_view(world, Ts, rig.left.K, H, W)[0], rig.left)
    ir = distort_view(render_view(world, se3_compose(Ts, rig.T_left_right), rig.right.K, H, W)[0], rig.right)
    bag = str(tmp_path / "mini.bag")
    write_stereo_bag(bag, il, ir, 1.6e9 + 0.1 * np.arange(8), Ts, calib.BOTANIC_T_RGB0_VLP16)
    est, gt = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    rc, said = _cli("stereo", "--bag", bag, "--frontend", "orb", "--device", "cpu", "--compose-mode", "odometry",
                    "--out", est)
    assert rc == 0 and "native reader" in said and "stereo: 7 poses" in said, said
    tracked, pairs = (int(x) for x in said.split("tracked ")[1].split(")")[0].split("/"))
    assert tracked == pairs == 7
    assert _cli("gt-traj", "--bag", bag, "--out", gt)[0] == 0
    rc, said = _cli("eval", "--est", est, "--gt", gt, "--no-scale")
    ape = json.loads(said)["ape"]
    assert rc == 0 and ape["n"] == 7 and ape["rmse"] < 0.5, ape
