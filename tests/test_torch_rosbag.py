"""The port's bag I/O against the JAX package's: io/rosbag.py, io/lz4f.py and
the native reader.

- Writers: for plain, bz2 (several chunks) and lz4 chunks, the bags the
  port's ``BagWriter`` and the JAX package's write from the same messages
  are byte-equal.
- Readers: each package's ``BagReader`` reads the other's bag to equal
  messages: image arrays (mono8, bgr8, rgb8, mono16, a padded row step),
  stamps, PoseStamped, Odometry and point clouds with and without NaNs.
- Codec: the port's lz4f round-trips, rejects garbage, decodes the
  checked-in liblz4 frame (tests/fixtures/linked_bc.lz4) and, where
  liblz4 loads, interoperates with it both ways (as tests/test_lz4_interop.py
  does for the JAX copy).
- Native reader: built from the port's source into
  ``forest_slam_tpu_torch/_build/``, equal to the Python parser with a
  stride and a cap, and refusing an lz4 bag (which the Python parser reads).
"""

import os
import shutil
import struct

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from forest_slam_tpu.io import lz4f as jlz4f
from forest_slam_tpu.io import rosbag as jbag
from forest_slam_tpu_torch.io import lz4f
from forest_slam_tpu_torch.io import rosbag as tbag
from test_lz4_interop import FIXTURE, PAYLOAD, _load_liblz4, _real_lz4_frame

N = 12
H, W = 24, 32


def _messages(seed=0):
    """(topic, type, payload, t) of a small bag: stereo images in four
    encodings, odometry, a PoseStamped, point clouds with and without
    NaNs, and one unknown type."""
    rng = np.random.default_rng(seed)
    enc = tbag.BagWriter
    out = []
    for i in range(N):
        t = 100.0 + 0.1 * i
        out.append(("/left/image_raw", "sensor_msgs/Image",
                    enc.encode_image(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), t, "bgr8"), t))
        out.append(("/right/image_raw", "sensor_msgs/Image",
                    enc.encode_image(rng.integers(0, 256, (H, W), dtype=np.uint8), t, "mono8"), t))
        pos, quat = rng.normal(size=3), rng.normal(size=4)
        out.append(("/gt_poses", "nav_msgs/Odometry", enc.encode_odometry(pos, quat / np.linalg.norm(quat), t), t))
        pts = rng.normal(0, 5, (50 + i, 3)).astype(np.float32)
        if i % 2:
            pts[::7, i % 3] = np.nan
        out.append(("/velodyne_points", "sensor_msgs/PointCloud2", enc.encode_pointcloud2(pts, t), t))
    # a PoseStamped, an rgb8 frame, a mono16 frame and an image whose row step is padded
    ps = struct.pack("<I", 3) + tbag._ros_time(5.25) + struct.pack("<I", 3) + b"map" + struct.pack("<7d", *range(7))
    out.append(("/pose", "geometry_msgs/PoseStamped", ps, 5.25))
    out.append(("/rgb", "sensor_msgs/Image", enc.encode_image(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), 6.0,
                                                              "rgb8"), 6.0))
    m16 = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    img16 = (struct.pack("<I", 0) + tbag._ros_time(6.5) + struct.pack("<I", 1) + b"c" + struct.pack("<II", H, W)
             + struct.pack("<I", 6) + b"mono16" + struct.pack("<B", 0) + struct.pack("<I", 2 * W)
             + struct.pack("<I", m16.nbytes) + m16.tobytes())
    out.append(("/depth", "sensor_msgs/Image", img16, 6.5))
    step = W + 8
    padded = rng.integers(0, 256, (H, step), dtype=np.uint8)
    imgp = (struct.pack("<I", 0) + tbag._ros_time(7.0) + struct.pack("<I", 1) + b"c" + struct.pack("<II", H, W)
            + struct.pack("<I", 5) + b"mono8" + struct.pack("<B", 0) + struct.pack("<I", step)
            + struct.pack("<I", padded.nbytes) + padded.tobytes())
    out.append(("/padded", "sensor_msgs/Image", imgp, 7.0))
    out.append(("/blob", "std_msgs/String", b"\x05\x00\x00\x00hello", 8.0))
    return out


def _write(module, path, messages, compression, chunk_size):
    w = module.BagWriter(str(path))
    for m in messages:
        w.write(*m)
    w.close(compression=compression, chunk_size=chunk_size)
    return str(path)


CASES = [("none", 0), ("bz2", 4096), ("lz4", 0), ("lz4", 3000)]


@pytest.mark.parametrize("compression, chunk_size", CASES)
def test_writers_are_byte_equal(tmp_path, compression, chunk_size):
    msgs = _messages()
    a = _write(tbag, tmp_path / "port.bag", msgs, compression, chunk_size)
    b = _write(jbag, tmp_path / "jax.bag", msgs, compression, chunk_size)
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    if chunk_size:
        assert data.count(b"op=\x05") > 2  # several CHUNK records


def _equal_message(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, bytes):
        assert a == b
        return
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, w)
        else:
            assert v == w, k
    if type(a).__name__ == "ImageMessage":
        np.testing.assert_array_equal(a.to_array(), b.to_array())
    if type(a).__name__ == "PointCloud2Message":
        for skip in (True, False):
            np.testing.assert_array_equal(a.xyz(skip_nans=skip), b.xyz(skip_nans=skip))


@pytest.mark.parametrize("compression, chunk_size", CASES[:3])
def test_each_reader_reads_the_others_bag(tmp_path, compression, chunk_size):
    msgs = _messages(1)
    for writer, reader in ((tbag, jbag), (jbag, tbag)):
        path = _write(writer, tmp_path / f"{writer.__name__}.bag", msgs, compression, chunk_size)
        got = list(reader.BagReader(path).read_messages())
        want = list(writer.BagReader(path).read_messages())
        assert len(got) == len(want) == len(msgs)
        for (ta, ma, sa), (tb, mb, sb), m in zip(got, want, msgs):
            assert ta == tb == m[0] and sa == sb
            _equal_message(ma, mb)
    # decoded content against what was written
    rd = {topic: msg for topic, msg, _ in tbag.BagReader(path).read_messages(["/depth", "/padded", "/pose", "/blob"])}
    assert rd["/depth"].to_array().dtype == np.uint16 and rd["/depth"].to_array().shape == (H, W)
    assert rd["/padded"].to_array().shape == (H, W)
    np.testing.assert_array_equal(rd["/pose"].position, [0.0, 1.0, 2.0])
    assert rd["/pose"].stamp == 5.25 and rd["/pose"].frame_id == "map"
    assert rd["/blob"] == b"\x05\x00\x00\x00hello"


def test_reader_topic_filter_and_errors(tmp_path):
    path = _write(tbag, tmp_path / "b.bag", _messages(2), "bz2", 0)
    clouds = list(tbag.BagReader(path).read_messages(["/velodyne_points"]))
    assert len(clouds) == N and all(tp == "/velodyne_points" for tp, _, _ in clouds)
    assert np.isnan(clouds[1][1].xyz(skip_nans=False)).any() and not np.isnan(clouds[1][1].xyz()).any()
    raw = list(tbag.BagReader(path).read_messages(["/gt_poses"], decode=False))
    assert isinstance(raw[0][1], bytes)
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"not a bag at all")
    with pytest.raises(ValueError, match="ROSBAG"):
        list(tbag.BagReader(str(bad)).read_messages())


def test_lz4_round_trips_and_rejects_garbage():
    rng = np.random.default_rng(0)
    for data in (b"", b"a", PAYLOAD[:1000], PAYLOAD, rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
                 bytes(200000)):
        frame = lz4f.compress(data, block_size=65536)
        assert frame == jlz4f.compress(data, block_size=65536)
        assert lz4f.decompress(frame) == data == jlz4f.decompress(frame)
    for garbage in (b"", b"\x00" * 16, b"\x04\x22\x4d\x18\x00\x70\x00", lz4f.compress(PAYLOAD)[:-9]):
        with pytest.raises(ValueError):
            lz4f.decompress(garbage)
    assert lz4f._xxh32(PAYLOAD) == jlz4f._xxh32(PAYLOAD)
    assert lz4f._xxh32(b"", 7) == jlz4f._xxh32(b"", 7)


def test_lz4_decodes_the_liblz4_fixture():
    frame = open(FIXTURE, "rb").read()
    assert (frame[4] >> 5) & 1 == 0 and (frame[4] >> 4) & 1 == 1  # linked blocks, block checksums
    assert lz4f.decompress(frame) == PAYLOAD
    bad = bytearray(frame)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError):
        lz4f.decompress(bytes(bad))


@pytest.mark.parametrize("linked, block_checksum, content_checksum, content_size",
                         [(True, True, True, True), (False, False, True, False), (False, True, False, True)])
def test_lz4_reads_liblz4_frames(linked, block_checksum, content_checksum, content_size):
    frame = _real_lz4_frame(PAYLOAD, linked=linked, block_checksum=block_checksum,
                            content_checksum=content_checksum, content_size=content_size)
    assert lz4f.decompress(frame) == PAYLOAD


def test_liblz4_reads_our_frames():
    import ctypes

    lib = _load_liblz4()
    if lib is None:
        pytest.skip("liblz4 shared library not available")
    data = PAYLOAD[: 256 * 1024]
    frame = lz4f.compress(data)
    lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_decompress.restype = ctypes.c_size_t
    lib.LZ4F_isError.restype = ctypes.c_uint
    ctx = ctypes.c_void_p()
    assert not lib.LZ4F_isError(lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), ctypes.c_uint(100)))
    src = ctypes.create_string_buffer(frame, len(frame))
    dst = ctypes.create_string_buffer(1 << 20)
    out, off = bytearray(), 0
    while off < len(frame):
        src_sz, dst_sz = ctypes.c_size_t(len(frame) - off), ctypes.c_size_t(1 << 20)
        r = lib.LZ4F_decompress(ctx, dst, ctypes.byref(dst_sz), ctypes.byref(src, off), ctypes.byref(src_sz), None)
        assert not lib.LZ4F_isError(ctypes.c_size_t(r))
        out += dst.raw[:dst_sz.value]
        off += src_sz.value
        if r == 0:
            break
    lib.LZ4F_freeDecompressionContext(ctx)
    assert bytes(out) == data


# --- the native reader -----------------------------------------------------------

@pytest.fixture(scope="module")
def stereo_bag(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native reader cannot be built")
    rng = np.random.default_rng(0)
    imgs_l = rng.integers(0, 255, (12, 48, 64, 3), dtype=np.uint8)
    imgs_r = rng.integers(0, 255, (12, 48, 64), dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("bags") / "stereo.bag")
    w = tbag.BagWriter(path)
    for i in range(12):
        t = 100.0 + i * 0.1
        w.write("/left/image_raw", "sensor_msgs/Image", tbag.BagWriter.encode_image(imgs_l[i], t, "bgr8"), t)
        w.write("/right/image_raw", "sensor_msgs/Image", tbag.BagWriter.encode_image(imgs_r[i], t, "mono8"), t)
    w.close(compression="bz2", chunk_size=20000)
    return path, imgs_l, imgs_r


def test_native_reader_builds_into_the_build_dir(stereo_bag):
    from forest_slam_tpu_torch import _build, native

    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("librosbag_reader_")
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


def test_native_matches_python_parser(stereo_bag):
    from forest_slam_tpu_torch import native

    path, imgs_l, imgs_r = stereo_bag
    for topic, imgs, enc in (("/left/image_raw", imgs_l, "bgr8"), ("/right/image_raw", imgs_r, "mono8")):
        out, stamps, got_enc = native.read_image_topic(path, topic)
        assert got_enc == enc
        np.testing.assert_array_equal(out, imgs)
        py = [(msg.to_array(), msg.stamp) for _, msg, _ in tbag.BagReader(path).read_messages([topic])]
        np.testing.assert_array_equal(out, np.stack([a for a, _ in py]))
        np.testing.assert_array_equal(stamps, [s for _, s in py])


@pytest.mark.parametrize("max_frames, stride", [(4, 3), (None, 2), (100, 5), (1, 1)])
def test_native_stride_and_cap(stereo_bag, max_frames, stride):
    from forest_slam_tpu_torch import native

    path, imgs_l, _ = stereo_bag
    out, stamps, _ = native.read_image_topic(path, "/left/image_raw", max_frames=max_frames, stride=stride)
    want = imgs_l[::stride][:max_frames]
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(stamps, (100.0 + np.arange(12) * 0.1)[::stride][:max_frames], rtol=0, atol=1e-9)


def test_native_refuses_lz4_and_missing_topics(stereo_bag, tmp_path):
    from forest_slam_tpu_torch import native

    path = _write(tbag, tmp_path / "l.bag", _messages(3), "lz4", 0)
    with pytest.raises(RuntimeError, match="parse"):
        native.read_image_topic(path, "/left/image_raw")
    with pytest.raises(RuntimeError, match="no Image"):
        native.read_image_topic(stereo_bag[0], "/absent")
