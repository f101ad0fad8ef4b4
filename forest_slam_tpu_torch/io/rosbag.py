"""ROS1 bag (format 2.0) reader and writer, dependency-free (the port's
copy of io/rosbag.py).

A direct parser of the on-disk format (http://wiki.ros.org/Bags/Format/2.0)
in place of ``rosbag.Bag(...).read_messages(topics=[...])`` (the
reference's stereo_slam.py:35,177), with no ROS installation:

- record grammar: <header_len><header fields name=value><data_len><data>;
- CHUNK records carry the message stream, plain, bz2 or lz4
  (io/lz4f.py);
- CONNECTION records map ``conn`` ids to topics and types;
- messages are ROS1-serialised structs, with typed decoders for the types
  the reference reads: ``sensor_msgs/Image`` (the stereo streams),
  ``sensor_msgs/PointCloud2`` (/velodyne_points) and
  ``geometry_msgs/PoseStamped`` / ``nav_msgs/Odometry`` (/gt_poses).

``ImageMessage.to_array`` decodes encodings as the JAX package does:
``rgb8`` is returned as stored (not swapped to BGR, so the BGR luma weights
of the gray conversion fall on the wrong channels) and ``bayer_*`` as one
raw channel (not demosaiced).

A matching minimal writer makes valid bags for tests and the smoke run.
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_BAG_HEADER = 0x03
OP_CHUNK = 0x05
OP_CONNECTION = 0x07
OP_MSG_DATA = 0x02
OP_INDEX_DATA = 0x04
OP_CHUNK_INFO = 0x06


# --------------------------------------------------------------------------
# Record-level primitives
# --------------------------------------------------------------------------


def _read_header(buf: bytes) -> dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


def _write_header(fields: dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        field = k.encode() + b"=" + v
        out += struct.pack("<I", len(field)) + field
    return out


def _read_record(stream) -> tuple[dict[str, bytes], bytes] | None:
    head = stream.read(4)
    if len(head) < 4:
        return None
    (hlen,) = struct.unpack("<I", head)
    header = _read_header(stream.read(hlen))
    (dlen,) = struct.unpack("<I", stream.read(4))
    data = stream.read(dlen)
    return header, data


def _write_record(stream, fields: dict[str, bytes], data: bytes) -> None:
    h = _write_header(fields)
    stream.write(struct.pack("<I", len(h)))
    stream.write(h)
    stream.write(struct.pack("<I", len(data)))
    stream.write(data)


def _ros_time(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    return struct.pack("<II", sec, nsec)


def _parse_time(b: bytes) -> float:
    sec, nsec = struct.unpack("<II", b)
    return sec + nsec * 1e-9


# --------------------------------------------------------------------------
# Message decoding (ROS1 serialization)
# --------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def time(self) -> float:
        sec, nsec = struct.unpack_from("<II", self.buf, self.off)
        self.off += 8
        return sec + nsec * 1e-9

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode("utf-8", "replace")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


@dataclass
class ImageMessage:
    stamp: float
    frame_id: str
    height: int
    width: int
    encoding: str
    is_bigendian: int
    step: int
    data: bytes

    def to_array(self) -> np.ndarray:
        """Decode to (H, W) or (H, W, C) uint8/uint16 ndarray."""
        channels = {
            "mono8": 1, "8UC1": 1, "bgr8": 3, "rgb8": 3, "bayer_rggb8": 1,
            "bayer_bggr8": 1, "bayer_gbrg8": 1, "bayer_grbg8": 1,
        }
        if self.encoding in channels:
            c = channels[self.encoding]
            arr = np.frombuffer(self.data, np.uint8).reshape(
                self.height, self.step
            )[:, : self.width * c]
            return arr.reshape(self.height, self.width, c).squeeze()
        if self.encoding in ("mono16", "16UC1"):
            arr = np.frombuffer(self.data, np.uint16).reshape(
                self.height, self.step // 2
            )[:, : self.width]
            return arr
        raise ValueError(f"unsupported encoding {self.encoding!r}")


@dataclass
class PoseMessage:
    stamp: float
    frame_id: str
    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (4,) [x, y, z, w]


@dataclass
class PointCloud2Message:
    stamp: float
    frame_id: str
    height: int
    width: int
    point_step: int
    row_step: int
    fields: list[tuple[str, int, int, int]]  # (name, offset, datatype, count)
    is_bigendian: bool
    is_dense: bool
    data: bytes

    def xyz(self, skip_nans: bool = True) -> np.ndarray:
        """Extract (N, 3) float32 xyz (matching pc2.read_points usage,
        gt_mapping.py:49-50)."""
        offs = {name: off for name, off, dt, cnt in self.fields}
        n = self.width * self.height
        raw = np.frombuffer(self.data, np.uint8).reshape(n, self.point_step)
        out = np.empty((n, 3), np.float32)
        for i, name in enumerate(("x", "y", "z")):
            o = offs[name]
            out[:, i] = raw[:, o : o + 4].copy().view(np.float32)[:, 0]
        if skip_nans:
            out = out[np.isfinite(out).all(axis=1)]
        return out


def _decode_header_struct(c: _Cursor) -> tuple[float, str]:
    c.u32()  # seq
    stamp = c.time()
    frame_id = c.string()
    return stamp, frame_id


def decode_image(data: bytes) -> ImageMessage:
    c = _Cursor(data)
    stamp, frame_id = _decode_header_struct(c)
    height = c.u32()
    width = c.u32()
    encoding = c.string()
    is_bigendian = c.u8()
    step = c.u32()
    n = c.u32()
    return ImageMessage(
        stamp, frame_id, height, width, encoding, is_bigendian, step, c.raw(n)
    )


def decode_pose_stamped(data: bytes) -> PoseMessage:
    c = _Cursor(data)
    stamp, frame_id = _decode_header_struct(c)
    pos = np.array([c.f64(), c.f64(), c.f64()])
    quat = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
    return PoseMessage(stamp, frame_id, pos, quat)


def decode_odometry(data: bytes) -> PoseMessage:
    c = _Cursor(data)
    stamp, frame_id = _decode_header_struct(c)
    c.string()  # child_frame_id
    pos = np.array([c.f64(), c.f64(), c.f64()])
    quat = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
    return PoseMessage(stamp, frame_id, pos, quat)


def decode_pointcloud2(data: bytes) -> PointCloud2Message:
    c = _Cursor(data)
    stamp, frame_id = _decode_header_struct(c)
    height = c.u32()
    width = c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        cnt = c.u32()
        fields.append((name, off, dt, cnt))
    is_bigendian = bool(c.u8())
    point_step = c.u32()
    row_step = c.u32()
    n = c.u32()
    payload = c.raw(n)
    is_dense = bool(c.u8()) if c.off < len(c.buf) else True
    return PointCloud2Message(
        stamp, frame_id, height, width, point_step, row_step,
        fields, is_bigendian, is_dense, payload,
    )


_DECODERS = {
    "sensor_msgs/Image": decode_image,
    "geometry_msgs/PoseStamped": decode_pose_stamped,
    "nav_msgs/Odometry": decode_odometry,
    "sensor_msgs/PointCloud2": decode_pointcloud2,
}


# --------------------------------------------------------------------------
# Bag reader
# --------------------------------------------------------------------------


class BagReader:
    """Sequential bag reader.

    ``read_messages(topics)`` yields ``(topic, decoded_message, t)`` in
    stream order — the same contract as ``rosbag.Bag.read_messages``
    (stereo_slam.py:177). Messages of unknown types are yielded as raw
    bytes.
    """

    def __init__(self, path: str):
        self.path = path
        self._connections: dict[int, tuple[str, str]] = {}  # conn -> (topic, type)

    def read_messages(
        self, topics: list[str] | None = None, decode: bool = True
    ) -> Iterator[tuple[str, object, float]]:
        with open(self.path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise ValueError(f"{self.path}: not a ROSBAG V2.0 file")
            while True:
                rec = _read_record(f)
                if rec is None:
                    break
                header, data = rec
                op = header.get("op", b"\x00")[0]
                if op == OP_CONNECTION:
                    conn = struct.unpack("<I", header["conn"])[0]
                    topic = header["topic"].decode()
                    sub = _read_header(data)
                    mtype = sub.get("type", b"").decode()
                    self._connections[conn] = (topic, mtype)
                elif op == OP_CHUNK:
                    compression = header.get("compression", b"none").decode()
                    if compression == "bz2":
                        payload = bz2.decompress(data)
                    elif compression == "lz4":
                        from forest_slam_tpu_torch.io import lz4f

                        payload = lz4f.decompress(data)
                    else:
                        payload = data
                    yield from self._iter_chunk(payload, topics, decode)
                # INDEX_DATA / CHUNK_INFO are skipped: sequential read

    def _iter_chunk(self, payload: bytes, topics, decode):
        import io as _io

        stream = _io.BytesIO(payload)
        while True:
            rec = _read_record(stream)
            if rec is None:
                break
            header, data = rec
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                conn = struct.unpack("<I", header["conn"])[0]
                topic = header["topic"].decode()
                sub = _read_header(data)
                self._connections[conn] = (topic, sub.get("type", b"").decode())
            elif op == OP_MSG_DATA:
                conn = struct.unpack("<I", header["conn"])[0]
                topic, mtype = self._connections.get(conn, ("?", "?"))
                if topics is not None and topic not in topics:
                    continue
                t = _parse_time(header["time"])
                msg = data
                if decode and mtype in _DECODERS:
                    msg = _DECODERS[mtype](data)
                yield topic, msg, t


# --------------------------------------------------------------------------
# Bag writer (tests / fixtures)
# --------------------------------------------------------------------------


class BagWriter:
    """Minimal single-chunk bag writer — enough to synthesize valid fixture
    bags for tests and demos."""

    def __init__(self, path: str):
        self.path = path
        self._messages: list[tuple[str, str, bytes, float]] = []
        self._topics: dict[str, str] = {}

    def write(self, topic: str, msg_type: str, payload: bytes, t: float):
        self._topics.setdefault(topic, msg_type)
        self._messages.append((topic, msg_type, payload, t))

    # convenience encoders ------------------------------------------------
    @staticmethod
    def encode_image(
        arr: np.ndarray, stamp: float, encoding: str = "mono8",
        frame_id: str = "cam",
    ) -> bytes:
        h, w = arr.shape[:2]
        c = 1 if arr.ndim == 2 else arr.shape[2]
        data = arr.astype(np.uint8).tobytes()
        fid = frame_id.encode()
        return (
            struct.pack("<I", 0) + _ros_time(stamp)
            + struct.pack("<I", len(fid)) + fid
            + struct.pack("<II", h, w)
            + struct.pack("<I", len(encoding)) + encoding.encode()
            + struct.pack("<B", 0)
            + struct.pack("<I", w * c)
            + struct.pack("<I", len(data)) + data
        )

    @staticmethod
    def encode_odometry(
        position, quaternion, stamp: float, frame_id: str = "map",
        child: str = "base",
    ) -> bytes:
        fid = frame_id.encode()
        cid = child.encode()
        buf = (
            struct.pack("<I", 0) + _ros_time(stamp)
            + struct.pack("<I", len(fid)) + fid
            + struct.pack("<I", len(cid)) + cid
        )
        buf += struct.pack("<3d", *position)
        buf += struct.pack("<4d", *quaternion)
        # pose covariance (36 doubles) + twist + twist covariance
        buf += struct.pack("<36d", *([0.0] * 36))
        buf += struct.pack("<6d", *([0.0] * 6))
        buf += struct.pack("<36d", *([0.0] * 36))
        return buf

    @staticmethod
    def encode_pointcloud2(points: np.ndarray, stamp: float, frame_id="velo") -> bytes:
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        fid = frame_id.encode()
        buf = (
            struct.pack("<I", 0) + _ros_time(stamp)
            + struct.pack("<I", len(fid)) + fid
            + struct.pack("<II", 1, n)  # height=1, width=n
            + struct.pack("<I", 3)
        )
        for i, name in enumerate(("x", "y", "z")):
            nm = name.encode()
            buf += struct.pack("<I", len(nm)) + nm
            buf += struct.pack("<I", i * 4)
            buf += struct.pack("<B", 7)  # FLOAT32
            buf += struct.pack("<I", 1)
        data = points.tobytes()
        buf += struct.pack("<B", 0)  # bigendian
        buf += struct.pack("<II", 12, 12 * n)
        buf += struct.pack("<I", len(data)) + data
        buf += struct.pack("<B", 1)  # is_dense
        return buf

    def close(self, compression: str = "none", chunk_size: int = 0):
        """Write the bag. ``chunk_size`` > 0 splits the message stream into
        CHUNK records of roughly that many bytes of raw payload (real bags
        are multi-chunk; 0 keeps the legacy single-chunk layout)."""
        import io as _io

        conn_ids = {t: i for i, t in enumerate(self._topics)}
        conn_stream = _io.BytesIO()
        for topic, mtype in self._topics.items():
            sub = _write_header(
                {
                    "topic": topic.encode(),
                    "type": mtype.encode(),
                    "md5sum": b"*",
                    "message_definition": b"",
                }
            )
            _write_record(
                conn_stream,
                {
                    "op": bytes([OP_CONNECTION]),
                    "conn": struct.pack("<I", conn_ids[topic]),
                    "topic": topic.encode(),
                },
                sub,
            )
        conn_records = conn_stream.getvalue()

        # group messages into chunks; connections ride in the first chunk
        groups: list[list[tuple[str, str, bytes, float]]] = [[]]
        acc = 0
        for m in self._messages:
            if chunk_size > 0 and acc > chunk_size and groups[-1]:
                groups.append([])
                acc = 0
            groups[-1].append(m)
            acc += len(m[2])

        with open(self.path, "wb") as f:
            f.write(MAGIC)
            # bag header record (padded to 4096 like real bags)
            bh = {
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": struct.pack("<Q", 0),
                "conn_count": struct.pack("<I", len(self._topics)),
                "chunk_count": struct.pack("<I", len(groups)),
            }
            h = _write_header(bh)
            pad = 4096 - len(h) - 8
            f.write(struct.pack("<I", len(h)))
            f.write(h)
            f.write(struct.pack("<I", pad))
            f.write(b" " * pad)
            for gi, group in enumerate(groups):
                cstream = _io.BytesIO()
                if gi == 0:
                    cstream.write(conn_records)
                for topic, mtype, payload, t in group:
                    _write_record(
                        cstream,
                        {
                            "op": bytes([OP_MSG_DATA]),
                            "conn": struct.pack("<I", conn_ids[topic]),
                            "time": _ros_time(t),
                        },
                        payload,
                    )
                chunk = cstream.getvalue()
                comp = compression
                if comp == "bz2":
                    cdata = bz2.compress(chunk)
                elif comp == "lz4":
                    from forest_slam_tpu_torch.io import lz4f

                    cdata = lz4f.compress(chunk)
                else:
                    comp = "none"
                    cdata = chunk
                _write_record(
                    f,
                    {
                        "op": bytes([OP_CHUNK]),
                        "compression": comp.encode(),
                        "size": struct.pack("<I", len(chunk)),
                    },
                    cdata,
                )
