"""The C++ ROS1-bag image reader (``rosbag_reader.cpp``), loaded with ctypes
(the port's copy of forest_slam_tpu/native/__init__.py).

The shared library is compiled at first use by ``g++ -O2 -shared -fPIC
-std=c++17 ... -l:libbz2.so.1`` into ``forest_slam_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags,
written under a temporary name and renamed into place. Where no compiler or
libbz2 is present, :func:`available` is False and the dataset loader reads
with the Python parser (io/rosbag.py), as the JAX package does; the loader
reports which reader ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from forest_slam_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rosbag_reader.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-l:libbz2.so.1",)
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librosbag_reader_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp, *LIBS], check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain or no libbz2: the Python parser reads
        detail = getattr(e, "stderr", b"") or b""
        print(f"# native rosbag reader build failed: {e} {detail.decode(errors='replace')}", file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            print(f"# native rosbag reader load failed: {e}", file=sys.stderr)
            _load_failed = True
            return None
        lib.fsbag_open.restype = ctypes.c_void_p
        lib.fsbag_open.argtypes = [ctypes.c_char_p]
        lib.fsbag_close.argtypes = [ctypes.c_void_p]
        lib.fsbag_count.restype = ctypes.c_long
        lib.fsbag_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.fsbag_image_info.restype = ctypes.c_int
        lib.fsbag_image_info.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ]
        lib.fsbag_read_images.restype = ctypes.c_long
        lib.fsbag_read_images.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native reader builds (or is built) and loads here."""
    return _load() is not None


def read_image_topic(path: str, topic: str, max_frames: int | None = None,
                     stride: int = 1) -> tuple[np.ndarray, np.ndarray, str]:
    """Every ``stride``-th sensor_msgs/Image on ``topic``: (images (N, H, W)
    or (N, H, W, C) uint8, header stamps (N,) float64, encoding). Raises
    RuntimeError when the reader is unavailable or cannot parse the bag
    (lz4 chunks, for one)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native rosbag reader unavailable")
    h = lib.fsbag_open(path.encode())
    if not h:
        raise RuntimeError(f"failed to open/parse bag {path!r}")
    try:
        n = lib.fsbag_count(h, topic.encode())
        if n == 0:
            raise RuntimeError(f"no Image messages on topic {topic!r}")
        H, W, C = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        enc = ctypes.create_string_buffer(32)
        rc = lib.fsbag_image_info(h, topic.encode(), H, W, C, enc)
        if rc != 0:
            raise RuntimeError(f"image info failed rc={rc}")
        n_take = (n + stride - 1) // stride
        if max_frames is not None:
            n_take = min(n_take, max_frames)
        out = np.empty((n_take, H.value, W.value, C.value), np.uint8)
        stamps = np.empty((n_take,), np.float64)
        got = lib.fsbag_read_images(h, topic.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_take,
                                    stride, stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if got < 0:
            raise RuntimeError(f"read_images failed rc={got}")
        out, stamps = out[:got], stamps[:got]
        if C.value == 1:
            out = out[..., 0]
        return out, stamps, enc.value.decode()
    finally:
        lib.fsbag_close(h)
