"""Binary PLY point clouds (the port's copy of io/ply.py, numpy only).

The file sink for the stereo map that the reference published as a ROS
``PointCloud2`` for RViz (stereo_slam.py:126-134, 317-318): any viewer
(CloudCompare, Meshlab, rerun, Open3D) reads it.
"""

from __future__ import annotations

import os

import numpy as np


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write (N, 3) float points (optionally with (N, 3) uint8 colors) as
    binary little-endian PLY."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {axis}" for axis in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            colors = np.asarray(colors, np.uint8)
            rec = np.zeros(
                n,
                dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("r", "u1"), ("g", "u1"), ("b", "u1")],
            )
            rec["x"], rec["y"], rec["z"] = points.T
            rec["r"], rec["g"], rec["b"] = colors.T
            f.write(rec.tobytes())


def read_ply(path: str, with_colors: bool = False):
    """Read back points written by :func:`write_ply`.

    Returns (N, 3) xyz, or ((N, 3) xyz, (N, 3) uint8 rgb | None) when
    ``with_colors`` is set."""
    with open(path, "rb") as f:
        n = 0
        has_color = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar"):
                has_color = True
            if line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(
                f.read(n * 15),
                dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("r", "u1"), ("g", "u1"), ("b", "u1")],
            )
            xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
            if with_colors:
                rgb = np.stack([rec["r"], rec["g"], rec["b"]], axis=1)
                return xyz, rgb
            return xyz
        xyz = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3).copy()
        return (xyz, None) if with_colors else xyz
