"""TUM trajectory files (port of io/tum.py).

Rows of ``timestamp tx ty tz qx qy qz qw``, written with ``%f`` and single
spaces; the reader skips blank and ``#`` lines, takes commas as separators
and keeps duplicate stamps.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class Trajectory(NamedTuple):
    """Host-side trajectory: ``timestamps`` (N,) float64 seconds,
    ``positions`` (N, 3), ``quaternions`` (N, 4) in [x, y, z, w]."""

    timestamps: np.ndarray
    positions: np.ndarray
    quaternions: np.ndarray

    def __len__(self) -> int:
        return int(self.timestamps.shape[0])

    @classmethod
    def from_matrices(cls, timestamps, T) -> "Trajectory":
        from scipy.spatial.transform import Rotation

        T = np.asarray(T, np.float64)
        quats = Rotation.from_matrix(T[:, :3, :3]).as_quat()
        quats = quats * np.where(quats[:, 3:4] < 0, -1.0, 1.0)  # w >= 0
        return cls(
            timestamps=np.asarray(timestamps, np.float64),
            positions=T[:, :3, 3].copy(),
            quaternions=quats,
        )


def _rows(traj: Trajectory) -> np.ndarray:
    return np.column_stack([traj.timestamps, traj.positions, traj.quaternions])


def read_tum(path: str) -> Trajectory:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) >= 8:
                rows.append([float(p) for p in parts[:8]])
    data = np.asarray(rows, np.float64).reshape(-1, 8)
    return Trajectory(timestamps=data[:, 0], positions=data[:, 1:4], quaternions=data[:, 4:8])


def write_tum(path: str, traj: Trajectory) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    np.savetxt(path, _rows(traj), delimiter=" ", fmt="%f")


class StreamingTumWriter:
    """Appends rows to a TUM file chunk by chunk, flushed and synced after
    each, so a crash loses at most the chunk being written."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def append(self, timestamps, matrices) -> None:
        traj = Trajectory.from_matrices(np.asarray(timestamps, np.float64), np.asarray(matrices, np.float64))
        np.savetxt(self._f, _rows(traj), delimiter=" ", fmt="%f")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
