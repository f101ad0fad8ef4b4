"""Timestamped trajectories (port of io/tum.py's ``Trajectory``)."""

from __future__ import annotations

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
