"""Point-cloud map accumulation and voxel downsampling (the port's copy of
backend/mapping.py, numpy only, on the host at export).

Per-frame world points are masked fixed-size slabs, flattened once at
export (the reference re-published the whole list every frame,
stereo_slam.py:309-318, quirk B8); the voxel grid keeps each occupied
voxel's centroid, as Open3D's ``voxel_down_sample`` (mono_slam.py:155).
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid centroid downsampling, Open3D-equivalent semantics.

    points: (N, 3). Returns (M, 3) centroids of occupied voxels.
    """
    points = np.asarray(points, np.float64)
    if points.shape[0] == 0:
        return points.reshape(0, 3)
    idx = np.floor(points / voxel_size).astype(np.int64)
    # lexicographic voxel key
    _, inverse, counts = np.unique(
        idx, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inverse, points)
    return sums / counts[:, None]


def accumulate_map(
    points_per_frame: np.ndarray,
    valid_per_frame: np.ndarray,
    voxel_size: float | None = None,
) -> np.ndarray:
    """Flatten (F, K, 3) masked per-frame world points into one (M, 3)
    cloud, optionally voxel-downsampled."""
    pts = np.asarray(points_per_frame, np.float64).reshape(-1, 3)
    mask = np.asarray(valid_per_frame, bool).reshape(-1)
    cloud = pts[mask]
    if voxel_size is not None:
        cloud = voxel_downsample(cloud, voxel_size)
    return cloud
