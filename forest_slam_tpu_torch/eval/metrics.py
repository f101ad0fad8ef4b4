"""Trajectory errors (port of eval/metrics.py's APE and RPE and of
eval/association.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from forest_slam_tpu_torch.eval.alignment import align_trajectory
from forest_slam_tpu_torch.io.tum import Trajectory


class ErrorStats(NamedTuple):
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n: int

    @classmethod
    def from_errors(cls, e: np.ndarray) -> "ErrorStats":
        e = np.asarray(e, np.float64)
        if e.size == 0:
            return cls(*([float("nan")] * 6), 0)
        return cls(
            rmse=float(np.sqrt(np.mean(e ** 2))),
            mean=float(np.mean(e)),
            median=float(np.median(e)),
            std=float(np.std(e)),
            min=float(np.min(e)),
            max=float(np.max(e)),
            n=int(e.size),
        )


def associate(est: Trajectory, ref: Trajectory, max_diff: float = 0.01):
    """Pair each estimated pose with the nearest reference stamp; pairs
    further apart than ``max_diff`` seconds are dropped."""
    if len(est) == 0 or len(ref) == 0:
        empty = Trajectory(np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4)))
        return empty, empty
    order = np.argsort(ref.timestamps, kind="stable")
    stamps = ref.timestamps[order]
    idx = np.clip(np.searchsorted(stamps, est.timestamps), 1, len(stamps) - 1)
    idx -= (est.timestamps - stamps[idx - 1]) < (stamps[idx] - est.timestamps)
    keep = np.abs(stamps[idx] - est.timestamps) <= max_diff
    idx = order[idx[keep]]
    est_m = Trajectory(est.timestamps[keep], est.positions[keep], est.quaternions[keep])
    ref_m = Trajectory(ref.timestamps[idx], ref.positions[idx], ref.quaternions[idx])
    return est_m, ref_m


def ape_translation(est: Trajectory, ref: Trajectory, align: bool = True, with_scale: bool = True,
                    max_diff: float = 0.01) -> ErrorStats:
    """Absolute translation error after association and Umeyama alignment."""
    est_m, ref_m = associate(est, ref, max_diff=max_diff)
    if align and len(est_m) >= 3:
        est_m = align_trajectory(est_m, ref_m, with_scale=with_scale)
    return ErrorStats.from_errors(np.linalg.norm(est_m.positions - ref_m.positions, axis=1))


def rpe_distance_ratio(est: Trajectory, ref: Trajectory, delta_m: float = 20.0, max_diff: float = 0.01) -> ErrorStats:
    """Relative error as a point-distance error ratio (%) over path-length
    deltas (evo's ``filter_pairs_by_path``, consecutive pairs): after Sim(3)
    alignment, an id is marked each time the estimate's accumulated path
    reaches ``delta_m`` (index 0 is not one), consecutive ids pair up, and a
    pair's error is | |est_j - est_i| - |ref_j - ref_i| | / |ref_j - ref_i|
    x 100."""
    est_m, ref_m = associate(est, ref, max_diff=max_diff)
    n = len(est_m)
    if n < 2:
        return ErrorStats.from_errors(np.zeros(0))
    if n >= 3:
        est_m = align_trajectory(est_m, ref_m, with_scale=True)
    seg = np.linalg.norm(np.diff(est_m.positions, axis=0), axis=1)
    ids, acc = [], 0.0
    for i in range(1, n):
        acc += seg[i - 1]
        if acc >= delta_m:
            ids.append(i)
            acc = 0.0
    errors = []
    for i, j in zip(ids[:-1], ids[1:]):
        d_ref = np.linalg.norm(ref_m.positions[j] - ref_m.positions[i])
        d_est = np.linalg.norm(est_m.positions[j] - est_m.positions[i])
        if d_ref > 1e-9:
            errors.append(abs(d_est - d_ref) / d_ref * 100.0)
    return ErrorStats.from_errors(np.asarray(errors))
