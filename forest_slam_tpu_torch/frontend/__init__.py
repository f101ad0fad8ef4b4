"""Feature front ends: ORB (classical), SuperPoint + SuperGlue and SuperPoint + LightGlue
(learned)."""

from forest_slam_tpu_torch.frontend.matching import (
    gather_matched_points,
    hamming_distance_matrix,
    mutual_nn_match,
    unpack_bits_pm1,
)
from forest_slam_tpu_torch.frontend.orb import OrbConfig, OrbFeatures, extract_orb

__all__ = [
    "OrbConfig",
    "OrbFeatures",
    "extract_orb",
    "gather_matched_points",
    "hamming_distance_matrix",
    "mutual_nn_match",
    "unpack_bits_pm1",
]
