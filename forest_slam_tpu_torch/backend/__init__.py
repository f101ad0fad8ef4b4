"""The SLAM back end of the port (port of backend/): window bundle
adjustment, loop closure, the pose graph, relocalization and the map."""

from forest_slam_tpu_torch.backend.mapping import voxel_downsample, accumulate_map
from forest_slam_tpu_torch.backend.ba import BAProblem, BAResult, ba_solve
from forest_slam_tpu_torch.backend.relocalize import (
    RelocalizeConfig,
    RelocalizeEvents,
    relocalize_trajectory,
)
from forest_slam_tpu_torch.backend.window import (
    StereoArtifacts,
    WindowBAConfig,
    refine_trajectory_ba,
)

__all__ = [
    "voxel_downsample",
    "accumulate_map",
    "BAProblem",
    "BAResult",
    "ba_solve",
    "RelocalizeConfig",
    "RelocalizeEvents",
    "relocalize_trajectory",
    "StereoArtifacts",
    "WindowBAConfig",
    "refine_trajectory_ba",
]
