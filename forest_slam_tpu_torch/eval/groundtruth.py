"""Ground-truth trajectory and map from a bag (port of eval/groundtruth.py).

- ``extract_gt_trajectory`` (the reference's gt_localisation.py): the
  ``/gt_poses`` pose nearest each left image's stamp, taken into the camera
  frame as ``T_cam_sensor @ pose`` (the absolute aligned pose the reference
  writes to its TUM files, not the chained one it publishes to RViz), one
  row per image from the second on.
- ``extract_gt_map`` (gt_mapping.py): every ``scan_stride``-th
  ``/velodyne_points`` scan taken to the world by its nearest pose,
  voxel-downsampled (0.5 m) one scan at a time and concatenated.
"""

from __future__ import annotations

import numpy as np

from forest_slam_tpu_torch.backend.mapping import voxel_downsample
from forest_slam_tpu_torch.eval.association import nearest_indices
from forest_slam_tpu_torch.io.calib import BOTANIC_T_RGB0_VLP16
from forest_slam_tpu_torch.io.rosbag import BagReader
from forest_slam_tpu_torch.io.tum import Trajectory


def _pose_to_matrix(position, quaternion) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_quat(quaternion).as_matrix()
    T[:3, 3] = position
    return T


def extract_gt_trajectory(
    bag_path: str,
    image_topic: str = "/dalsa_rgb/left/image_raw",
    gt_topic: str = "/gt_poses",
    T_cam_sensor: np.ndarray | None = None,
) -> Trajectory:
    """GT trajectory at image timestamps, camera frame (TUM-ready)."""
    if T_cam_sensor is None:
        T_cam_sensor = BOTANIC_T_RGB0_VLP16
    gt_times: list[float] = []
    gt_poses: list[np.ndarray] = []
    img_times: list[float] = []
    for topic, msg, t in BagReader(bag_path).read_messages(
        topics=[image_topic, gt_topic]
    ):
        if topic == gt_topic:
            gt_times.append(t)
            gt_poses.append(_pose_to_matrix(msg.position, msg.orientation))
        else:
            img_times.append(msg.stamp if hasattr(msg, "stamp") else t)
    if not gt_times or not img_times:
        return Trajectory(np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4)))
    gt_times_arr = np.asarray(gt_times)
    order = np.argsort(gt_times_arr, kind="stable")
    gt_times_arr = gt_times_arr[order]
    gt_stack = np.stack([gt_poses[i] for i in order])
    img_times_arr = np.asarray(img_times)
    idx = nearest_indices(img_times_arr, gt_times_arr)
    # the reference emits rows starting from the SECOND image frame
    # (needs a previous pose, gt_localisation.py:76)
    aligned = T_cam_sensor @ gt_stack[idx]  # (N, 4, 4)
    return Trajectory.from_matrices(img_times_arr[1:], aligned[1:])


def extract_gt_map(
    bag_path: str,
    lidar_topic: str = "/velodyne_points",
    gt_topic: str = "/gt_poses",
    scan_stride: int = 10,  # gt_mapping.py:48 "every 10th scan"
    voxel_size: float = 0.5,  # gt_mapping.py:66
) -> np.ndarray:
    """(M, 3) world-frame lidar map from GT poses."""
    gt_times: list[float] = []
    gt_poses: list[np.ndarray] = []
    clouds: list[tuple[float, np.ndarray]] = []
    n_scans = 0
    for topic, msg, t in BagReader(bag_path).read_messages(
        topics=[lidar_topic, gt_topic]
    ):
        if topic == gt_topic:
            gt_times.append(t)
            gt_poses.append(_pose_to_matrix(msg.position, msg.orientation))
        else:
            if n_scans % scan_stride == 0:
                clouds.append((t, msg.xyz(skip_nans=True)))
            n_scans += 1
    if not clouds or not gt_times:
        return np.zeros((0, 3))
    gt_times_arr = np.asarray(gt_times)
    order = np.argsort(gt_times_arr, kind="stable")
    gt_times_arr = gt_times_arr[order]
    gt_stack = np.stack([gt_poses[i] for i in order])
    parts = []
    for t, pts in clouds:
        i = int(nearest_indices(np.asarray([t]), gt_times_arr)[0])
        T = gt_stack[i]
        world = pts @ T[:3, :3].T + T[:3, 3]
        # the reference downsamples each NEW scan before concatenation
        # (mono_slam.py:151-164 pattern; global cloud still grows, quirk B8)
        parts.append(voxel_downsample(world, voxel_size))
    return np.concatenate(parts, axis=0)
