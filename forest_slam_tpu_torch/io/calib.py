"""The BotanicGarden calibration (the port's copy of io/calib.py).

The stereo rig's constants are the reference's hard-coded values
(stereo_slam.py:44-64, mono_slam.py:40-50, gt_localisation.py:30-33), kept
in one registry; the cameras and the rig are built on the port's
``core/camera.py`` types on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig

BOTANIC_WIDTH = 960
BOTANIC_HEIGHT = 600

# Left camera intrinsics (reference stereo_slam.py:45-47).
BOTANIC_K_LEFT = np.array(
    [
        [642.9165664800531, 0.0, 460.1840658156501],
        [0.0, 641.9171825800378, 308.5846449100310],
        [0.0, 0.0, 1.0],
    ]
)
# Left distortion [k1, k2, p1, p2, k3] (stereo_slam.py:50).
BOTANIC_DIST_LEFT = np.array([-0.060164620903866, 0.094005180631043, 0.0, 0.0, 0.0])

# Right camera intrinsics (stereo_slam.py:53-55).
BOTANIC_K_RIGHT = np.array(
    [
        [644.4385505412966, 0.0, 455.1775919513420],
        [0.0, 643.5879520187435, 304.1616226347153],
        [0.0, 0.0, 1.0],
    ]
)
BOTANIC_DIST_RIGHT = np.array([-0.057705696896734, 0.086955444511364, 0.0, 0.0, 0.0])

# Right camera in left-camera coordinates (stereo_slam.py:61-64). The
# reference stores this as a (1, 16) array (quirk B4, SURVEY.md §2.4) and
# only ever consumes element [0, 3] as the baseline; we store the intended
# (4, 4) matrix — norm of its translation equals the same baseline.
BOTANIC_T_LEFT_RIGHT = np.array(
    [
        [0.999994564612669, -0.00327143011166783, -0.000410475508767800, 0.253736175410149],
        [0.00326819763481066, 0.999965451959397, -0.00764289028177120, -0.000362553856124796],
        [0.000435464509051199, 0.00764150722461529, 0.999970708440001, -0.000621002717451192],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

# Camera-from-lidar extrinsic (gt_localisation.py:30-33): transforms VLP16
# poses into the RGB0 frame when building ground-truth trajectories.
BOTANIC_T_RGB0_VLP16 = np.array(
    [
        [0.0238743541600432, -0.999707744440396, 0.00360642510766516, 0.138922870923538],
        [-0.00736968896588375, -0.00378431903190059, -0.999965147452649, -0.177101909101325],
        [0.999687515506770, 0.0238486947027063, -0.00745791352160211, -0.126685267545513],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def botanic_garden_left(device="cuda") -> PinholeCamera:
    return PinholeCamera.create(BOTANIC_K_LEFT, BOTANIC_DIST_LEFT, BOTANIC_WIDTH, BOTANIC_HEIGHT, device=device)


def botanic_garden_right(device="cuda") -> PinholeCamera:
    return PinholeCamera.create(BOTANIC_K_RIGHT, BOTANIC_DIST_RIGHT, BOTANIC_WIDTH, BOTANIC_HEIGHT, device=device)


def botanic_garden_rig(device="cuda") -> StereoRig:
    return StereoRig(left=botanic_garden_left(device), right=botanic_garden_right(device),
                     T_left_right=torch.as_tensor(BOTANIC_T_LEFT_RIGHT, dtype=torch.float32, device=device))
