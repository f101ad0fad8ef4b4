"""Bag streams to preprocessed image stacks on the device (the port's copy of
io/dataset.py).

The reference decodes, undistorts and converts each message to gray in one
host loop (stereo_slam.py:177-204: cv_bridge, cv2.undistort, BGR2GRAY). Here
the host reads the raw frames out of the bag, with the C++ reader
(``forest_slam_tpu_torch.native``) where it builds and parses the bag and the
Python parser (io/rosbag.py) otherwise (lz4 chunks, for one), and the
device converts to gray and undistorts whole chunks of frames with one
bilinear remap (plain PyTorch, as the JAX package's is plain ``jax.numpy``).
The loaders say which reader ran.

The two readers pair stereo frames by the JAX package's two rules: the
native path pairs the i-th left and the i-th right message of each topic,
the Python path pairs each right message with the left one before it. They
agree on lockstep streams.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig, bgr_to_gray, remap_bilinear, undistort_map
from forest_slam_tpu_torch.io.rosbag import BagReader

LEFT_TOPIC = "/dalsa_rgb/left/image_raw"
RIGHT_TOPIC = "/dalsa_rgb/right/image_raw"


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bag loader puts its frames on a CUDA card, and none is available; pass device='cpu' "
                           "to load on the CPU")
    return device


def preprocess_frames(frames: np.ndarray, cam: PinholeCamera, chunk: int = 64, device=None) -> torch.Tensor:
    """Host frames (N, H, W) or BGR (N, H, W, 3) uint8 -> (N, H', W')
    float32 gray, undistorted to ``cam`` (its size), on ``device`` (else the
    camera's), ``chunk`` frames at a time."""
    device = _device(cam.K.device if device is None else device)
    src_map = undistort_map(cam).to(device)
    is_color = frames.ndim == 4
    outs = []
    for i in range(0, frames.shape[0], chunk):
        part = frames[i:i + chunk]
        # uint8 goes over as it is; mono16 frames as float32
        raw = torch.from_numpy(np.ascontiguousarray(part if part.dtype == np.uint8 else part.astype(np.float32)))
        raw = raw.to(device)
        gray = bgr_to_gray(raw) if is_color else raw.float()
        outs.append(remap_bilinear(gray, src_map))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def read_image_native(bag_path: str, topic: str, max_frames: int | None, stride: int):
    """(frames, header stamps) of every ``stride``-th image on ``topic`` by
    the C++ reader, or None where it does not build or cannot parse the
    bag."""
    from forest_slam_tpu_torch import native

    if not native.available():
        return None
    try:
        frames, stamps, _ = native.read_image_topic(bag_path, topic, max_frames=max_frames, stride=stride)
    except RuntimeError:
        return None
    return frames, stamps


def read_stereo_python(bag_path: str, left_topic: str, right_topic: str, max_frames: int | None, frame_stride: int):
    """(lefts, rights, left header stamps) by the Python parser: each right
    frame pairs with the left frame before it."""
    lefts, rights, times = [], [], []
    pend_l = None
    for topic, msg, _ in BagReader(bag_path).read_messages(topics=[left_topic, right_topic]):
        arr = msg.to_array()
        if topic == left_topic:
            pend_l = (arr, msg.stamp)
        elif pend_l is not None:
            lefts.append(pend_l[0])
            times.append(pend_l[1])
            rights.append(arr)
            pend_l = None
            if max_frames is not None and len(lefts) >= max_frames * frame_stride:
                break
    lefts = np.stack(lefts)[::frame_stride]
    rights = np.stack(rights)[::frame_stride]
    times = np.asarray(times)[::frame_stride]
    if max_frames is not None:
        lefts, rights, times = lefts[:max_frames], rights[:max_frames], times[:max_frames]
    return lefts, rights, times


def read_mono_python(bag_path: str, topic: str, max_frames: int | None, frame_stride: int):
    """(frames, header stamps) of ``topic`` by the Python parser."""
    frames, times = [], []
    for _, msg, _ in BagReader(bag_path).read_messages(topics=[topic]):
        frames.append(msg.to_array())
        times.append(msg.stamp)
        if max_frames is not None and len(frames) >= max_frames * frame_stride:
            break
    arr = np.stack(frames)[::frame_stride]
    times = np.asarray(times)[::frame_stride]
    if max_frames is not None:
        arr, times = arr[:max_frames], times[:max_frames]
    return arr, times


class StereoSequence(NamedTuple):
    images_left: torch.Tensor  # (N, H, W) float32, undistorted gray
    images_right: torch.Tensor
    timestamps: np.ndarray  # (N,) the left frames' header stamps
    reader: str  # "native" or "python"


class MonoSequence(NamedTuple):
    images: torch.Tensor
    timestamps: np.ndarray
    reader: str


def read_stereo(bag_path: str, left_topic: str = LEFT_TOPIC, right_topic: str = RIGHT_TOPIC,
                max_frames: int | None = None, frame_stride: int = 1):
    """The raw stereo frames of a bag: (lefts, rights, stamps, reader), by the
    C++ reader where it can, else by the Python parser."""
    nat_l = read_image_native(bag_path, left_topic, max_frames, frame_stride)
    nat_r = read_image_native(bag_path, right_topic, max_frames, frame_stride)
    if nat_l is not None and nat_r is not None:
        (lefts, times), (rights, _) = nat_l, nat_r
        n = min(len(lefts), len(rights))
        return lefts[:n], rights[:n], np.asarray(times[:n]), "native"
    return (*read_stereo_python(bag_path, left_topic, right_topic, max_frames, frame_stride), "python")


def load_stereo_from_bag(bag_path: str, rig: StereoRig, left_topic: str = LEFT_TOPIC, right_topic: str = RIGHT_TOPIC,
                         max_frames: int | None = None, frame_stride: int = 1, device="cuda") -> StereoSequence:
    """Read, pair and preprocess a stereo bag (the reference's topics,
    stereo_slam.py:177) onto ``device``; ``frame_stride`` keeps every
    stride-th pair, ``max_frames`` at most that many."""
    device = _device(device)
    lefts, rights, times, reader = read_stereo(bag_path, left_topic, right_topic, max_frames, frame_stride)
    return StereoSequence(images_left=preprocess_frames(lefts, rig.left, device=device),
                          images_right=preprocess_frames(rights, rig.right, device=device), timestamps=times,
                          reader=reader)


def load_mono_from_bag(bag_path: str, cam: PinholeCamera, topic: str = LEFT_TOPIC, max_frames: int | None = None,
                       frame_stride: int = 1, device="cuda") -> MonoSequence:
    """Read and preprocess one image topic of a bag onto ``device``."""
    device = _device(device)
    nat = read_image_native(bag_path, topic, max_frames, frame_stride)
    reader = "native" if nat is not None else "python"
    frames, times = nat if nat is not None else read_mono_python(bag_path, topic, max_frames, frame_stride)
    return MonoSequence(images=preprocess_frames(frames, cam, device=device), timestamps=np.asarray(times),
                        reader=reader)
