"""Front-end contract for the VO pipeline (port of frontend/base.py).

A front end is two functions over batches:

- ``extract(images (B, H, W) in [0, 255]) -> features`` with ``.xy
  (B, K, 2)``, ``.valid (B, K)`` and the matcher's own fields;
- ``match(f0, f1, image_shape) -> matches0 (B, K) int32`` (index into f1's
  keypoints or -1).

The modules own their weights, so no parameter argument is threaded through.
"""

from __future__ import annotations

from typing import Callable, NamedTuple


class FrontendFns(NamedTuple):
    extract: Callable  # (images (B, H, W)) -> features
    match: Callable  # (f0, f1, (H, W)) -> (B, K) int32
    name: str = "frontend"


def orb_frontend(orb_cfg, max_match_distance: int = 64) -> FrontendFns:
    """ORB + cross-checked Hamming matching (the reference's commented
    alternative, ``cv2.ORB_create`` + ``BFMatcher(NORM_HAMMING,
    crossCheck=True)``)."""
    from forest_slam_tpu_torch.frontend.matching import hamming_distance_matrix, mutual_nn_match
    from forest_slam_tpu_torch.frontend.orb import extract_orb

    def extract(images):
        return extract_orb(images, orb_cfg)

    def match(f0, f1, image_shape):
        dist = hamming_distance_matrix(f0.desc, f1.desc)
        return mutual_nn_match(dist, f0.valid, f1.valid, max_distance=max_match_distance)

    return FrontendFns(extract=extract, match=match, name="orb")


def learned_frontend(fe) -> FrontendFns:
    """SuperPoint + SuperGlue (``fe`` is a frontend.learned.LearnedFrontend)."""

    def match(f0, f1, image_shape):
        return fe.match_features(f0, f1, image_shape).matches0

    return FrontendFns(extract=fe.extract, match=match, name="superpoint_superglue")


def lightglue_frontend(sp, lg) -> FrontendFns:
    """SuperPoint + LightGlue: ``sp``'s extraction (a
    frontend.learned.LearnedFrontend, the checkpoint's SuperPoint) and the
    matcher ``lg`` (a frontend.lightglue.LightGlue)."""

    def match(f0, f1, image_shape):
        return lg.match(f0.xy, f0.desc, f0.valid, f1.xy, f1.desc, f1.valid, image_shape)

    return FrontendFns(extract=sp.extract, match=match, name="superpoint_lightglue")
