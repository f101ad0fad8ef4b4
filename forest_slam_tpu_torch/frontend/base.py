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


def learned_frontend(fe) -> FrontendFns:
    """SuperPoint + SuperGlue (``fe`` is a frontend.learned.LearnedFrontend)."""

    def match(f0, f1, image_shape):
        return fe.match_features(f0, f1, image_shape).matches0

    return FrontendFns(extract=fe.extract, match=match, name="superpoint_superglue")
