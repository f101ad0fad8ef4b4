"""Timestamp association between two trajectories (port of
eval/association.py).

A vectorised searchsorted pass in place of the reference's per-frame
``find_closest_timestamp`` scan (gt_localisation.py:43-51); duplicate
stamps are tolerated. ``associate`` itself lives in eval/metrics.py and is
exported here under the JAX package's module name.
"""

from __future__ import annotations

import numpy as np


def nearest_indices(query: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """For each query stamp, the index of the nearest stamp of ``reference``
    (sorted ascending, as TUM files are); a tie goes to the later stamp."""
    idx = np.searchsorted(reference, query)
    idx = np.clip(idx, 1, len(reference) - 1)
    left = reference[idx - 1]
    right = reference[idx]
    idx -= (query - left) < (right - query)
    return idx


from forest_slam_tpu_torch.eval.metrics import associate  # noqa: E402

__all__ = ["associate", "nearest_indices"]
