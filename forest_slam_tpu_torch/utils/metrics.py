"""Per-frame metrics as JSON lines (port of utils/metrics.py), the CLI's
``--metrics-out``."""

from __future__ import annotations

import json

import numpy as np
import torch


def write_metrics_jsonl(path: str, timestamps, outs, extra: dict | None = None) -> None:
    """Write one JSON object per frame to ``path``: ``frame``, ``t`` and every
    field of the NamedTuple ``outs`` (tensors or arrays) that holds one value
    a frame (bools as booleans, numbers as floats); fields of higher rank are
    left out."""
    ts = np.asarray(timestamps)
    fields = {}
    n = None
    for name, val in outs._asdict().items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        if arr.ndim == 1:
            fields[name] = arr
            n = arr.shape[0] if n is None else n
    with open(path, "w") as f:
        for i in range(n or 0):
            row = {"frame": i, "t": float(ts[i]) if i < len(ts) else None}
            for name, arr in fields.items():
                row[name] = bool(arr[i]) if arr.dtype == bool else float(arr[i])
            if extra:
                row.update(extra)
            f.write(json.dumps(row) + "\n")
