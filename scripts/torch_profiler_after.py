#!/usr/bin/env python3
"""Does a torch.profiler window slow the host's later runs in one process?

    python3 scripts/torch_profiler_after.py

On one CUDA card, for the ORB and the learned 962-pair workloads of
``forest_slam_tpu_torch.bench``: a warm-up run, three timed runs (three more
when they spread by over 10%), the bench's device-time cross-check
(``bench.chunk_times``: profiled windows of a frame chunk and a pair chunk),
then three timed runs again. Prints the run times before and after, and
their medians, with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    from forest_slam_tpu_torch import bench

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    for kind in ("orb", "sp"):
        wl = bench.prepare_workload(kind, dev)
        wl.run()
        before, _ = bench.timed_runs(wl.run, 3)
        bench.chunk_times(wl)
        after, _ = bench.timed_runs(wl.run, 3)
        print(f"{kind}: before {[round(t, 3) for t in before]}, after the profiler {[round(t, 3) for t in after]}; "
              f"medians {float(np.median(before)):.3f} s and {float(np.median(after)):.3f} s on {smi}", flush=True)
        del wl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
