"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
seconds, and the card, which decides inside a fixture whether it exists."""

from __future__ import annotations

import pytest

TINY_TRAFFIC = dict(n_frames=9, n_unique=4, height=96, width=128, texture_px=256, frame_chunk=4, pair_chunk=3,
                    trace_sequences=1)


def tiny(cell):
    """The cell at 128x96, 9 frames over 4, K=128 (learned) or 64 ORB
    features on 3 levels; its own configuration otherwise."""
    cfg = dict(cell.config)
    if cfg["frontend"] == "orb":
        cfg["orb"] = dict(cfg["orb"], n_features=64, n_levels=3)
    else:
        cfg["max_keypoints"] = 128
    return cell._replace(traffic=dict(cell.traffic, **TINY_TRAFFIC), config=cfg)


@pytest.fixture
def tiny_cell():
    from bench_port import manifest

    return lambda name: tiny(manifest.load_cell(name))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return "cuda"
