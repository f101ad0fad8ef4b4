"""The frozen roofline arithmetic, ping-pong order and renderer, against the
counts the repository recorded (PERF.md: a 962-pair run in chunks of 32
frames and 48 pairs, learned 112.21 TFLOP and 9.555 GB, ORB 0.145 TFLOP and
4.530 GB) and against themselves."""

import numpy as np
import pytest
import torch

from bench_port import manifest, render, roofline, traffic


@pytest.mark.parametrize("config,tflop,gb", (("sp_flagship", 112.21, 9.555), ("orb512", 0.145, 4.530)))
def test_sequence_costs_match_the_recorded_counts(config, tflop, gb):
    cfg = manifest.load_cell({"sp_flagship": "sp_flagship.seq962", "orb512": "orb512.seq962_c128"}[config]).config
    c = roofline.sequence_costs(600, 960, cfg, 963, 32, 48)
    assert round(c.flops / 1e12, 2 if tflop > 1 else 3) == tflop
    assert round(c.bytes / 1e9, 3) == gb


@pytest.mark.parametrize("name,flops,nbytes,budget", (("sp_flagship.seq962", 112213364066304, 9555030418, 1024),
                                                       ("orb512.seq962_c128", 145307859410, 4530271488, 512)))
def test_sequence_costs_at_each_cells_traffic_are_pinned(name, flops, nbytes, budget):
    """The counts under mfu and the keypoint budget that sizes the PnP
    draws, to the digit, from the cell's front-end file."""
    cell = manifest.load_cell(name)
    tr = cell.traffic
    c = roofline.sequence_costs(tr["height"], tr["width"], cell.config, tr["n_frames"], tr["frame_chunk"],
                                tr["pair_chunk"])
    assert (c.flops, c.bytes) == (flops, nbytes)
    assert cell.frontend.keypoints(cell.config) == budget


def test_kernel_bounds_and_peaks():
    c = roofline.gnn_layer_cost(96, 1024, 1024, 256, roofline.gnn_layer_weight_bytes(256))
    peaks = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    assert abs(roofline.bound_seconds(c, peaks["bf16"], peaks["hbm"]) * 1e3 - 0.2345) < 5e-4
    assert roofline.device_peaks("cpu") is None


def test_frame_index_ping_pongs():
    idx = render.frame_index(963, 64)
    assert idx.shape == (963,) and idx[:3].tolist() == [0, 1, 2] and idx[63:66].tolist() == [63, 62, 61]
    assert np.abs(np.diff(idx.astype(int))).max() == 1


def test_same_seed_same_inputs_other_seed_same_sizes():
    cfg = manifest.load_cell("orb512.seq962_c128").config
    tr = dict(manifest.load_cell("orb512.seq962_c128").traffic, n_frames=5, n_unique=3, height=64, width=96,
              texture_px=64)
    a, b = traffic.make_inputs(tr, cfg, 2 ** 31 + 3, "cpu"), traffic.make_inputs(tr, cfg, 2 ** 31 + 3, "cpu")
    c = traffic.make_inputs(tr, cfg, 4, "cpu")
    for k in ("left", "right", "gumbel", "uniform"):
        assert torch.equal(a[k], b[k]) and a[k].shape == c[k].shape
    assert not torch.equal(a["left"], c["left"])
    assert 0.0 <= float(a["left"].min()) and float(a["left"].max()) <= 255.0
