"""The readers of the port's spans (spans.py and the six metrics that read
it): a second System beside the harness's, whose close still puts the
runner's own per-pair call back; one measurement shared by the readers of a
run; on the card, the launches counted in stretch B equal the kernels the
profiler saw in it."""

import pytest

from bench_port import manifest, spans, traffic
from bench_port.system import System

READERS = ("frame_enqueue_ms", "pair_enqueue_ms", "frame_idle_frac", "pair_idle_frac", "launches_per_pair",
           "warmup_excess_s")


def _ctx(cell, device):
    inputs = traffic.make_inputs(cell.traffic, cell.config, 3, device)
    return dict(config=cell.config, traffic=cell.traffic, inputs=inputs, frontend=cell.frontend,
                window=dict(seconds=1.0, sequences=1, frames=cell.traffic["n_frames"],
                            pairs=cell.traffic["n_frames"] - 1))


def test_readers_leave_the_harness_close_working(tiny_cell):
    from forest_slam_tpu_torch.pipelines import stereo

    original = stereo.pair_from_slab
    cell = tiny_cell("orb512.seq962_c128")
    ctx = _ctx(cell, "cpu")
    system = System(cell.config, cell.traffic, ctx["inputs"], cell.root, "cpu")
    try:
        system.run()
        values = {m: manifest.reader(m)(ctx) for m in READERS}
        assert spans.stretches(ctx) is spans.stretches(ctx)  # measured once a run
        _, _, obs = system.run()
    finally:
        system.close()
    assert stereo.pair_from_slab is original
    assert obs is None  # the second System's wrapper took the obs: the harness reads none after its readers
    assert values["frame_enqueue_ms"] > 0 and values["pair_enqueue_ms"] > 0
    # no card: no kernel, no launch, no CUDA event to read
    assert all(values[m] is None for m in READERS[2:])


@pytest.mark.cuda
def test_stretch_b_counts_every_kernel_launch(tiny_cell, cuda_device):
    cell = tiny_cell("orb512.seq962_c128")
    ctx = _ctx(cell, cuda_device)
    system = System(cell.config, cell.traffic, ctx["inputs"], cell.root, cuda_device)
    try:
        system.run()
        s = spans.stretches(ctx)
    finally:
        system.close()
    b = s["b"]
    assert b.kernels > 0 and b.launches == b.kernels
    seq = b.summary()["fs.stereo.sequence"]
    assert seq["count"] == cell.traffic["trace_sequences"] and 0 < seq["launches"] <= b.launches
    idle = sum(sp.idle_us for sp in b.spans) + b.outside_idle_us
    assert idle == pytest.approx(b.idle_us, rel=0.01)
    assert manifest.reader("launches_per_pair")(ctx) > 0
