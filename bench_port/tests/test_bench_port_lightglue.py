"""The cell sp_lightglue.seq962 and its front end, frontends/superpoint_lightglue.py:
a correct result line at a tiny size on the CPU, the weights drawn from the
seed, the matcher's operation count, the guard's reading of the new
files, and the readers of the matcher's spans."""

import json
import os

import pytest
import torch

from bench_port import guard, manifest, run, spans
from bench_port.system import System

CELL = "sp_lightglue.seq962"


def test_cell_prints_a_correct_result_line(tiny_cell):
    cell = tiny_cell(CELL)
    result, lines = run.run_cell(cell, 2 ** 31 + 23, 0.2, False, "cpu")
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and list(line)[-1] == "check"
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"} and line["attempted"] >= cell.traffic["n_frames"] - 1
    assert [ln.split()[1] for ln in lines] == list(cell.limits)


def test_weights_repeat_with_the_seed_and_the_port_gets_a_copy(tiny_cell):
    cell = tiny_cell(CELL)
    fe, cfg = cell.frontend, cell.config
    a, b = fe.weights(cfg, cell.root, 2 ** 31 + 1, "cpu"), fe.weights(cfg, cell.root, 2 ** 31 + 1, "cpu")
    c = fe.weights(cfg, cell.root, 7, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformers.0.self_attn.Wqkv.weight"], c["transformers.0.self_attn.Wqkv.weight"])
    assert all(v.dtype == torch.float32 for v in a.values())
    L = cfg["lightglue_layers"]
    assert {int(k.split(".")[1]) for k in a if k.startswith("transformers.")} == set(range(L))
    q = a[f"log_assignment.{L - 1}.final_proj.weight"] / cfg["assumed"]["assign_scale"]
    torch.testing.assert_close(q @ q.t(), torch.eye(cfg["descriptor_dim"]), atol=1e-5, rtol=0)

    from bench_port import traffic

    seen = {}
    program = fe.program

    def spy(cfg_, stereo_cfg, inputs, root, device):
        seen["w"] = inputs["weights"]
        return program(cfg_, stereo_cfg, inputs, root, device)

    inputs = traffic.make_inputs(cell.traffic, cfg, 2 ** 31 + 1, "cpu", fe)
    inputs["weights"] = a
    spied = type("frontend", (), dict(program=staticmethod(spy)))
    system = System(cfg, cell.traffic, inputs, cell.root, "cpu", spied)
    system.close()
    assert seen["w"].keys() == a.keys()
    assert all(torch.equal(seen["w"][k], a[k]) and seen["w"][k].data_ptr() != a[k].data_ptr() for k in a)


def test_matrix_products_count_lightglue_at_2048_keypoints():
    """Sec. A of the model at K=2048, D=256, 9 layers: 227,096,395,776 FLOP
    in the layers (S once a cross layer) and 2,684,354,560 in the
    assignment's final projections and similarity."""
    cell = manifest.load_cell(CELL)
    fe, cfg = cell.frontend, cell.config
    assert fe.keypoints(cfg) == 2048
    assert fe.matcher_matrix_flops(cfg, 2048) == 229_780_750_336
    layers = 9 * (fe.self_layer_flops(1, 2048, 256) + fe.cross_layer_flops(1, 2048, 256))
    assert layers == 227_096_395_776 and fe.assign_flops(2048, 256) == 2_684_354_560
    frame, pair, *_ = fe.costs(600, 960, cfg)
    assert pair > fe.matcher_matrix_flops(cfg, 2048) and frame > 0


def test_guard_finds_nothing_forbidden_in_the_new_files():
    """The reference imports neither the port nor the JAX stack; the front
    end imports the port only inside ``program``, and nothing of the JAX
    stack."""
    ref = os.path.join(manifest.HERE, "reference", "lightglue.py")
    assert not set(guard.imported_names(ref)) & {"forest_slam_tpu_torch", *guard.FORBIDDEN}
    fe = os.path.join(manifest.HERE, "frontends", "superpoint_lightglue.py")
    assert not set(guard.imported_names(fe)) & set(guard.FORBIDDEN)
    assert guard.scan(manifest.HERE) == {}



def _span(name, t0, t1, parent=None, **attrs):
    from forest_slam_tpu_torch.utils import trace

    s = trace.Span(name, attrs)
    s.t0, s.t1, s.parent, s.ranged = t0, t1, parent, True
    return s


def test_span_readers_take_the_kernels_launched_inside_the_spans():
    """A hand-made stretch B: a pair chunk of 4 pairs holding one self, one
    cross and one assign span; each launch's kernels are credited to the
    spans open over the launch call, wherever they ran on the device."""
    from forest_slam_tpu_torch.utils import trace

    chunk = _span("fs.stereo.pair_chunk", 0, 100, pairs=4)
    kids = [_span(n, a, b, chunk.id) for n, a, b in (("fs.lightglue.self", 10, 20), ("fs.lightglue.cross", 20, 30),
                                                        ("fs.lightglue.assign", 40, 50))]
    b = trace.Trace()
    b.spans = [chunk, *kids]
    trace.join(b, [(60, 90, "k1"), (90, 120, "k2"), (120, 150, "k3"), (150, 180, "k4")], [12, 25, 45, 70],
               (0, 200), [30.0, 50.0, 8.0, 100.0])
    assert _readers(b) == (pytest.approx(0.080 / 4), pytest.approx(0.008 / 4))


def _readers(b):
    """(lightglue_layers_ms, lightglue_assign_ms) of a stretch B ``b``."""
    from forest_slam_tpu_torch.utils import trace

    ctx = {}
    spans._last = (ctx, dict(a=trace.Trace(), b=b, first=None))
    try:
        return manifest.reader("lightglue_layers_ms")(ctx), manifest.reader("lightglue_assign_ms")(ctx)
    finally:
        spans._last = None


def _stretch(lost=None):
    """Two pair chunks, of 4 and 2 pairs, each holding one self, one cross
    and one assign span, joined with one kernel a launch; ``lost``: the
    profiler lost the kernel record of the first chunk's cross launch
    ("record"), or those of every chunk's cross and assign launches
    ("every"), or every launch's ("all")."""
    from forest_slam_tpu_torch.utils import trace

    b = trace.Trace()
    for t, pairs in ((0, 4), (100, 2)):
        chunk = _span("fs.stereo.pair_chunk", t, t + 100, pairs=pairs)
        match = _span("fs.frontend.match", t + 5, t + 60, chunk.id)
        b.spans += [chunk, match] + [_span(n, t + a, t + z, match.id) for n, a, z in (
            ("fs.lightglue.self", 10, 20), ("fs.lightglue.cross", 20, 30), ("fs.lightglue.assign", 40, 50))]
    launches = [12, 25, 45, 70, 112, 125, 145, 170]
    us = [30.0, 50.0, 8.0, 100.0, 10.0, 20.0, 4.0, 60.0]
    for i in {"record": [1], "every": [1, 2, 5, 6], "all": range(8)}.get(lost, []):
        us[i] = None
    kernels = [(200 + 10 * i, 205 + 10 * i, f"k{i}") for i, u in enumerate(us) if u is not None]
    trace.join(b, kernels, launches, (0, 300), us)
    return b


@pytest.mark.parametrize("lost", [None, "record"])
def test_span_readers_read_the_chunks_whose_kernels_were_all_recorded(lost):
    """Both chunks are read where every kernel was recorded; where the
    first chunk's cross launch lost its kernel record, that chunk is left
    out of both readings, and the second chunk's pairs carry them."""
    if lost is None:
        want = ((30 + 50 + 10 + 20) / 1e3 / 6, (8 + 4) / 1e3 / 6)
    else:
        want = ((10 + 20) / 1e3 / 2, 4 / 1e3 / 2)
    assert _readers(_stretch(lost)) == (pytest.approx(want[0]), pytest.approx(want[1]))


@pytest.mark.parametrize("lost", ["every", "all"])
def test_span_readers_read_nothing_where_kernel_records_were_lost(lost):
    """Where every chunk's spans lost a kernel record ("every"), or every
    launch did ("all"), both readers give None, not a low number."""
    assert _readers(_stretch(lost)) == (None, None)
