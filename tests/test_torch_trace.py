"""The port's spans (forest_slam_tpu_torch/utils/trace.py).

- spans nest: parent and sequence ids, self time, counts as attributes;
- with recording off nothing is kept but the one-shot spans (the set-up's,
  and the process's first sequence with its children), and a span is one
  shared no-op object;
- a profiler range of each span's name appears under an outside
  ``torch.profiler`` session, and no range is opened without one;
- the join with a profiler trace, on a hand-built event list: the device's
  idle split by overlap among the innermost spans, ``(outside)``, busy time
  and launches counted inside spans, and the device copies of host ranges
  and the copies and sets left out of the kernels;
- the stereo runner gives bit-identical poses, flags and matches with
  recording off, on and on with the device, and its spans nest as the
  layers do;
- the benchmark's system (bench_port/system.py) still clocks the phases and
  captures the refined observations with the spans in place;
- ``cli stereo --trace-out`` writes a Chrome trace whose spans nest.
"""

import json
import time

import pytest
import torch

from bench_port import manifest, traffic
from bench_port.system import System
from bench_port.tests.conftest import tiny
from forest_slam_tpu_torch import cli
from forest_slam_tpu_torch.pipelines import stereo
from forest_slam_tpu_torch.utils import trace
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def fresh_setup(monkeypatch):
    """A process whose first sequence has not run, with no one-shot span."""
    monkeypatch.setattr(trace, "_first_sequence", True)
    monkeypatch.setattr(trace, "_SETUP", trace.Trace())
    return trace.setup


def test_spans_nest_with_parent_sequence_ids_and_self_time():
    with trace.recording() as tr:
        with trace.span("fs.outer", frames=4):
            time.sleep(0.002)
            with trace.span("fs.inner", pairs=3):
                time.sleep(0.004)
            with trace.sequence("cpu", frames=2, pairs=1) as seq:
                with trace.span("fs.leaf"):
                    pass
    outer, inner, seq_, leaf = tr.spans
    assert seq_ is seq and [s.name for s in tr.spans] == ["fs.outer", "fs.inner", trace.SEQUENCE, "fs.leaf"]
    assert outer.parent is None and inner.parent == outer.id and seq.parent == outer.id and leaf.parent == seq.id
    assert outer.seq is None and inner.seq is None and seq.seq == seq.id and leaf.seq == seq.id
    assert outer.t0 <= inner.t0 <= inner.t1 <= seq.t0 <= leaf.t0 <= leaf.t1 <= seq.t1 <= outer.t1
    rows = tr.summary()
    assert rows["fs.outer"]["frames"] == 4 and rows["fs.inner"]["pairs"] == 3 and rows[trace.SEQUENCE]["pairs"] == 1
    assert rows["fs.outer"]["self_ms"] == pytest.approx(outer.host_ms - inner.host_ms - seq.host_ms)
    assert rows["fs.inner"]["self_ms"] == rows["fs.inner"]["host_ms"] >= 4.0
    assert rows["fs.outer"]["idle_ms"] is None and trace.OUTSIDE not in rows
    assert seq.device_s is None  # no CUDA events on the CPU


def test_recording_off_keeps_only_the_one_shot_spans(fresh_setup):
    assert trace.span("fs.a") is trace.span("fs.b", frames=1)  # the shared no-op
    with trace.span("fs.before"):
        pass
    with trace.setup_span("fs.setup.thing", built=False) as s:
        with trace.span("fs.setup.thing.part"):
            pass
        s.attrs["built"] = True
    with trace.sequence("cpu", frames=3, pairs=2):
        with trace.span("fs.stereo.frame_chunk", frames=3):
            pass
    with trace.sequence("cpu", frames=3, pairs=2):  # not the first: not kept
        with trace.span("fs.stereo.frame_chunk", frames=3):
            pass
    with trace.span("fs.after"):
        pass
    kept = fresh_setup().spans
    assert [s.name for s in kept] == ["fs.setup.thing", "fs.setup.thing.part", trace.SEQUENCE,
                                      "fs.stereo.frame_chunk"]
    assert kept[0].attrs == {"built": True} and kept[1].parent == kept[0].id
    assert kept[2].attrs == {"frames": 3, "pairs": 2, "first": True} and kept[3].seq == kept[2].id
    assert not trace._stack and not trace._keep


def test_profiler_ranges_only_under_an_outside_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert not isinstance(trace.span("fs.free"), trace._Range)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("fs.profiled"):
            torch.ones(4).sum()
        with trace.recording() as tr:
            with trace.span("fs.kept"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("fs.profiled") == 1 and names.count("fs.kept") == 1
    assert tr.spans[0].ranged
    with trace.recording() as tr:
        with trace.span("fs.unprofiled"):
            pass
    assert not tr.spans[0].ranged


class _Event:
    """A profiler (kineto) event: nanoseconds, the window starting at 1 ms."""

    def __init__(self, name, start, end, on_device=False, corr=0):
        self._name, self._start, self._end, self._on = name, 1_000_000 + 1000 * start, 1_000_000 + 1000 * end, on_device
        self._corr = corr

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._on else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr



def _hand_spans(tr):
    """A [10, 60] holding B [20, 40], then C [70, 90], in window [0, 100]."""
    a, b, c = (trace.Span(n, {}) for n in ("fs.a", "fs.b", "fs.c"))
    for s, (t0, t1), parent in ((a, (10, 60), None), (b, (20, 40), a.id), (c, (70, 90), None)):
        s.t0, s.t1, s.parent, s.ranged = t0, t1, parent, True
    tr.spans = [a, b, c]
    return a, b, c


def test_join_splits_idle_by_overlap_and_counts_launches():
    tr = trace.Trace()
    a, b, c = _hand_spans(tr)
    device = [(0, 5, "k0"), (15, 25, "k1"), (30, 35, "Memset (Device)"), (50, 75, "k2"), (95, 100, "k3"),
              (96, 99, "k4")]
    trace.join(tr, device, [12, 22, 45, 65, 80, 99, 120], (0, 100), [0.0] * 7)
    assert tr.busy_us == 50 and tr.idle_us == 50 and tr.kernels == 5 and tr.launches == 6
    assert (a.idle_us, b.idle_us, c.idle_us, tr.outside_idle_us) == (15, 10, 15, 10)
    assert a.tree_idle_us == 25 and b.tree_idle_us == 10
    assert (a.busy_us, b.busy_us, c.busy_us) == (25, 10, 5)
    assert (a.launches, b.launches, c.launches, tr.outside_launches) == (3, 1, 1, 2)
    rows = tr.summary()
    assert rows[trace.OUTSIDE] == dict(count=0, idle_ms=0.01, launches=2)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(tr.idle_us / 1e3)


def test_join_from_profiler_events_takes_the_ranges_times():
    tr = trace.Trace()
    a, b, c = _hand_spans(tr)
    for s in (a, b, c):  # host-clock times, replaced by the ranges'
        s.t0, s.t1 = s.t0 + 1e6, s.t1 + 1e6
    events = [_Event(trace.WINDOW, 0, 100), _Event("fs.a", 10, 60), _Event("fs.b", 20, 40), _Event("fs.c", 70, 90),
              _Event("fs.a", 10, 60, True), _Event("my_range", 0, 100), _Event("my_range", 1, 99, True),
              _Event("k1", 15, 25, True), _Event("k2", 50, 75, True), _Event("cudaLaunchKernel", 12, 13),
              _Event("cudaLaunchKernelExC", 71, 72), _Event("cudaMemsetAsync", 73, 74), _Event("aten::add", 11, 14)]
    tr._join_profiler(events)
    assert (a.t0, a.t1, c.t0, c.t1) == (10, 60, 70, 90)
    assert tr.busy_us == 35 and tr.kernels == 2 and tr.launches == 2
    assert (a.launches, c.launches, tr.outside_launches) == (1, 1, 0)
    assert [d[2] for d in tr.device_events] == ["k1", "k2"]
    assert (a.kernel_us, b.kernel_us, c.kernel_us) == (0, 0, 0)  # no correlation ids: nothing credited
    tr2 = trace.Trace()
    _hand_spans(tr2)
    with pytest.raises(RuntimeError, match="profiler ranges"):
        tr2._join_profiler([_Event(trace.WINDOW, 0, 100), _Event("fs.a", 10, 60)])


def test_join_credits_each_kernel_to_the_span_that_launched_it():
    """A kernel's device time goes to the spans open over its launch call,
    matched by correlation id, wherever on the device's timeline it ran: B's
    launch at 22 starts k1 and k2 (both run after B has closed), A's launch
    at 12 starts k0, C's at 71 a kernel that runs at 95, and a launch at 45
    (A alone) starts k4; a host range's device copy credits nothing."""
    tr = trace.Trace()
    a, b, c = _hand_spans(tr)
    events = [_Event(trace.WINDOW, 0, 100), _Event("fs.a", 10, 60), _Event("fs.b", 20, 40), _Event("fs.c", 70, 90),
              _Event("fs.b", 41, 90, True, corr=7), _Event("cudaLaunchKernel", 12, 13, corr=5),
              _Event("cudaLaunchKernel", 22, 23, corr=7), _Event("cudaLaunchKernel", 45, 46, corr=9),
              _Event("cudaLaunchKernelExC", 71, 72, corr=11), _Event("k0", 14, 18, True, corr=5),
              _Event("k1", 50, 60, True, corr=7), _Event("k2", 60, 63, True, corr=7),
              _Event("k3", 95, 99, True, corr=11), _Event("k4", 30, 31, True, corr=9)]
    tr._join_profiler(events)
    assert tr.lost_launches == 0
    assert (a.kernel_us, b.kernel_us, c.kernel_us) == (18, 13, 4)
    assert (a.launches, b.launches, c.launches) == (3, 1, 1)
    rows = tr.summary()
    assert rows["fs.b"]["kernel_ms"] == pytest.approx(0.013) and rows["fs.a"]["kernel_ms"] == pytest.approx(0.018)


@pytest.mark.parametrize("lost", ["record", "burst"])
def test_join_refuses_kernel_time_when_kernel_records_are_lost(lost):
    """A span open over a launch call whose correlation id has no kernel is
    credited no kernel time (None, not a low number): A and B over the
    launch at 22, but not C ("record"); all three where the launches at 22
    and 71 both lost their kernels ("burst"). Busy, idle and launch counts
    are joined as before."""
    tr = trace.Trace()
    a, b, c = _hand_spans(tr)
    events = [_Event(trace.WINDOW, 0, 100), _Event("fs.a", 10, 60), _Event("fs.b", 20, 40), _Event("fs.c", 70, 90),
              _Event("cudaLaunchKernel", 12, 13, corr=5), _Event("cudaLaunchKernel", 22, 23, corr=7),
              _Event("cudaLaunchKernelExC", 71, 72, corr=11), _Event("k0", 14, 18, True, corr=5),
              _Event("k5", 30, 31, True, corr=13)]
    if lost == "record":
        events += [_Event("k3", 95, 99, True, corr=11)]
    tr._join_profiler(events)
    assert tr.launches == 3 and tr.lost_launches == (1 if lost == "record" else 2)
    assert (a.kernel_us, b.kernel_us, c.kernel_us) == (None, None, 4 if lost == "record" else None)
    assert (a.launches, b.launches, c.launches) == (2, 1, 1)
    rows = tr.summary()
    assert all(rows[n]["kernel_ms"] is None for n in ("fs.a", "fs.b"))
    assert rows["fs.c"]["kernel_ms"] == (pytest.approx(0.004) if lost == "record" else None)
    assert rows["fs.a"]["launches"] == 2
    assert rows["fs.a"]["busy_ms"] == pytest.approx(0.005)


def test_join_credits_a_kernel_stamped_before_the_window_opened():
    """B's launch at 22 starts k1, stamped before the window opened. Its
    device time is credited to A and B by correlation id, and left out of
    the window's kernels and busy time."""
    tr = trace.Trace()
    a, b, c = _hand_spans(tr)
    events = [_Event(trace.WINDOW, 0, 100), _Event("fs.a", 10, 60), _Event("fs.b", 20, 40), _Event("fs.c", 70, 90),
              _Event("cudaLaunchKernel", 12, 13, corr=5), _Event("cudaLaunchKernel", 22, 23, corr=7),
              _Event("cudaLaunchKernelExC", 71, 72, corr=11), _Event("k0", 14, 18, True, corr=5),
              _Event("k3", 95, 99, True, corr=11), _Event("k1", -5, -2, True, corr=7)]
    tr._join_profiler(events)
    assert tr.launches == 3 and tr.kernels == 2 and tr.lost_launches == 0
    assert (a.kernel_us, b.kernel_us, c.kernel_us) == (7, 3, 4)
    assert tr.busy_us == 8


@pytest.fixture(scope="module")
def orb_system():
    """The benchmark's ORB cell at 128x96, 9 frames in chunks of 4 frames
    and 3 pairs, on the CPU; its wrapper put back after the module."""
    original = stereo.pair_from_slab
    cell = tiny(manifest.load_cell("orb512.seq962_c128"))
    inputs = traffic.make_inputs(cell.traffic, cell.config, 5, "cpu")
    system = System(cell.config, cell.traffic, inputs, cell.root, "cpu")
    yield system
    system.close()
    assert stereo.pair_from_slab is original


def _run(system):
    i = system.inputs
    outs, art = stereo.run_stereo_vo_device(i["left"], i["right"], system.rig, system.cfg, None, system.frontend,
                                            frame_batch=4, pair_batch=3, return_artifacts=True, gumbel=i["gumbel"],
                                            uniform=i["uniform"])
    return outs.pose, outs.ok, art.matches


def test_runner_is_bit_identical_with_recording_on_and_off(orb_system):
    off = _run(orb_system)
    with trace.recording() as host:
        on = _run(orb_system)
    with trace.recording(device=True) as dev:
        on_dev = _run(orb_system)
    for x, y, z in zip(off, on, on_dev):
        assert torch.equal(x, y) and torch.equal(x, z)
    rows = host.summary()
    assert rows[trace.SEQUENCE]["count"] == 1 and rows[trace.SEQUENCE]["pairs"] == 8
    assert rows["fs.stereo.frame_chunk"]["count"] == 3 and rows["fs.stereo.frame_chunk"]["frames"] == 9
    assert rows["fs.stereo.pair_chunk"]["count"] == 3 and rows["fs.stereo.pair_chunk"]["pairs"] == 8
    assert rows["fs.stereo.slab"]["count"] == rows["fs.stereo.chain"]["count"] == 1
    for child in ("fs.frontend.extract", "fs.stereo.depth"):
        assert rows[child]["count"] == 3
    for child in ("fs.frontend.match", "fs.pnp", "fs.stereo.gate"):
        assert rows[child]["count"] == 3
    assert "fs.frontend.refine" not in rows  # ORB runs no refinement
    by_id = {s.id: s for s in host.spans}
    for s in host.spans:
        if s.name in ("fs.frontend.extract", "fs.stereo.depth"):
            assert by_id[s.parent].name == "fs.stereo.frame_chunk"
        if s.name in ("fs.frontend.match", "fs.pnp", "fs.stereo.gate"):
            assert by_id[s.parent].name == "fs.stereo.pair_chunk"
    assert [s.name for s in dev.spans] == [s.name for s in host.spans]
    drows = dev.summary()
    total = sum(r["idle_ms"] for r in drows.values())
    assert total == pytest.approx(dev.idle_us / 1e3, rel=1e-6)  # no kernel on the CPU: all idle
    assert dev.kernels == 0 and drows[trace.SEQUENCE]["launches"] == 0


def test_system_clocks_phases_and_captures_obs_with_spans(orb_system):
    with trace.recording() as tr:
        with orb_system.phase_clocks(lambda: None) as clocks:
            outs, art, obs = orb_system.run()
    assert clocks["frames"] == 9 and clocks["pairs"] == 8 and clocks["frame_s"] > 0 and clocks["pair_s"] > 0
    assert obs is not None and obs.shape[0] == 8
    rows = tr.summary()
    assert rows["fs.stereo.frame_chunk"]["frames"] == 9 and rows["fs.stereo.pair_chunk"]["pairs"] == 8
    # the harness's clocks run inside the chunk spans, around the same calls
    assert rows["fs.stereo.pair_chunk"]["host_ms"] >= 1e3 * clocks["pair_s"]
    outs2, _, obs2 = orb_system.run()
    assert torch.equal(outs.pose, outs2.pose) and torch.equal(obs, obs2)


def test_cli_trace_out_writes_a_nested_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    rc = cli.main(["stereo", "--synthetic", "5", "--out", str(tmp_path / "est.txt"), "--device", "cpu",
                   "--compose-mode", "odometry", "--trace-out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    spans = {e["args"]["id"]: e for e in doc["traceEvents"] if e.get("cat") == "span"}
    names = {e["name"] for e in spans.values()}
    assert {trace.SEQUENCE, "fs.stereo.frame_chunk", "fs.stereo.pair_chunk", "fs.pnp"} <= names
    for e in spans.values():
        parent = spans.get(e["args"]["parent"])
        if parent is not None:
            assert parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
            assert e["args"]["seq"] == parent["args"]["seq"] or e["name"] == trace.SEQUENCE
