"""Spans of the port's layers, on the device trace's clock.

    from forest_slam_tpu_torch.utils import trace

    with trace.recording(device=True) as tr:
        run_stereo_vo_device(...)
    tr.summary()  # per span name: count, host/self ms, device idle, launches

:func:`span` marks a layer boundary (``with trace.span("fs.pnp"): ...``).
With recording off it costs one flag check and returns a shared no-op
object; while a ``torch.profiler`` session records, it opens a profiler
range of the same name, so the profiler's own trace names the port's layers
beside the aten ops. :func:`recording` keeps the spans in memory: each one's
name, start, end, parent, sequence (every span under one
``fs.stereo.sequence`` shares its id) and attributes (counts such as
``frames`` and ``pairs``; an attribute never reads a device value, which
would synchronise). ``recording(device=True)`` runs the profiler (kineto, as
``torch.profiler`` does) itself and takes every span's times from the
profiler's events, so spans and kernels share one clock; it then splits the device's idle time in the window among
the innermost spans open over it (``(outside)`` where none is) and credits
each span with the device busy time in its interval and the kernel launches
made inside it, and with the device time of the kernels those launches
started (the profiler's correlation ids), wherever on the device's timeline
they ran (a kernel stamped just before the window opened included). That
kernel time is left None on a span open over a launch call whose kernels
the profiler did not record (no kernel of its correlation id).

One-shot spans (:func:`setup_span`: the kernel library, the checkpoint) and
the process's first ``fs.stereo.sequence`` with everything under it (marked
``first=True``: the warm-up every user pays) are kept even with recording
off, in :func:`setup`. A sequence that is kept also records a pair of CUDA
events, read only afterwards (:attr:`Span.device_s`), so its seconds on the
device's timeline are known without a synchronisation on the hot path.

Under an outside profiler the range is ``torch._C._profiler._RecordFunctionFast``:
a host range like ``torch.profiler.record_function``'s, without the copy that
``record_function`` adds to the device's timeline, which a reader taking the
union of device events as busy time would count as work. A device recording
opens ``record_function`` ranges and has the profiler observe that scope
alone, so no aten operation is recorded and the profiler's stop takes
seconds less; the ranges' device copies are left out of the join. Nothing is recorded on the
device, and no range is opened, while the current stream is being captured
into a CUDA graph. Spans are opened and closed by one host thread.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

SEQUENCE = "fs.stereo.sequence"
OUTSIDE = "(outside)"
WINDOW = "fs.recording"
# host calls that start a kernel, in the four forms a learned sequence makes
# on an H100 (67,743 + 606 + 42 + 62 calls for its 68,453 kernels); a graph
# launch counts as one
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaGraphLaunch"))

# the host range a span opens while a profiler records: outside a device
# recording, _RecordFunctionFast (no copy on the device's timeline); inside
# one, record_function, whose scope is the only one that recording observes
_FAST_RANGE = torch._C._profiler._RecordFunctionFast
_open_range = _FAST_RANGE
_ids = itertools.count(1)
_stack: list = []  # kept spans now open, innermost last
_active = None  # the Trace being recorded
_oneshot = 0  # one-shot spans now open
_keep = False  # _active is not None or _oneshot > 0
_first_sequence = True


def _update_keep() -> None:
    global _keep
    _keep = _active is not None or _oneshot > 0


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class _Null:
    """What :func:`span` returns with nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Range:
    """A profiler range only (a profiler records, recording is off)."""

    __slots__ = ("_rf",)

    def __init__(self, name):
        self._rf = None if _capturing() else _open_range(name)

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class Span:
    """One kept span. Times are microseconds: the host's performance
    counter, or, in a ``recording(device=True)``, the profiler's clock.
    After a device recording: ``busy_us`` (device busy in the interval),
    ``idle_us`` (device idle put down to this span as the innermost one
    open), ``tree_idle_us`` (the same with its descendants'), ``launches``
    (kernel launches made inside it) and ``kernel_us`` (device time of the
    kernels those launches started; None where the recording lost a kernel
    record of one of them, :func:`join`)."""

    __slots__ = ("name", "id", "parent", "seq", "attrs", "t0", "t1", "ranged", "busy_us", "idle_us",
                 "tree_idle_us", "launches", "kernel_us", "_oneshot", "_device", "_events", "_rf")

    def __init__(self, name: str, attrs: dict, oneshot: bool = False, device=None):
        self.name, self.attrs, self.id = name, attrs, next(_ids)
        self._oneshot, self._device = oneshot, device
        self.parent = self.seq = self.t0 = self.t1 = None
        self.busy_us = self.idle_us = self.tree_idle_us = self.launches = self.kernel_us = None
        self.ranged, self._events, self._rf = False, None, None

    def __enter__(self):
        global _oneshot
        if self._oneshot:
            _oneshot += 1
            _update_keep()
        outer = _stack[-1] if _stack else None
        self.parent = outer.id if outer is not None else None
        self.seq = self.id if self.name == SEQUENCE else (outer.seq if outer is not None else None)
        if _active is not None:
            _active.spans.append(self)
        if _oneshot:
            _SETUP.spans.append(self)
        _stack.append(self)
        if not _capturing():
            if _profiler._is_profiler_enabled:
                self._rf = _open_range(self.name)
                self._rf.__enter__()
                self.ranged = True
            if self._device is not None and self._device.type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                self._events[0].record(torch.cuda.current_stream(self._device))
        self.t0 = time.perf_counter_ns() / 1e3
        return self

    def __exit__(self, *exc):
        global _oneshot
        self.t1 = time.perf_counter_ns() / 1e3
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack.pop()
        if self._oneshot:
            _oneshot -= 1
            _update_keep()
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e3

    @property
    def device_s(self) -> float | None:
        """Seconds between the span's two CUDA events on the device's
        timeline (waits for the second one), or None without events."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1]) / 1e3


def span(name: str, **attrs):
    """A span named ``name`` (``fs.``-prefixed) with count attributes."""
    if _keep:
        return Span(name, attrs)
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _NULL


def setup_span(name: str, **attrs) -> Span:
    """A one-shot span, kept in :func:`setup` even with recording off, with
    every span opened under it. Set an attribute known only at the end with
    ``s.attrs[key] = value``."""
    return Span(name, attrs, oneshot=True)


def sequence(device, **attrs):
    """The span of one whole sequence on ``device`` (CUDA events when it is
    kept). The process's first is a one-shot span marked ``first=True``."""
    global _first_sequence
    if _first_sequence:
        _first_sequence = False
        return Span(SEQUENCE, dict(attrs, first=True), oneshot=True, device=torch.device(device))
    if _keep:
        return Span(SEQUENCE, attrs, device=torch.device(device))
    if _profiler._is_profiler_enabled:
        return _Range(SEQUENCE)
    return _NULL


class Trace:
    """The spans of one recording, in the order they opened, and, after a
    device recording, the join with the profiler's events."""

    def __init__(self):
        self.spans: list[Span] = []
        self.window_us = None  # (start, end) of a device recording
        self.busy_us = self.idle_us = None
        self.outside_idle_us = None
        self.outside_launches = None
        self.launches = None  # kernel launches in the window
        self.kernels = None  # kernels that ran on the device in the window
        self.lost_launches = None  # launch calls in the window with no kernel record
        self.device_events: list = []  # (start, end, name) of the device's work

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def summary(self) -> dict:
        """Per span name: count, host_ms, self_ms (less its children's),
        frames and pairs summed, and after a device recording busy_ms,
        idle_ms (as the innermost span), tree_idle_ms (with its
        descendants'), launches (inside it) and kernel_ms (the device time of
        the kernels those launches started, None where the recording lost a
        kernel record of a span of the name); ``(outside)`` holds the idle
        and launches with no span open. The device rows are None on a
        recording of host spans only."""
        joined = self.window_us is not None
        child_ms: dict = {}
        for s in self.spans:
            if s.parent is not None:
                child_ms[s.parent] = child_ms.get(s.parent, 0.0) + s.host_ms
        out: dict = {}
        for s in self.spans:
            r = out.setdefault(s.name, dict(count=0, host_ms=0.0, self_ms=0.0, frames=0, pairs=0, busy_ms=None,
                                            idle_ms=None, tree_idle_ms=None, launches=None, kernel_ms=None))
            r["count"] += 1
            r["host_ms"] += s.host_ms
            r["self_ms"] += s.host_ms - child_ms.get(s.id, 0.0)
            r["frames"] += s.attrs.get("frames", 0)
            r["pairs"] += s.attrs.get("pairs", 0)
            if joined:
                for key, v in (("busy_ms", s.busy_us / 1e3), ("idle_ms", s.idle_us / 1e3),
                               ("tree_idle_ms", s.tree_idle_us / 1e3), ("launches", s.launches)):
                    r[key] = (r[key] or 0) + v
                r["kernel_ms"] = None if s.kernel_us is None else (r["kernel_ms"] or 0) + s.kernel_us / 1e3
        if joined:
            out[OUTSIDE] = dict(count=0, idle_ms=self.outside_idle_us / 1e3, launches=self.outside_launches)
        return out

    def chrome_trace(self) -> dict:
        """The spans (host, thread 0) and the device's work (process 1) as
        a Chrome trace, which Perfetto and chrome://tracing open."""
        ev = [dict(ph="M", name="process_name", pid=0, args=dict(name="host: forest_slam_tpu_torch spans")),
              dict(ph="M", name="process_name", pid=1, args=dict(name="device"))]
        for s in self.spans:
            ev.append(dict(ph="X", name=s.name, cat="span", pid=0, tid=0, ts=s.t0, dur=s.t1 - s.t0,
                           args=dict(id=s.id, parent=s.parent, seq=s.seq, **s.attrs)))
        for a, b, name in self.device_events:
            ev.append(dict(ph="X", name=name, cat="device", pid=1, tid=0, ts=a, dur=b - a))
        return dict(traceEvents=ev, displayTimeUnit="ms")

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f, default=str)

    def _join_profiler(self, events) -> None:
        """Take the spans' times from the profiler's ranges (the k-th
        ranged span of a name is the k-th range of that name) and join them
        with the device's work and the launch calls. ``events``: the
        profiler's own (kineto) events, read in one pass as they are (the
        profiler's event tree, ``torch.profiler.profile.events()``, takes a
        minute to build for the half million events of two sequences);
        times relative to the window's start, in microseconds."""
        cuda = torch.autograd.DeviceType.CUDA
        host: dict = {}
        host_names, device, launches = set(), [], []
        for e in events:
            name = e.name()
            if name in LAUNCH_CALLS:
                launches.append((e.start_ns(), e.correlation_id()))
            elif e.device_type() == cuda:
                a = e.start_ns()
                device.append((a, a + e.duration_ns(), name, e.correlation_id()))
            else:
                host_names.add(name)
                if name.startswith("fs."):
                    a = e.start_ns()
                    host.setdefault(name, []).append((a, a + e.duration_ns()))
        if WINDOW not in host:
            raise RuntimeError("the profiler recorded no window range")
        (w0, w1), = host.pop(WINDOW)
        by_name: dict = {}
        for s in self.spans:
            if s.ranged:
                by_name.setdefault(s.name, []).append(s)
        for name, spans in by_name.items():
            got = sorted(host.get(name, []))
            if len(got) != len(spans):
                raise RuntimeError(f"{len(spans)} spans {name!r} but {len(got)} profiler ranges")
            for s, (a, b) in zip(spans, got):
                s.t0, s.t1 = (a - w0) / 1e3, (b - w0) / 1e3
        self.spans = [s for s in self.spans if s.ranged]
        # a host range's copy on the device's timeline (record_function's)
        # shares its name; a kernel never does
        device = [(a, b, n, c) for a, b, n, c in device if n not in host_names]
        # a launch call and the kernels it starts share a correlation id
        # (0: none); None marks a launch whose kernels the profiler lost
        by_corr: dict = {}
        for a, b, _, c in device:
            if c:
                by_corr[c] = by_corr.get(c, 0) + (b - a)
        join(self, [((a - w0) / 1e3, (b - w0) / 1e3, n) for a, b, n, _ in device],
             [(x - w0) / 1e3 for x, _ in launches], (0.0, (w1 - w0) / 1e3),
             [(by_corr[c] / 1e3 if c in by_corr else None) if c else 0.0 for _, c in launches])


def join(tr: Trace, device, launches, window, launch_us) -> None:
    """Join ``tr``'s spans with the device's work ``device`` ((start, end,
    name), microseconds), the start times of the launch calls and the
    window (start, end): fills the spans' busy, idle and launch fields and
    the trace's totals. A kernel is any device event but a copy or a set.
    ``launch_us`` holds the device microseconds of the kernels each launch
    call started, wherever they ran, summed into the spans' ``kernel_us``,
    or None where none of them was recorded: the ``kernel_us`` of a span
    open over such a call is None."""
    w0, w1 = window
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1)
    tr.device_events = dev
    tr.kernels = sum(1 for _, _, n in dev if not n.startswith(("Memcpy", "Memset")))
    u0, u1 = [], []
    for a, b, _ in dev:
        if u1 and a <= u1[-1]:
            u1[-1] = max(u1[-1], b)
        else:
            u0.append(a)
            u1.append(b)
    u0, u1 = np.asarray(u0, dtype=np.float64), np.asarray(u1, dtype=np.float64)
    cum = np.concatenate([[0.0], np.cumsum(u1 - u0)])

    def busy_before(t):
        """Device busy time before each time in ``t``."""
        t = np.asarray(t, dtype=np.float64)
        if not len(u0):
            return np.zeros_like(t)
        k = np.searchsorted(u0, t, side="right") - 1
        kk = np.clip(k, 0, None)
        return np.where(k >= 0, cum[kk] + np.clip(t - u0[kk], 0.0, u1[kk] - u0[kk]), 0.0)

    tr.window_us = (w0, w1)
    tr.busy_us = float(busy_before(w1) - busy_before(w0))
    tr.idle_us = (w1 - w0) - tr.busy_us
    spans = tr.spans
    index = {s.id: i for i, s in enumerate(spans)}
    children: dict = {}
    roots = []
    for s in spans:
        (children.setdefault(index[s.parent], []) if s.parent in index else roots).append(s)
    # self segments: each span's interval less its children's; the window's
    # segments outside every root span belong to (outside), index -1
    seg_i, seg_a, seg_b = [], [], []

    def gaps(i, a, b, inner):
        cur = a
        for c in sorted(inner, key=lambda c: c.t0) + [None]:
            end = b if c is None else min(c.t0, b)
            if end > cur:
                seg_i.append(i)
                seg_a.append(cur)
                seg_b.append(end)
            if c is not None:
                cur = max(cur, c.t1)

    for i, s in enumerate(spans):
        gaps(i, max(s.t0, w0), min(s.t1, w1), children.get(i, []))
    gaps(-1, w0, w1, roots)
    seg_a, seg_b = np.asarray(seg_a, dtype=np.float64), np.asarray(seg_b, dtype=np.float64)
    seg_idle = (seg_b - seg_a) - (busy_before(seg_b) - busy_before(seg_a))
    idle = np.zeros(len(spans) + 1)
    np.add.at(idle, np.asarray(seg_i, dtype=np.int64), seg_idle)
    t0 = np.asarray([s.t0 for s in spans], dtype=np.float64)
    t1 = np.asarray([s.t1 for s in spans], dtype=np.float64)
    busy = busy_before(np.clip(t1, w0, w1)) - busy_before(np.clip(t0, w0, w1))
    lt = np.asarray(launches, dtype=np.float64)
    inside = (lt >= w0) & (lt <= w1)
    order = np.argsort(lt[inside], kind="stable")
    lt = lt[inside][order]
    first, last = np.searchsorted(lt, t0, side="left"), np.searchsorted(lt, t1, side="right")
    n_launch = last - first
    lus = np.asarray([np.nan if v is None else v for v in launch_us], dtype=np.float64)[inside][order]
    lost = np.isnan(lus)
    tr.lost_launches = int(lost.sum())
    cum_k = np.concatenate([[0.0], np.cumsum(np.where(lost, 0.0, lus))])
    cum_lost = np.concatenate([[0], np.cumsum(lost)])
    kernel = cum_k[last] - cum_k[first]
    whole = cum_lost[last] == cum_lost[first]
    for i, s in enumerate(spans):
        s.busy_us, s.idle_us, s.launches = float(busy[i]), float(idle[i]), int(n_launch[i])
        s.kernel_us = float(kernel[i]) if whole[i] else None
        s.tree_idle_us = s.idle_us
    for i in range(len(spans) - 1, -1, -1):  # children open after their parents
        p = spans[i].parent
        if p in index:
            spans[index[p]].tree_idle_us += spans[i].tree_idle_us
    tr.outside_idle_us = float(idle[-1])
    tr.launches = int(len(lt))
    tr.outside_launches = tr.launches - sum(s.launches for s in roots)


_SETUP = Trace()


def setup() -> Trace:
    """The process's one-shot spans: the kernel library, checkpoints, and
    the first sequence with its children."""
    return _SETUP


@contextlib.contextmanager
def recording(device: bool = False):
    """Keep every span opened inside in the yielded :class:`Trace`. With
    ``device``, run the profiler (host and, where there is a card, CUDA
    activity) over the body, observing only ``record_function``'s scope, so
    the spans' ranges are the only host operations it keeps beside the
    launch calls; synchronise the card at the body's end; then join the
    spans with the profiler's events (:func:`join`)."""
    global _active, _open_range
    if _active is not None:
        raise RuntimeError("a recording is already open")
    tr = Trace()
    if device:
        if _profiler._is_profiler_enabled:
            raise RuntimeError("a torch.profiler session is already recording")
        from torch._C._profiler import ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
        acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if torch.cuda.is_available() else set())
        _profiler._prepare_profiler(config, acts)
        _profiler._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        _profiler._run_on_profiler_start()
        _open_range = _profiler.record_function
    _active = tr
    _update_keep()
    window = result = None
    try:
        if device:
            window = _open_range(WINDOW)
            window.__enter__()
        yield tr
        if device and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        if window is not None:
            window.__exit__(None, None, None)
        _active = None
        _update_keep()
        if device:
            result = _profiler._disable_profiler()
            _profiler._run_on_profiler_stop()
            _open_range = _FAST_RANGE
    if device:
        tr._join_profiler(result.events())
