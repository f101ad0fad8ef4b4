"""The port's own spans (forest_slam_tpu_torch/utils/trace.py) over a
cell's sequences, read by the per-layer metrics named after them.

After the harness's traced stretches, a second :class:`bench_port.system.System`
over the same inputs runs ``trace_sequences`` sequences under
``trace.recording()`` (stretch A: host spans only, no profiler and no
synchronisation but the one that ends each sequence, as in the window) and as
many under ``trace.recording(device=True)`` (stretch B: the spans joined with
the profiler's events: device idle by span and kernel launches). The
harness's ``System.close()`` puts the runner's per-pair call back; this
second System is not closed. The first reader of a run measures, the others
read the same result. One ``# spans:`` line on standard error gives both
stretches' summaries and the seconds this adds to the run. A port without
the spans (no ``utils/trace.py``) gives nothing to read: no stretch runs and
every reader returns None.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

_last = None  # (ctx, result) of the run being read


def stretches(ctx) -> dict | None:
    """{"a": Trace, "b": Trace, "first": the process's first sequence span
    or None} for the run whose reader context is ``ctx``; None where the
    port records no spans."""
    global _last
    if _last is not None and _last[0] is ctx:
        return _last[1]
    try:
        from forest_slam_tpu_torch.utils import trace
    except ImportError:
        _last = (ctx, None)
        return None
    from bench_port import manifest
    from bench_port.system import System

    t_start = time.perf_counter()
    inputs, n = ctx["inputs"], ctx["traffic"]["trace_sequences"]
    device = inputs["left"].device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    system = System(ctx["config"], ctx["traffic"], inputs, manifest.ROOT, device, ctx["frontend"])
    seconds, t_built = [], time.perf_counter()
    with trace.recording() as a:
        for _ in range(n):
            t0 = time.perf_counter()
            system.run()
            sync()
            seconds.append(time.perf_counter() - t0)
    t_a = time.perf_counter()
    with trace.recording(device=True) as b:
        for _ in range(n):
            system.run()
            sync()
        t_b = time.perf_counter()
    t_joined = time.perf_counter()
    first = [s for s in trace.setup().find(trace.SEQUENCE) if s.attrs.get("first")]
    result = dict(a=a, b=b, first=first[0] if first else None)
    w = ctx["window"]
    line = dict(added_s=time.perf_counter() - t_start,
                parts_s=dict(system=t_built - t_start, a=t_a - t_built, b=t_b - t_a, stop_and_join=t_joined - t_b),
                a_sequence_s=seconds, window_sequence_s=w["seconds"] / w["sequences"] if w["sequences"] else None,
                a_device_s=[s.device_s for s in a.find(trace.SEQUENCE)],
                first_device_s=result["first"].device_s if result["first"] else None,
                b_window_ms=(b.window_us[1] - b.window_us[0]) / 1e3, b_idle_ms=b.idle_us / 1e3,
                b_idle_by_span_ms=sum(s.idle_us for s in b.spans) / 1e3, b_launches=b.launches, b_kernels=b.kernels,
                a=a.summary(), b=b.summary())
    print("# spans: " + json.dumps(line), file=sys.stderr, flush=True)
    _last = (ctx, result)
    return result


def row(ctx, stretch: str, name: str):
    """The summary row of the spans ``name`` in stretch ``"a"`` or ``"b"``;
    None where there is no such span, and in stretch B where the trace holds
    no kernel (no card)."""
    s = stretches(ctx)
    if s is None or (stretch == "b" and not s["b"].kernels):
        return None
    return s[stretch].summary().get(name)


def warmup_excess_s(ctx):
    """The first sequence's seconds on the device's timeline less the median
    of stretch A's, or None without CUDA events."""
    s = stretches(ctx)
    if s is None or s["first"] is None or s["first"].device_s is None:
        return None
    warm = [q.device_s for q in s["a"].find("fs.stereo.sequence")]
    if not warm or None in warm:
        return None
    return s["first"].device_s - statistics.median(warm)
