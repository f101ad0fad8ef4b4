"""The traced stretch of a run: a fixed number of sequences under
``torch.profiler``, reduced to the device's busy time in the traced window,
each kernel's device time and launches, the longest idle gaps labelled by
the host operation running in them, and the device operations that took
most time. Nothing is written to disk."""

from __future__ import annotations

import re

import numpy as np
import torch

WINDOW = "bench_port.window"


def kernel_name(name: str) -> str:
    """A kernel's function name: no return type, namespace arguments or
    template arguments."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


def profile_sequences(run, n: int, sync) -> dict:
    """Run ``run()`` ``n`` times under the profiler and reduce the trace:
    window_s, busy_s, kernels (name -> [launches, device seconds]), device
    intervals, device_ops and idle_gaps (each the ten largest)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                run()
            sync()
    dev, host, w0, w1 = [], [], None, None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name == WINDOW:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                w0, w1 = start, end
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window span")
    dev = [(max(s, w0), min(e, w1), n_) for s, e, n_ in dev if e > w0 and s < w1]
    dev.sort()
    kernels: dict = {}
    for s, e, n_ in dev:
        k = kernels.setdefault(kernel_name(n_), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e6
    busy, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    idle = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(host) else []
        label = host[int(inside[np.argmax(hs[inside])])][2] if len(inside) else "(no host op)"
        idle.append([label, (g1 - g0) / 1e6])
    ops = sorted(([k, v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernels=kernels, device_ops=ops, idle_gaps=idle,
                sequences=n)
