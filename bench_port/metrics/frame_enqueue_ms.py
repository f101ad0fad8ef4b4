"""Host milliseconds a frame of the per-frame phase: the
``fs.stereo.frame_chunk`` spans of stretch A (spans only, nothing
synchronised inside a sequence; bench_port/spans.py) over their frames. The
time the host takes to enqueue a frame chunk, or to wait inside it."""

from bench_port import spans


def read(ctx):
    r = spans.row(ctx, "a", "fs.stereo.frame_chunk")
    return r["host_ms"] / r["frames"] if r and r["frames"] else None
