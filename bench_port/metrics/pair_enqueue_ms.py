"""Host milliseconds a pair of the per-pair phase: the
``fs.stereo.pair_chunk`` spans of stretch A (spans only, nothing
synchronised inside a sequence; bench_port/spans.py) over their pairs. The
time the host takes to enqueue a pair chunk, or to wait inside it."""

from bench_port import spans


def read(ctx):
    r = spans.row(ctx, "a", "fs.stereo.pair_chunk")
    return r["host_ms"] / r["pairs"] if r and r["pairs"] else None
