"""Share of the per-frame phase's host time in which the card sat idle: the
device idle of stretch B (the spans joined with the profiler's trace;
bench_port/spans.py) put down to ``fs.stereo.frame_chunk`` spans and their
children as the innermost spans open, over those spans' host time. None
where the trace holds no kernel."""

from bench_port import spans


def read(ctx):
    r = spans.row(ctx, "b", "fs.stereo.frame_chunk")
    return r["tree_idle_ms"] / r["host_ms"] if r and r["host_ms"] > 0 else None
