"""Device milliseconds a pair in LightGlue's layers: the device time of the
kernels launched inside the ``fs.lightglue.self`` and ``fs.lightglue.cross``
spans (``kernel_us`` of stretch B's join, bench_port/spans.py: each kernel
credited by correlation id to the spans open over its launch call), over
the pairs of the ``fs.stereo.pair_chunk`` spans that hold them. The
profiler loses a few kernel records now and then (a recording's first
launches, a burst of consecutive ones), and the join leaves a span over a
lost record without kernel time: a pair chunk with such a span is left
out, and the others are read.
None where the port has no such spans or credits no kernel to them."""

from bench_port import spans

CHUNK = "fs.stereo.pair_chunk"


def per_pair(ctx, names):
    """Kernel milliseconds a pair of the spans ``names`` in stretch B, over
    the pair chunks whose spans of those names all have their kernel time."""
    s = spans.stretches(ctx)
    if s is None or not s["b"].kernels:
        return None
    by_id = {x.id: x for x in s["b"].spans}
    kernel_us, lost = {}, set()
    for x in s["b"].spans:
        if x.name not in names:
            continue
        chunk = by_id.get(x.parent)
        while chunk is not None and chunk.name != CHUNK:
            chunk = by_id.get(chunk.parent)
        if chunk is None:
            continue
        k = getattr(x, "kernel_us", None)  # absent in a port without the correlation-id join
        if k is None:
            lost.add(chunk.id)
        else:
            kernel_us[chunk.id] = kernel_us.get(chunk.id, 0.0) + k
    read = [c for c in kernel_us if c not in lost]
    pairs = sum(by_id[c].attrs.get("pairs", 0) for c in read)
    total = sum(kernel_us[c] for c in read)
    return total / 1e3 / pairs if pairs and total else None


def read(ctx):
    return per_pair(ctx, ("fs.lightglue.self", "fs.lightglue.cross"))
