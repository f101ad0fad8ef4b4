"""Kernel launches a pair of the whole sequence: the launch calls
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``, ...; a
graph launch counts one) made inside the ``fs.stereo.sequence`` spans of
stretch B (bench_port/spans.py) over their pairs. None where the trace holds
no launch."""

from bench_port import spans


def read(ctx):
    r = spans.row(ctx, "b", "fs.stereo.sequence")
    return r["launches"] / r["pairs"] if r and r["pairs"] else None
