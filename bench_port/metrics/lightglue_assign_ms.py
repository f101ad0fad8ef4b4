"""Device milliseconds a pair in LightGlue's assignment and filter: the
device time of the kernels launched inside the ``fs.lightglue.assign``
spans, over the pairs of the pair chunks that hold them, read as
``lightglue_layers_ms`` reads the layers' spans (a pair chunk with a lost
kernel record left out). None where the port has no such span or credits
no kernel to it."""

from bench_port.metrics.lightglue_layers_ms import per_pair


def read(ctx):
    return per_pair(ctx, ("fs.lightglue.assign",))
