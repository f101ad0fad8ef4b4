"""Seconds the warm-up sequence takes over a warm one: the process's first
``fs.stereo.sequence`` (the set-up's warm-up, a one-shot span with CUDA
events) on the device's timeline, less the median of stretch A's sequences
on the same clock (bench_port/spans.py). Includes what the first sequence
does once: the kernel library's load or build, the first calls into cuDNN
and cuBLAS, the allocator's growth. None without CUDA events."""

from bench_port import spans


def read(ctx):
    return spans.warmup_excess_s(ctx)
