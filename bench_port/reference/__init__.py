"""The benchmark's plain reference of stereo VO: plain PyTorch, in float32
where the configuration states float32 and in bf16 products where it states
bf16, with no kernel, no cache and nothing of the measured program. It reads
the checkpoint with its own msgpack reader and works every table out again.

A :class:`common.Precision` in lower precision turns the reference into the
control of the output check: every network operand rounded to fp8 (e4m3,
per-tensor scale) and every float32 stage's maps, costs, coordinates and
poses rounded to bf16.
"""
