"""Milliseconds a frame of the per-frame phase (pipelines/stereo.py:
frame_features: front end and sparse stereo), host clock around each call,
synchronised before and after, over the clocked stretch."""


def read(ctx):
    p = ctx["phases"]
    return 1e3 * p["frame_s"] / p["frames"] if p["frames"] else None
