"""Milliseconds a pair of the per-pair phase (pipelines/stereo.py:
pair_from_slab: matching, refinement, PnP and the gate), host clock around
each call, synchronised before and after, over the clocked stretch."""


def read(ctx):
    p = ctx["phases"]
    return 1e3 * p["pair_s"] / p["pairs"] if p["pairs"] else None
