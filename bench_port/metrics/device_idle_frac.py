"""Share of the profiled window in which no operation ran on the card."""


def read(ctx):
    t = ctx["trace"]
    return 1.0 - t["busy_s"] / t["window_s"] if t["busy_s"] > 0 else None
