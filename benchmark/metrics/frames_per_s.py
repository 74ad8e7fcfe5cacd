"""frames_per_s: the frames whose maps reached the host inside the window,
over the window's seconds (host clock)."""

from benchmark.stats import frames_per_s


def read(ctx):
    return frames_per_s(ctx.records, ctx.t0, ctx.seconds)
