"""call_host_ms: the median host milliseconds of one
``DepthPipeline.__call__``, from entry to return, over the window's frames:
the host's enqueue and every wait the program makes on the card."""

from benchmark.stats import percentile


def read(ctx):
    return percentile([r.call_s * 1e3 for r in ctx.records], 50)
