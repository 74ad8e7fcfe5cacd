"""latency_p50_ms: the median over all frames of the window of the time
from a frame's due time to its three maps on the host (host clock)."""

from benchmark.stats import latencies_ms, percentile


def read(ctx):
    return percentile(latencies_ms(ctx.records), 50)
