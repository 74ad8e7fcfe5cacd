"""net_roofline: the least time of the network's forward
(``dpt_work.stages`` at the configuration's widths and input size, each
stage the larger of its operations over the float32 peak and its bytes over
the bandwidth, summed) as a share of the device time of the work launched
inside the program's ``mono.net`` spans, a call's, in %."""

from benchmark import dpt_work


def read(ctx):
    net = ((ctx.trace or {}).get("spans") or {}).get("mono.net")
    if not net or not net["calls"] or not net["device_s"]:
        return None
    least = dpt_work.least_seconds(dpt_work.stages(ctx.config))
    return 100.0 * net["calls"] * least / net["device_s"]
