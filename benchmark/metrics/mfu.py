"""mfu: the network's floating-point operations a frame
(``dpt_work.flops``) times the traced frames, over their in-service time
(the union of the harness's ``frame`` spans) times the card's float32
peak, in %."""

from benchmark import dpt_work
from benchmark.work import PEAKS


def read(ctx):
    t = ctx.trace
    if not t or not t.get("service_s") or not t.get("frames"):
        return None
    return 100.0 * dpt_work.flops(ctx.config) * t["frames"] / (t["service_s"] * PEAKS["ops_per_s"])
