"""mfu.fused: a fused frame's operations (``fused_work.ops``: the stereo
search, the network's products, the flow, the ego-motion, the filters and
the fusion) times the traced frames, over their in-service time (the union
of the harness's ``frame`` spans) times the card's float32 peak, in %."""

from benchmark import fused_work
from benchmark.work import PEAKS


def read(ctx):
    t = ctx.trace
    if not t or not t.get("service_s") or not t.get("frames"):
        return None
    return 100.0 * fused_work.ops(ctx.config) * t["frames"] / (t["service_s"] * PEAKS["ops_per_s"])
