"""engine_roofline: the least time of the stereo engine's work for the
traced frames (``work.engine_stages`` at the configuration's shapes, over
the card's peaks) as a share of the device time of the work launched
inside the system's ``engine`` spans, in %."""

from benchmark import work


def read(ctx):
    engine = ((ctx.trace or {}).get("spans") or {}).get("engine")
    if not engine or not engine["calls"] or not engine["device_s"]:
        return None
    least = work.least_seconds(work.engine_stages(ctx.config))
    return 100.0 * engine["calls"] * least / engine["device_s"]
