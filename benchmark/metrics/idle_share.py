"""idle_share: the share of the traced in-service time (the union of the
frames' service spans, from a frame's start to its maps on the host) in
which the card ran no kernel and no copy, in %."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("service_s"):
        return None
    return 100.0 * (1.0 - t["service_busy_s"] / t["service_s"])
