"""net_device_ms: the device milliseconds of one call's network forward,
the work launched inside the program's ``mono.net`` spans over their
count."""


def read(ctx):
    net = ((ctx.trace or {}).get("spans") or {}).get("mono.net")
    if not net or not net["calls"]:
        return None
    return 1e3 * net["device_s"] / net["calls"]
