"""encoder_device_ms: the device milliseconds a call spends in DPT's
encoder, the work launched inside the program's ``dpt.embed`` and
``dpt.blocks`` spans over the count of its ``mono.net`` spans."""

STAGES = ("dpt.embed", "dpt.blocks")


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    net = spans.get("mono.net")
    if not net or not net["calls"] or not all(s in spans for s in STAGES):
        return None
    return 1e3 * sum(spans[s]["device_s"] for s in STAGES) / net["calls"]
