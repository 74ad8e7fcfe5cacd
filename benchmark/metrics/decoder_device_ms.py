"""decoder_device_ms: the device milliseconds a call spends in DPT's
decoder, the work launched inside the program's ``dpt.reassemble``,
``dpt.fusion`` and ``dpt.head`` spans over the count of its ``mono.net``
spans."""

STAGES = ("dpt.reassemble", "dpt.fusion", "dpt.head")


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    net = spans.get("mono.net")
    if not net or not net["calls"] or not all(s in spans for s in STAGES):
        return None
    return 1e3 * sum(spans[s]["device_s"] for s in STAGES) / net["calls"]
