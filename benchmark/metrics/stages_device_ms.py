"""stages_device_ms: the device milliseconds a call spends in the stereo
engine outside its searches (the coarse-to-fine stages, speckle, fill,
medians), the work launched inside the program's ``depth.engine`` spans
less that inside its ``sgm.search`` spans, over the count of
``depth.engine`` spans."""


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    engine, search = spans.get("depth.engine"), spans.get("sgm.search")
    if not engine or not search or not engine["calls"]:
        return None
    return 1e3 * (engine["device_s"] - search["device_s"]) / engine["calls"]
