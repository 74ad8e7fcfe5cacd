"""search_device_ms: the device milliseconds a call spends in the stereo
engine's searches (census → cost → aggregation → WTA → LR check), the
work launched inside the program's ``sgm.search`` spans over the count of
its ``depth.engine`` spans."""


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    engine, search = spans.get("depth.engine"), spans.get("sgm.search")
    if not engine or not search or not engine["calls"]:
        return None
    return 1e3 * search["device_s"] / engine["calls"]
