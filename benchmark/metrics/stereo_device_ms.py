"""stereo_device_ms: the device milliseconds a call spends in the stereo
engine, the work launched inside the program's ``sgm.replay`` and
``sgm.capture`` spans (a frame replayed from its CUDA graph, or captured
into one) over the count of the harness's ``call`` spans; nothing where
the program opens neither (an engine that runs eagerly)."""

STAGES = ("sgm.replay", "sgm.capture")


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    call = spans.get("call")
    if not call or not call["calls"] or not any(s in spans for s in STAGES):
        return None
    return 1e3 * sum(spans[s]["device_s"] for s in STAGES if s in spans) / call["calls"]
