"""other_device_ms: the device milliseconds a call spends outside the
stereo engine and the network: the work launched inside the harness's
``call`` spans less that inside the program's ``sgm.replay``,
``sgm.capture`` and ``mono.net`` spans (in the fused pipeline the
rectification, the occlusion scores, the flow, the ego-motion, the motion
depth, the calibrations, the fusion and the metres), over the count of
``call`` spans; nothing where the program opens none of the three."""

INNER = ("sgm.replay", "sgm.capture", "mono.net")


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    call = spans.get("call")
    if not call or not call["calls"] or not any(s in spans for s in INNER):
        return None
    inner = sum(spans[s]["device_s"] for s in INNER if s in spans)
    return 1e3 * (call["device_s"] - inner) / call["calls"]
