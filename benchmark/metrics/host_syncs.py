"""host_syncs: the times a call makes the host wait on the card, the
program's ``sync.*`` spans over the harness's ``call`` spans; nothing
where the program opens no ``depth.*`` span (it says nothing of its
waits)."""


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    call = spans.get("call")
    if not call or not call["calls"] or not any(k.startswith("depth.") for k in spans):
        return None
    return sum(v["calls"] for k, v in spans.items() if k.startswith("sync.")) / call["calls"]
