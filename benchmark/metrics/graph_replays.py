"""graph_replays: the stereo engine's calls replayed from a CUDA graph, the
program's ``sgm.replay`` spans over its ``depth.engine`` spans; nothing
where the program opens no such span."""


def read(ctx):
    spans = (ctx.trace or {}).get("spans") or {}
    engine, replay = spans.get("depth.engine"), spans.get("sgm.replay")
    if not engine or not replay or not engine["calls"]:
        return None
    return replay["calls"] / engine["calls"]
