"""``graph_replays`` on made-up traces: the engine's calls replayed from a
CUDA graph (``sgm.replay`` spans) over its calls (``depth.engine`` spans);
a program that opens no ``sgm.replay`` span reads nothing. The graph's
kernels carry the correlation of their ``cudaGraphLaunch``, so the engine
spans' device time holds them."""

import pytest

from benchmark import timeline
from benchmark.catalog import Catalog
from benchmark.harness import Context
from benchmark.window import Frame


def _ev(cat, name, ts_us, dur_us, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up_trace(replayed=(True, True)):
    """Two frames of 10 ms, each one engine call: replayed, one
    ``cudaGraphLaunch`` whose two kernels (2 ms and 0.5 ms) carry its
    correlation; else an eager call that launches the same two kernels."""
    events = []
    for k, (t, graph) in enumerate(zip((0, 20000), replayed)):
        c = 100 * k
        events += [
            _ev("user_annotation", "frame", t, 10000),
            _ev("user_annotation", "call", t + 100, 8000),
            _ev("user_annotation", "engine", t + 1000, 5000),
            _ev("user_annotation", "depth.engine", t + 990, 5020),
            _ev("kernel", "void census()", t + 1600, 2000, corr=c + 3, tid=7),
            _ev("kernel", "void median()", t + 3700, 500, corr=c + 3 if graph else c + 4, tid=7),
        ]
        if graph:
            events += [_ev("user_annotation", "sgm.replay", t + 1100, 300),
                       _ev("cuda_runtime", "cudaGraphLaunch", t + 1200, 50, corr=c + 3)]
        else:
            events += [_ev("cuda_runtime", "cudaLaunchKernel", t + 1500, 10, corr=c + 3),
                       _ev("cuda_runtime", "cudaLaunchKernel", t + 3600, 10, corr=c + 4)]
    return events


def context(events):
    cat = Catalog()
    return cat, Context({}, cat.config("production"), {}, 20.0, 5.0, 0.0,
                        [Frame(0, 0.0, 0.0, 0.008, 0.01), Frame(1, 0.02, 0.02, 0.008, 0.03)],
                        timeline.Timeline(events).summary())


@pytest.mark.parametrize("suffix", ["live", "replay"])
@pytest.mark.parametrize("replayed,want", [((True, True), 1.0), ((True, False), 0.5)])
def test_graph_replays_counts_the_replayed_calls(suffix, replayed, want):
    cat, ctx = context(made_up_trace(replayed))
    assert cat.reader(f"graph_replays.{suffix}")(ctx) == pytest.approx(want)
    engine = ctx.trace["spans"]["engine"]
    assert 1e3 * engine["device_s"] / engine["calls"] == pytest.approx(2.5)


def test_a_program_without_replays_reads_nothing():
    cat, ctx = context(made_up_trace((False, False)))
    assert cat.reader("graph_replays.live")(ctx) is None
    assert cat.reader("engine_roofline.live")(ctx) is not None
    ctx.trace = None
    assert cat.reader("graph_replays.replay")(ctx) is None
