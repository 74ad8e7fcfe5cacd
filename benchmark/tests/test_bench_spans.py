"""The readers of the program's own spans on made-up traces:
``upload_device_ms``, ``host_syncs``, ``search_device_ms`` and
``stages_device_ms`` read the ``depth.*``, ``sgm.*`` and ``sync.*`` spans
that the program opens; a program without them (the harness's ``frame`` and
``call`` spans and the system module's ``engine`` alone) reads nothing."""

import pytest

from benchmark import timeline
from benchmark.catalog import Catalog
from benchmark.harness import Context
from benchmark.window import Frame

NEW = ("upload_device_ms", "host_syncs", "search_device_ms", "stages_device_ms")


def _ev(cat, name, ts_us, dur_us, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up_trace(program_spans=True):
    """Two frames of 10 ms, 10 ms apart, each one call: an upload of two
    images (a copy of 200 µs each, each in a ``sync.upload`` span), and in
    the engine a search (a 2 ms kernel) and a stage outside it (a 500 µs
    kernel), the same work under the system module's ``engine`` span."""
    events = []
    for k, t in enumerate((0, 20000)):
        c = 100 * k
        events += [
            _ev("user_annotation", "frame", t, 10000),
            _ev("user_annotation", "call", t + 100, 8000),
            _ev("user_annotation", "engine", t + 1000, 5000),
            _ev("cuda_runtime", "cudaMemcpyAsync", t + 200, 10, corr=c + 1),
            _ev("cuda_runtime", "cudaStreamSynchronize", t + 220, 250),
            _ev("cuda_runtime", "cudaMemcpyAsync", t + 500, 10, corr=c + 2),
            _ev("cuda_runtime", "cudaStreamSynchronize", t + 520, 250),
            _ev("cuda_runtime", "cudaLaunchKernel", t + 1500, 10, corr=c + 3),
            _ev("cuda_runtime", "cudaLaunchKernel", t + 4000, 10, corr=c + 4),
            _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 250, 200, corr=c + 1, tid=7),
            _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 550, 200, corr=c + 2, tid=7),
            _ev("kernel", "void census()", t + 1600, 2000, corr=c + 3, tid=7),
            _ev("kernel", "void median()", t + 4100, 500, corr=c + 4, tid=7),
        ]
        if program_spans:
            events += [
                _ev("user_annotation", "depth.upload", t + 150, 800),
                _ev("user_annotation", "sync.upload", t + 190, 300),
                _ev("user_annotation", "sync.upload", t + 490, 300),
                _ev("user_annotation", "depth.engine", t + 990, 5020),
                _ev("user_annotation", "sgm.search", t + 1200, 2000),
                _ev("user_annotation", "sgm.median", t + 3900, 300),
            ]
    return events


def context(events):
    cat = Catalog()
    summary = timeline.Timeline(events).summary()
    return cat, Context({}, cat.config("full"), {}, 20.0, 5.0, 0.0,
                        [Frame(0, 0.0, 0.0, 0.008, 0.01), Frame(1, 0.02, 0.02, 0.008, 0.03)],
                        summary)


@pytest.mark.parametrize("suffix", ["live", "replay"])
def test_the_program_spans_readers(suffix):
    cat, ctx = context(made_up_trace())
    read = {name: cat.reader(f"{name}.{suffix}")(ctx) for name in NEW}
    assert read["upload_device_ms"] == pytest.approx(0.4)    # two 200 µs copies a call
    assert read["host_syncs"] == pytest.approx(2.0)          # two sync.upload a call
    assert read["search_device_ms"] == pytest.approx(2.0)
    assert read["stages_device_ms"] == pytest.approx(0.5)
    # the program's spans cover the engine: together they read the engine span's device ms
    engine = ctx.trace["spans"]["engine"]
    assert read["search_device_ms"] + read["stages_device_ms"] == pytest.approx(
        1e3 * engine["device_s"] / engine["calls"])


def test_a_program_without_its_spans_reads_nothing():
    cat, ctx = context(made_up_trace(program_spans=False))
    assert {name: cat.reader(f"{name}.live")(ctx) for name in NEW} == dict.fromkeys(NEW)
    # the readers that were there before still read the same trace
    assert cat.reader("engine_roofline.live")(ctx) is not None
    ctx.trace = None
    assert {name: cat.reader(f"{name}.replay")(ctx) for name in NEW} == dict.fromkeys(NEW)


def test_a_call_without_a_wait_counts_none():
    events = [e for e in made_up_trace() if e["name"] != "sync.upload"]
    cat, ctx = context(events)
    assert cat.reader("host_syncs.live")(ctx) == 0.0
