"""The metric arithmetic on made-up records and timelines."""

import pytest

from benchmark import stats, timeline
from benchmark.window import Frame


def test_percentiles_take_every_frame():
    recs = [Frame(i, due=0.0, start=0.0, call_s=0.0, done=(i + 1) * 1e-3) for i in range(100)]
    lat = stats.latencies_ms(recs)
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    recs[0].done = None  # a frame that never came is infinitely late
    assert stats.percentile(stats.latencies_ms(recs), 100) == float("inf")


def test_frames_per_s_counts_frames_done_inside_the_window():
    recs = [Frame(i, due=i * 0.1, start=i * 0.1, call_s=0.0, done=i * 0.1 + 0.15)
            for i in range(30)]
    # t0 = 0, a 2 s window: done at 0.15, 0.25, ..., 1.95 → 19 frames
    assert stats.frames_per_s(recs, 0.0, 2.0) == pytest.approx(19 / 2.0)


def test_union_intersect_gaps():
    u = timeline.union([(5, 6), (0, 2), (1, 3), (4, 4)])
    assert u == [(0, 3), (5, 6)]
    assert timeline.total(u) == 4
    assert timeline.intersect(u, [(2, 5.5)]) == [(2, 3), (5, 5.5)]
    assert timeline.gaps(u, [(0, 10)]) == [(3, 5), (6, 10)]


def _ev(cat, name, ts_us, dur_us, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up_trace():
    """Two frames of 10 ms, 10 ms apart; each with an engine span and one
    kernel launched inside it; one kernel and one copy outside."""
    return [
        _ev("user_annotation", "frame", 0, 10000),
        _ev("user_annotation", "frame", 20000, 10000),
        _ev("user_annotation", "engine", 500, 5500),
        _ev("user_annotation", "engine", 20500, 5500),
        _ev("cpu_op", "aten::median", 600, 1300),
        _ev("cuda_runtime", "cudaLaunchKernel", 1500, 10, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 7000, 10, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 9400, 10, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 22000, 10, corr=3),
        _ev("kernel", "void census<5>(int)", 2000, 3000, corr=1, tid=7),
        _ev("kernel", "void other()", 7000, 2000, corr=2, tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH", 9500, 300, corr=4, tid=7),
        _ev("kernel", "void census<5>(int)", 23000, 1000, corr=3, tid=7),
        _ev("kernel", "void later()", 40000, 1000, corr=9, tid=7),  # outside every frame
    ]


def test_timeline_summary():
    s = timeline.Timeline(made_up_trace()).summary()
    assert s["window_s"] == pytest.approx(0.030)
    assert s["service_s"] == pytest.approx(0.020)
    assert s["service_busy_s"] == pytest.approx(0.0063)
    assert s["busy_s"] == pytest.approx(0.0063)
    assert s["spans"]["engine"] == {"calls": 2, "device_s": pytest.approx(0.004)}
    assert s["spans"]["frame"]["device_s"] == pytest.approx(0.0063)
    assert s["device_ops"][0] == ["census<5>(int)", pytest.approx(0.004)]
    labels = dict((k, v) for k, v in s["idle_gaps"])
    # the gap before the first kernel: the host ran aten::median in the engine
    assert labels["engine: aten::median"] == pytest.approx(0.002)
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(0.020 - 0.0063)


def test_the_cards_clock_off_the_hosts_moves_nothing_in_service():
    """Device times a millisecond and a half late: each operation still
    belongs to the span that launched it."""
    events = made_up_trace()
    for e in events:
        if e["cat"] in timeline.DEVICE_CATS:
            e["ts"] += 1500
    s = timeline.Timeline(events).summary()
    assert s["service_busy_s"] == pytest.approx(0.0063)
    assert s["spans"]["engine"]["device_s"] == pytest.approx(0.004)


def test_readers_on_a_made_up_trace():
    from benchmark.catalog import Catalog
    from benchmark.harness import Context
    from benchmark import work

    cat = Catalog()
    config = cat.config("production")
    summary = timeline.Timeline(made_up_trace()).summary()
    ctx = Context({}, config, {}, 20.0, 5.0, 0.0,
                  [Frame(0, 0.0, 0.0, 0.012, 0.02), Frame(1, 0.1, 0.1, 0.014, 0.12)], summary)
    idle = cat.reader("idle_share.live")(ctx)
    assert idle == pytest.approx(100 * (1 - 0.0063 / 0.020))
    roof = cat.reader("engine_roofline.replay")(ctx)
    assert roof == pytest.approx(100 * 2 * work.least_seconds(work.engine_stages(config)) / 0.004)
    assert cat.reader("call_host_ms.live")(ctx) == pytest.approx(13.0)
    assert cat.reader("setup_s")(ctx) == 5.0
    ctx.trace = None  # nothing to read: no value, never 0
    assert cat.reader("engine_roofline.live")(ctx) is None
    assert cat.reader("idle_share.replay")(ctx) is None
