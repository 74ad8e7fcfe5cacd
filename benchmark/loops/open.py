"""The loop ``open``: a camera's schedule. Frame k is due at t0 + k/fps
(the mix's ``fps``) and is served as soon as it is due and the previous
frame is done; none is dropped, and the loop never waits for the system
to catch up. A frame is done when its outputs are on the host.

A loop module is named by a mix's ``loop`` and found as
``loops/<name>.py``; its ``run(call, inputs, traffic, seconds, sink,
tracer)`` returns (t0, records), and its ``report(records, traffic)``, if
it has one, a line for standard error.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.stats import latencies_ms, percentile
from benchmark.window import Frame, timed_call


def run(call, inputs, traffic: dict, seconds: float, sink, tracer):
    fps = traffic["fps"]
    n = int(round(fps * seconds))
    records = []
    t0 = time.perf_counter()
    for k in range(n):
        due = t0 + k / fps
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        tracer.before(time.perf_counter() - t0, seconds)
        with tracer.span("frame"):
            start = time.perf_counter()
            result, call_s = timed_call(call, inputs[k % len(inputs)], tracer)
            token = sink.put(result)
            del result
            sink.wait(token)
            done = time.perf_counter()
        sink.done(k, token)
        records.append(Frame(k, due, start, call_s, done))
        tracer.after()
    tracer.stop()
    return t0, records


def report(records, traffic: dict) -> str:
    """How late the generator started frames it was free to start on time
    (the previous frame done before this one was due), and the latency's
    percentiles over every frame."""
    lat = latencies_ms(records)
    tail = ", ".join(f"p{q} {percentile(lat, q):.4f}" for q in (50, 90, 95, 99))
    return f"latency ms: {tail}; {_lateness(records, traffic)}"


def _lateness(records, traffic: dict) -> str:
    pairs = list(zip(records, records[1:]))
    late = [r.start - r.due for prev, r in pairs if prev.done <= r.due]
    queued = sum(1 for prev, r in pairs if prev.done > r.due)
    if not late:
        return f"generator: every frame after the first waited for the one before ({queued})"
    ms = np.asarray(late) * 1e3
    return (f"generator: {len(late)} frames started on schedule, late by median "
            f"{np.median(ms):.4f} ms, max {ms.max():.4f} ms; {queued} waited for the frame "
            f"before; schedule {traffic['fps']} frames/s")
