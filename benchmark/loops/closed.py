"""The loop ``closed``: frames back to back for the window's seconds. Each
frame's outputs go to the host behind an event; up to the mix's
``in_flight`` frames are left in flight while the next is enqueued, and
the oldest is waited for beyond that. The frames in flight at the close
are waited for too.
"""

from __future__ import annotations

import collections
import time

from benchmark.window import Frame, timed_call


def run(call, inputs, traffic: dict, seconds: float, sink, tracer):
    in_flight = int(traffic["in_flight"])
    records = []
    pending = collections.deque()  # (record, token) of the frames in flight

    def finish():
        rec, tok = pending.popleft()
        sink.wait(tok)
        rec.done = time.perf_counter()
        sink.done(rec.index, tok)

    t0 = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        tracer.before(now - t0, seconds)
        with tracer.span("frame"):
            start = time.perf_counter()
            result, call_s = timed_call(call, inputs[k % len(inputs)], tracer)
            rec = Frame(k, start, start, call_s)
            pending.append((rec, sink.put(result)))
            del result
            while len(pending) > in_flight:
                finish()
        records.append(rec)
        tracer.after()
        k += 1
    while pending:
        finish()
    tracer.stop()
    return t0, records
