"""Reduction of a ``torch.profiler`` trace (its Chrome-trace JSON) to the
numbers the per-layer metrics read: the traced window, the device's busy
time, the in-service time (the union of the harness's ``frame`` spans)
and the device time of the work launched in it, for every span name the
count of its spans in the window and the device time of the work launched
inside them (the layers' spans: the harness's ``call``, a system's own
such as ``engine``), and the breakdown (the device operations that took
most time, and the idle gaps in service by what the host was doing).

Device work is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event.
An operation belongs to a span when the host call that launched it (the
runtime event of the same correlation id) lies inside the span.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def total(merged) -> float:
    return sum(e - s for s, e in merged)


def intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy, within) -> list[tuple[float, float]]:
    """The parts of the merged ``within`` that the merged ``busy`` leaves
    uncovered."""
    out = []
    for s, e in within:
        cur = s
        for bs, be in intersect(busy, [(s, e)]):
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


def short_name(name: str, n: int = 100) -> str:
    return name.removeprefix("void ")[:n]


class Timeline:
    """The events of one trace, times in seconds."""

    def __init__(self, events: list[dict]):
        self.device = []        # (start, end, name, correlation)
        self.launch = {}        # correlation → host time of the launching call
        self.spans = collections.defaultdict(list)  # annotation name → [(start, end)]
        self.host = []          # (start, end, name) of the frames' thread's calls
        self.tid = None
        host = []
        for e in events:
            cat, ts, dur = e.get("cat"), e.get("ts"), e.get("dur")
            if ts is None or dur is None:
                continue
            s, t = float(ts) * 1e-6, (float(ts) + float(dur)) * 1e-6
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((s, t, e.get("name", cat), corr))
            if cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = s
            if cat == "user_annotation":
                self.spans[e.get("name")].append((s, t))
            if cat in HOST_CATS:
                host.append((s, t, e.get("name", cat), e.get("tid")))
            if cat == "user_annotation" and e.get("name") == "frame":
                self.tid = e.get("tid")
        self.device.sort()
        self.host = sorted((s, t, n) for s, t, n, tid in host if tid == self.tid)

    @classmethod
    def load(cls, path) -> Timeline:
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def launched_in(self, name: str) -> list[tuple]:
        """Device operations launched inside a span called ``name``."""
        spans = sorted(self.spans.get(name, []))
        starts = [s for s, _ in spans]
        out = []
        for op in self.device:
            t = self.launch.get(op[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(op)
        return out

    def host_labels(self, points: list[float]) -> list[str]:
        """For each time, the innermost host call running then on the
        thread of the ``frame`` spans, after the innermost annotation
        around it (``engine: aten::cat``), or ``idle host``. Calls of one
        thread nest, so one sweep with a stack answers every time."""
        out = [""] * len(points)
        stack: list[tuple] = []
        i = 0
        for q, k in sorted((t, k) for k, t in enumerate(points)):
            while i < len(self.host) and self.host[i][0] <= q:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < q:
                stack.pop()
            live = [ev for ev in stack if ev[1] >= q]
            names = [ev[2] for ev in live]
            notes = [n for n in names if n in self.spans]
            calls = [n for n in names if n not in self.spans]
            inner = calls[-1] if calls else "idle host"
            out[k] = f"{notes[-1]}: {inner}" if notes else inner
        return out

    def _span_numbers(self, name: str, window: tuple[float, float]) -> dict:
        ops = self.launched_in(name)
        return {"calls": sum(1 for s, e in self.spans[name] if window[0] <= s and e <= window[1]),
                "device_s": total(union((s, e) for s, e, _, _ in ops))}

    def summary(self, top: int = 10) -> dict:
        """The numbers of the traced window."""
        service = union(self.spans.get("frame", []))
        if not service or not self.device:
            return {}
        window = [(service[0][0], service[-1][1])]
        busy = union((s, e) for s, e, _, _ in self.device)
        # in service: the work launched inside the frames' spans, by launch
        # (the card's clock can sit a millisecond off the host's in a trace)
        busy_service = union((s, e) for s, e, _, _ in self.launched_in("frame"))
        by_name = collections.Counter()
        for s, e, name, _ in self.device:
            by_name[short_name(name)] += e - s
        idle = sorted(gaps(busy, service), key=lambda g: g[1] - g[0], reverse=True)
        by_host = collections.Counter()
        for (s, e), label in zip(idle, self.host_labels([0.5 * (s + e) for s, e in idle])):
            by_host[label] += e - s
        return {
            "window_s": window[0][1] - window[0][0],
            "busy_s": total(intersect(busy, window)),
            "service_s": total(service),
            "service_busy_s": total(busy_service),
            "frames": len(self.spans.get("frame", [])),
            "spans": {name: self._span_numbers(name, window[0]) for name in sorted(self.spans)},
            "device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(top)],
        }
