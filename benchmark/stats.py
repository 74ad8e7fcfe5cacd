"""The arithmetic of the end-to-end metrics, over every frame of the
window."""

from __future__ import annotations

import numpy as np


def latencies_ms(records) -> list[float]:
    """Each frame's due time to its maps on the host; a frame whose maps
    never came counts as infinitely late."""
    return [(r.done - r.due) * 1e3 if r.done is not None else float("inf") for r in records]


def percentile(values, q: float) -> float:
    """The q-th percentile over all values, linear between the order
    statistics (numpy's default); infinite where an infinite one takes
    part."""
    v = np.sort(np.asarray(values, np.float64))
    pos = q / 100.0 * (len(v) - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if np.isinf(v[hi]):
        return float("inf")
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def frames_per_s(records, t0: float, seconds: float) -> float:
    """Frames whose maps were on the host by the window's end, over its
    seconds."""
    end = t0 + seconds
    return sum(1 for r in records if r.done is not None and r.done <= end) / seconds
