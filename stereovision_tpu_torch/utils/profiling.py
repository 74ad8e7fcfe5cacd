"""Profiling helpers: a ``torch.profiler`` trace of a region, named ranges
inside it, and device-synchronized timing of a call.

Counterpart of ``stereovision_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the CPU and, where a card is present, CUDA activity of the
    region and write a Chrome trace (``trace.json``, for Perfetto or
    ``chrome://tracing``) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A named range that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor, or a tuple, list
    or dict of them): one synchronization of its first tensor's card
    (nothing to wait for on the CPU)."""
    if isinstance(out, dict):
        out = list(out.values())
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    first = next((t for t in leaves if torch.is_tensor(t)), None)
    if first is not None and first.is_cuda:
        torch.cuda.synchronize(first.device)


def timed(fn, *args, n: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then n
    dispatches and one synchronization after them (the device's queue
    stays full)."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / n
