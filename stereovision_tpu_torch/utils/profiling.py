"""Profiling helpers: a ``torch.profiler`` trace of a region, and the named
spans that the program opens inside such a trace.

Counterpart of ``stereovision_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

_NO_SPAN = contextlib.nullcontext()


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
    """A named span of the profiler trace being recorded: a
    ``record_function`` while a ``torch.profiler`` profile records (its
    times on the profiler's host clock, to which the trace aligns the CUDA
    runtime calls and the card's work), else one shared null context, a
    check of a process-wide flag.

    The work launched inside a span is the span's. Names are
    ``<layer>.<stage>`` (``depth.engine``, ``sgm.search``); a span opened
    around a point where the host waits on the card is named ``sync.<what>``,
    so the count of ``sync.*`` spans is the count of such waits. A name
    never opens inside itself."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)
