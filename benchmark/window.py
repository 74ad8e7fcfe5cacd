"""What every loop of the measured window shares: a frame's record, the
sink that copies each frame's outputs to host memory, and the tracer.

A loop returns one record per frame sent: its index, when it was due (an
open loop's schedule; a closed loop's start), when its service started,
the host seconds of the system's call from entry to return, and when its
outputs were on the host (None where they never came).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass
class Frame:
    index: int
    due: float
    start: float
    call_s: float
    done: float | None = None


class Sink:
    """Host buffers for the frames' outputs (pinned, where the device is a
    card), filled by non-blocking copies behind an event. ``outputs`` maps
    a call's result to the tensors that have to reach the host. ``keep`` of
    the finished frames, drawn by reservoir sampling from ``rng``, keep
    their buffers for the check; the rest go back to the pool.

    For a system that carries state from call to call, ``snapshot`` is its
    ``snapshot()``: copies on the device, taken without a host wait, of
    everything the next call reads from earlier ones. The sink takes one
    when it is made (``start``, the state before the first call) and one
    after each call, as the call's outputs are put; a frame's token holds
    the snapshot before its call and the one after it, and a kept frame
    keeps both for the check (``states_kept``). Without ``snapshot`` a
    token holds none."""

    def __init__(self, outputs, keep: int, rng: np.random.Generator, device: torch.device,
                 snapshot=None):
        self.outputs = outputs
        self.cuda = device.type == "cuda"
        self.pool: list[tuple] = []
        self.shapes = None
        self.keep, self.rng = keep, rng
        self.kept: dict[int, tuple] = {}
        self.seen = 0
        self.snapshot = snapshot
        self.kept_states: dict[int, tuple] = {}
        self.start = snapshot() if snapshot is not None else None
        self._state = self.start

    def _buffer(self, tensors) -> tuple:
        if self.shapes is None:  # the first frame sizes a pool that a frame in flight never empties
            self.shapes = [(t.shape, t.dtype) for t in tensors]
            self.pool = [self._buffer(tensors) for _ in range(self.keep + 2)]
        if self.pool:
            return self.pool.pop()
        return tuple(torch.empty(s, dtype=d, pin_memory=self.cuda) for s, d in self.shapes)

    def put(self, result):
        """Start the copy of a frame's outputs; returns its token."""
        tensors = self.outputs(result)
        buf = self._buffer(tensors)
        for b, t in zip(buf, tensors):
            b.copy_(t, non_blocking=self.cuda)
        states = None
        if self.snapshot is not None:
            states = (self._state, self.snapshot())
            self._state = states[1]
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return buf, event, states

    @staticmethod
    def wait(token) -> None:
        if token[1] is not None:
            token[1].synchronize()

    def release(self, token) -> None:
        self.pool.append(token[0])

    def done(self, index: int, token) -> None:
        """The frame's outputs are on the host: keep them or free the
        buffer."""
        buf = token[0]
        self.seen += 1
        if len(self.kept) < self.keep:
            self._keep(index, token)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.keep:
            victim = sorted(self.kept)[j]
            self.pool.append(self.kept.pop(victim))
            self.kept_states.pop(victim, None)
            self._keep(index, token)
        else:
            self.pool.append(buf)

    def _keep(self, index: int, token) -> None:
        self.kept[index] = token[0]
        if token[2] is not None:
            self.kept_states[index] = token[2]

    def outputs_kept(self) -> dict[int, tuple]:
        return {i: tuple(b.numpy().copy() for b in buf) for i, buf in sorted(self.kept.items())}

    def states_kept(self) -> dict[int, tuple]:
        """Each kept frame's (snapshot before its call, snapshot after it)."""
        return dict(sorted(self.kept_states.items()))


ATTEMPTS = 3  # profiles a traced run tries, in set-up and in the window, before it gives up


class Tracer:
    """Spans of the traced run: ``frame`` around each frame's service and
    ``call`` around each call of the system (and the system's own), recorded
    by ``torch.profiler`` over ``settings["frames"]`` frames that start once
    ``settings["start_fraction"]`` of the window has passed (a mix's
    ``trace``). Untraced, every span is empty.

    A profile that recorded no operation on the card (the profiler can
    come back empty-handed now and then) is thrown away and the next
    frames are traced instead, up to ``ATTEMPTS`` stretches."""

    def __init__(self, enabled: bool, settings: dict, device: torch.device):
        self.enabled = enabled
        self.start_fraction, self.frames = settings["start_fraction"], settings["frames"]
        self.device = device
        self.prof = None
        self.traced = 0
        self.finished = False
        self.attempts = 0
        self.span_s = (None, None)  # host times at the trace's start and stop

    def span(self, name: str):
        if self.prof is not None and not self.finished:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self, fn) -> bool:
        """Run ``fn`` under a short profile in set-up, so that the window's
        profile starts without the tracer's first-use cost, until one
        records the card's work; False where none of ``ATTEMPTS`` did."""
        if not self.enabled:
            return True
        for k in range(ATTEMPTS):
            prof = torch.profiler.profile(activities=self._activities())
            prof.start()
            fn()
            prof.stop()
            if self._holds_device_work(prof):
                return True
            _note(f"trace: the set-up's profile {k + 1} recorded no operation on the card")
        return False

    def _holds_device_work(self, prof) -> bool:
        """Whether a stopped profile recorded an operation on the card (on
        the CPU there is none to record, and the question is not asked)."""
        if self.device.type != "cuda":
            return True
        results = getattr(prof.profiler, "kineto_results", None)
        if results is None:  # nothing to look at before the export: its reduction decides
            return True
        cuda = torch.autograd.DeviceType.CUDA
        return any(e.device_type() == cuda for e in results.events())

    def before(self, elapsed: float, seconds: float) -> None:
        if (self.enabled and self.prof is None and not self.finished
                and elapsed >= self.start_fraction * seconds):
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.span_s = (time.perf_counter(), None)

    def after(self) -> None:
        if self.prof is not None and not self.finished:
            self.traced += 1
            if self.traced >= self.frames:
                self._close(retry=True)

    def stop(self) -> None:
        """End the trace at the window's close."""
        self._close(retry=False)

    def _close(self, retry: bool) -> None:
        if self.prof is None or self.finished:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()  # the last traced frame's work ends inside the trace
        self.prof.stop()
        self.finished = True
        self.span_s = (self.span_s[0], time.perf_counter())
        self.attempts += 1
        if retry and self.attempts < ATTEMPTS and not self._holds_device_work(self.prof):
            _note(f"trace: stretch {self.attempts} recorded no operation on the card; "
                  f"tracing the next {self.frames} frames")
            self.prof, self.traced, self.finished = None, 0, False

    def export(self, path) -> bool:
        if self.prof is None:
            return False
        self.stop()
        self.prof.export_chrome_trace(str(path))
        return True


def _note(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def timed_call(call, inputs, tracer: Tracer):
    """The system's call on one input, in a ``call`` span; returns the
    result and its host seconds from entry to return."""
    t = time.perf_counter()
    with tracer.span("call"):
        result = call(*inputs)
    return result, time.perf_counter() - t
