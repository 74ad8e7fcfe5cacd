"""CUDA graphs of recurring calls: a call of fixed shapes and settings is
captured once into a CUDA graph and then replayed, one launch in place of
the host's dispatch of each of its operations.

:class:`GraphCache` keys each call. A key's first call runs eagerly: it
builds the kernels' libraries and fills the host-side caches (resize
weights, constants) that the call reads, so that its capture launches
nothing new. Its second call is captured (:func:`capture`) and run from the
graph; every later call copies its inputs into the graph's own and replays
it. Replayed outputs are copies: a caller that keeps one call's outputs
does not see the next call overwrite them.
"""

from __future__ import annotations

import collections

import torch


class GraphCache:
    """Captured calls by key, the ``size`` most recently used (a key pushed
    out takes its graph and the graph's memory pool with it), and the keys
    seen once and not yet captured, the ``16·size`` most recent.

    ``capture(fn, inputs)`` → ``(replay, outputs)``: ``outputs`` are the
    captured call's, ``replay(*inputs)`` gives a later call's. ``counts``:
    the calls run eagerly (every call keyed None, and every call while
    ``size`` is 0), captured and replayed."""

    def __init__(self, capture, size: int = 4):
        self._capture = capture
        self.size = size
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self.counts = dict.fromkeys(("eager", "captures", "replays"), 0)

    def __call__(self, key, fn, *inputs):
        """``fn(*inputs)``: replayed where ``key``'s graph is kept, captured
        on ``key``'s second call, else run eagerly."""
        replay = self._graphs.get(key)
        if replay is not None:
            self._graphs.move_to_end(key)
            self.counts["replays"] += 1
            return replay(*inputs)
        if key is None or self.size <= 0 or key not in self._seen:
            if key is not None and self.size > 0:
                self._seen[key] = None
                while len(self._seen) > 16 * self.size:
                    self._seen.popitem(last=False)
            self.counts["eager"] += 1
            return fn(*inputs)
        del self._seen[key]
        self._trim(self.size - 1)  # the pushed-out graph's memory is free for the capture
        replay, outputs = self._capture(fn, inputs)
        self._graphs[key] = replay
        self.counts["captures"] += 1
        return outputs

    def _trim(self, n: int) -> None:
        while len(self._graphs) > max(n, 0):
            self._graphs.popitem(last=False)

    def resize(self, size: int) -> None:
        """Keep at most ``size`` graphs from now on, the least recently used
        going first; at 0 every call runs eagerly."""
        self.size = max(size, 0)
        self._trim(self.size)

    def reset(self) -> None:
        """Free every graph, forget every key and set the counts to 0."""
        self._graphs.clear()
        self._seen.clear()
        self.counts.update(dict.fromkeys(self.counts, 0))


def capture(fn, inputs):
    """Capture ``fn(*inputs)`` (CUDA tensors of one device; ``fn`` returns
    a tuple of tensors and makes the host wait on nothing) into a CUDA graph
    with its own memory pool, on a side stream, and run it once. Returns
    ``(replay, outputs)``: ``replay(*inputs)`` copies ``inputs`` into the
    graph's inputs, replays the graph on the current stream and returns
    copies of its outputs."""
    dev = inputs[0].device
    with torch.cuda.device(dev):
        static = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                       for x in inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                              capture_error_mode="thread_local"):
            outputs = fn(*static)
        last = [torch.cuda.current_stream(dev)]

    def replay(*args):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if stream != last[0]:  # the graph's buffers are free once the last replay ends
                stream.wait_stream(last[0])
                last[0] = stream
            for s, x in zip(static, args):
                s.copy_(x)
            graph.replay()
            return tuple(o.clone() for o in outputs)

    return replay, replay(*inputs)
