"""What the measurement scripts share: one variant's check against its
plain version, its time on the card (host included, and the device's alone)
and its bound."""

from __future__ import annotations

import torch

from stereovision_tpu_torch.ops import sgm_cuda

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores, applied to the kernels' compares and adds
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, warmup: int = 3):
    """Milliseconds per call of ``fn`` on the device alone: ``reps`` calls
    of ``fn`` captured back to back in one CUDA graph (after one call on a
    side stream, as capture needs), the graph replayed ``warmup`` times,
    then three times between CUDA events. One replay enqueues every call at
    once, so neither the host's launch path nor the graph's own launch is
    in the reading. Returns (ms, None), or (None, why) where ``fn`` cannot
    be captured. Tensors that ``fn`` allocates come from the graph's pool
    (a call's outputs are freed before the next call allocates), which is
    freed with the graph."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as exc:  # a call that syncs, or reads the host, cannot be captured
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {exc}"
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 3
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms, None


def bound_ms(nbytes: float, ops: float):
    """The least time for the work: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(got, want) -> float:
    """Largest difference between two results (tensors or tuples of them,
    None where a variant writes no volume); raises on a shape or type
    mismatch."""
    worst = 0.0
    for g, w in zip(_as_tuple(got), _as_tuple(want), strict=True):
        if g is None or w is None:
            if g is not w:
                raise RuntimeError("one result has a volume the other lacks")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{tuple(g.shape)}/{g.dtype} vs {tuple(w.shape)}/{w.dtype}")
        if g.numel():
            worst = max(worst, (g.double() - w.double()).abs().max().item())
    return worst


def measure(label: str, family: str, kernel, plain, work, device: torch.device, n: int,
            warmup: int) -> dict:
    """One variant: ``kernel()`` (its wrapper on the inputs, or a
    yardstick) against ``plain()`` (the plain version of the same function
    on the same inputs; None: nothing to hold it against), which must agree
    exactly, then on a card ``n`` timed calls of ``kernel`` after
    ``warmup`` (``ms``), the same replayed from a CUDA graph (``device_ms``,
    the device alone; :func:`graph_ms`), the plain version's time (one
    call) and the bound of ``work`` = (bytes, operations). Prints one line and returns it as a
    dict; ``launches`` counts the launches under ``family`` meanwhile."""
    before = sgm_cuda.launch_counts().get(family, 0)
    on_card = device.type == "cuda"
    got = kernel()
    err, plain_ms = None, None
    if plain is not None:
        if on_card:
            torch.cuda.synchronize()
            box = []
            plain_ms = cuda_ms(lambda: box.append(plain()), 1, warmup=0)
            want = box[0]
        else:
            want = plain()
        err = max_abs_err(got, want)
        if err != 0.0:
            raise RuntimeError(f"{label} differs from its plain version: max abs err {err}")
        del want
    del got
    ms = cuda_ms(kernel, n, warmup) if on_card else None
    device_ms, why = graph_ms(kernel, n, warmup) if on_card else (None, None)
    nbytes, ops = work
    b_ms, b_by = bound_ms(nbytes, ops)
    row = {"variant": label, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "mbytes": nbytes / 1e6, "max_abs_err": err,
           "launches": sgm_cuda.launch_counts().get(family, 0) - before}
    timing = f"{ms:.4f} ms ({ms / b_ms:.2f}x the bound)" if on_card else "not timed (CPU)"
    if on_card:
        timing += (f", device alone {device_ms:.4f} ms" if device_ms is not None
                   else f", device alone not measured ({why})")
    if plain_ms is not None:
        timing += f", plain {plain_ms:.3f} ms"
    check = "not checked" if err is None else "exact against the plain version"
    print(f"{label:>24}: {timing}; bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB); "
          f"{check}", flush=True)
    return row
