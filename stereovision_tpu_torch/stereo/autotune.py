"""Session choice of the paths=2 statistics formulation, and a timing helper.

Counterpart of ``stereovision_tpu/stereo/autotune.py``. The horizontal
pair's WTA statistics have two bit-identical formulations
(``SGMParams.stats_impl``): the one-pass statistics kernel
(``sgm_cuda.wta_stats_from_duals``, ``"pallas"``) and the summed-volume form
(``sgm_cuda.sum_wta``, ``"xla"``). The reference probes the chip once a
session because on a loaded TPU host the kernel's lane reductions could
fall behind; off the TPU its probe returns the kernel form without timing
anything. The port has no TPU, so ``"auto"`` resolves to the kernel form
on every device, as the reference's does off the TPU.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["tune_stats_impl", "timed_best"]


def tune_stats_impl(params):
    """Resolve ``params.stats_impl`` for this session: ``"auto"`` becomes
    the kernel form, ``"pallas"`` (what the reference's probe returns off
    the TPU, and what it pins for ``paths=4``); explicit values pass
    through unchanged."""
    if getattr(params, "stats_impl", None) != "auto":
        return params
    return dataclasses.replace(params, stats_impl="pallas")


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def _settle(out) -> None:
    """Wait for ``out``'s device: the card's queue drains before a clock is
    read, so a time covers the work and not only its launch."""
    leaf = _first_tensor(out)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def timed_best(fns: dict, args: tuple, rounds: int = 2, inner: int = 4):
    """Interleaved best-of picker: each callable of ``fns`` (name → fn) is
    called with ``args``, once to warm up, then ``rounds`` times ``inner``
    calls each in turn. Returns (best name, {name: best seconds a call})."""
    times = {n: float("inf") for n in fns}
    for f in fns.values():
        _settle(f(*args))
    for _ in range(rounds):
        for n, f in fns.items():
            t0 = time.perf_counter()
            for _ in range(inner):
                out = f(*args)
            _settle(out)
            times[n] = min(times[n], (time.perf_counter() - t0) / inner)
    best = min(times, key=times.get)
    return best, times
