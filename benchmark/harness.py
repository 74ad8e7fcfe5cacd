"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

    python3 benchmark/run.py --workload prod-cam20 --seed 7 --seconds 40 --trace 0

Every part of a cell is found by name (``catalog.py``): the configuration
names its system and its reference, the traffic mix its generator and its
loop. Set-up (``setup_s``, from the process's start to the window's first
frame) builds the system, draws the ring of inputs from the seed and runs
the mix's warm-up frames. The window drives the system's call and copies
every frame's outputs to the host. Then the peak memory is read, the
system is freed, the kept frames are compared with the reference on the
same device, and the last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.

A system that carries state from frame to frame offers ``snapshot()``,
and its reference ``step(state, *inputs) -> (outputs, next state)``,
``initial_state()`` and ``start_numbers``: each kept frame is computed
from the program's own state before it, its outputs compared with what the
timed path put on the host and the reference's next state with the
program's after it (so errors do not pile up across frames and a wrong
update of the state still fails), and the state the program starts from
with the reference's. The reference's ``step`` is also handed the program's
state after the frame (``follow``), with which it may choose among
outcomes that its equations leave to rounding; a reference module's
``notes(ref)``, where it has one, gives lines for standard error on what
it chose. A system without ``snapshot()`` is checked frame by
frame with the reference's call alone.

With ``--trace 1`` the result carries the cell's per-layer metrics, read
from a ``torch.profiler`` trace of a stretch of the window and from the
harness's own spans, instead of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, importcheck, window
from benchmark.catalog import Catalog


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    t0: float
    records: list
    trace: dict | None


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _calls(records, span) -> str:
    """The system call's median host ms, and in a traced run before,
    during and after the trace (the tracing's cost)."""
    def med(rs):
        return f"{np.median([r.call_s for r in rs]) * 1e3:.4f} ms ({len(rs)})" if rs else "none"

    line = f"calls: median {med(records)}"
    if span[0] is not None:
        a, b = span
        line += (f"; before the trace {med([r for r in records if r.start < a])}, in it "
                 f"{med([r for r in records if a <= r.start < b])}, after it "
                 f"{med([r for r in records if r.start >= b])}")
    return line


def main(argv=None, started: float | None = None, catalog: Catalog | None = None,
         device: str | None = None, wrap=None) -> int:
    """Run a cell once; returns the exit code. ``started`` is the process's
    start on ``time.monotonic``'s clock. ``device`` other than None (the
    tests' CPU) skips the look for a card; ``wrap`` replaces the system's
    call by ``wrap(call)`` (the tests' planted faults)."""
    started = time.monotonic() if started is None else started
    args = parse(argv)
    cat = catalog or Catalog()
    cell = cat.cell(args.workload)
    config, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    limits = cat.limits(cell["config"])
    system = cat.module("systems", config["system"])
    if importlib.util.find_spec(system.PROGRAM) is None:
        say(f"{args.workload} drives {system.PROGRAM}, which this checkout does not hold")
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            say(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
    dev = torch.device(device)

    # set-up
    marks = [("start", time.monotonic())]
    if dev.type == "cuda":
        torch.cuda.init()
        marks.append(("context", time.monotonic()))
    sut = system.build(config, dev)
    marks.append(("system", time.monotonic()))
    call = sut.call if wrap is None else wrap(sut.call)
    tracer = window.Tracer(bool(args.trace), traffic["trace"], dev)
    if args.trace:
        sut.spans(tracer)
    inputs = cat.module("generators", traffic["generator"]).inputs(config, traffic, args.seed,
                                                                   dev)
    marks.append(("inputs", time.monotonic()))
    sink = window.Sink(sut.outputs, int(traffic["check_frames"]),
                       np.random.default_rng(np.random.SeedSequence(args.seed % (1 << 64))), dev,
                       snapshot=getattr(sut, "snapshot", None))

    def one(j):
        token = sink.put(call(*inputs[j % len(inputs)]))
        sink.wait(token)
        sink.release(token)

    for j in range(int(traffic["warmup_frames"])):
        one(j)
    marks.append(("warm-up", time.monotonic()))
    if not tracer.warm(lambda: one(0)):
        say(f"trace: none of {window.ATTEMPTS} profiles in set-up recorded an operation on the "
            "card, so no per-layer metric can be read; no result")
        return 4
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("tracer", time.monotonic()))
    say("setup: before the harness " + f"{marks[0][1] - started:.3f} s, " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
    offset = time.perf_counter() - time.monotonic()

    # the window
    loop = cat.module("loops", traffic["loop"])
    t0, records = loop.run(call, inputs, traffic, args.seconds, sink, tracer)
    if hasattr(loop, "report"):
        say(loop.report(records, traffic))
    setup_s = t0 - (started + offset)

    # after the window: memory, the modules loaded, the system freed
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = importcheck.forbidden_loaded()
    if found:
        say(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    kept = sink.outputs_kept()
    states, start = sink.states_kept(), sink.start
    sut.close()
    del sut, call, sink
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = None
    if args.trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            if tracer.export(path):
                from benchmark.timeline import Timeline

                summary = Timeline.load(path).summary()
        shown = {k: v for k, v in (summary or {}).items() if k not in ("device_ops", "idle_gaps")}
        say(f"trace: {json.dumps(shown)}")
        if dev.type == "cuda" and not (summary or {}).get("busy_s"):
            say(f"trace: {tracer.attempts} profiles of the window recorded no operation on the "
                "card, so no per-layer metric can be read; no result")
            return 4

    say(_calls(records, tracer.span_s))
    ctx = Context(cell, config, traffic, args.seconds, setup_s, t0, records, summary)
    metrics = {}
    for m in cat.metrics(cell["name"], bool(args.trace)):
        value = cat.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    say("metrics: " + ", ".join(f"{k} {v['value']} {v['unit']}" for k, v in metrics.items()))

    # the check against the plain reference
    reference = cat.module("references", config["reference"])
    ref = reference.Reference(config, dev)
    per_frame = []
    t_check = time.perf_counter()
    for index, got in kept.items():
        if start is None:
            want = [t.float().cpu().numpy() for t in ref(*inputs[index % len(inputs)])]
            per_frame.append(reference.numbers(got, want, limits))
            continue
        # a stateful system: the frame from the program's own state before
        # it, and the reference's next state against the program's after it
        before, after = states[index]
        want, want_next = ref.step(before, *inputs[index % len(inputs)], follow=after)
        want = [t.float().cpu().numpy() for t in want]
        per_frame.append(reference.numbers(got, want, limits, after, want_next))
    if start is not None:  # the state the program starts from, before its first call
        per_frame.append(reference.start_numbers(start, ref.initial_state(), limits))
    say(f"check: {len(kept)} frames {sorted(kept)}{'' if start is None else ' and the start'}"
        f" against the reference in {time.perf_counter() - t_check:.3f} s")
    for line in getattr(reference, "notes", lambda r: [])(ref):
        say(line)
    del states, start
    ok, check = (compare.verdict(compare.worst(per_frame, reference.NAMES), limits,
                                 reference.NAMES) if kept else (False, {}))
    failed = sum(1 for r in records if r.done is None)
    ok = ok and failed == 0

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        info["power"] = _power_limit()
    result = {"correct": bool(ok), "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": info}
    if summary:
        info["busy_s"], info["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = check
    for name, c in check.items():
        say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
