#!/usr/bin/env python3
"""The comparison's control: the plain reference computed in a lower
precision than the configuration states (bfloat16 for its float32), put
in the program's place, judged by the same comparison and limits as a run.
It must come out not correct; its readings are the limits' upper ends.

    python3 benchmark/control.py --workload prod-cam20 --seeds 11 12 13

For each seed it draws the cell's frames as a run does, takes
``check_frames`` of the ring's frames (drawn from the seed), and prints
one JSON line with the worst frame's numbers and whether they pass.
Not run by the benchmark's runs.

A cell whose reference steps a state (``Reference.step``) is checked from
the program's own states, so its control needs them: the program runs the
mix's warm-up frames and then ``--frames`` more, a snapshot before each,
and ``check_frames`` of those (drawn from the seed) are compared, each
frame from the program's state before it, as a run compares them. The
line then holds the program's readings (the limits' lower ends) beside
those of each control put in its place: the reference with TF32 on and in
bfloat16, the reference stepped from the state one frame stale, and the
reference with each of its planted faults (``fused_frame.Reference``'s
``faults``); each with the largest gaps of its maps, and the reference's
notes on the near-ties it chose among.
"""

import argparse
import json
import os
import sys
import time

if not __package__:  # run as a script: import the benchmark as a package
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare  # noqa: E402
from benchmark.catalog import Catalog  # noqa: E402


def readings(catalog: Catalog, workload: str, seed: int, device, dtype=torch.bfloat16) -> dict:
    cell = catalog.cell(workload)
    config, traffic = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    limits = catalog.limits(cell["config"])
    inputs = catalog.module("generators", traffic["generator"]).inputs(config, traffic, seed,
                                                                       device)
    rng = np.random.default_rng(np.random.SeedSequence(seed % (1 << 64)))
    picks = sorted(rng.choice(len(inputs), size=min(len(inputs), traffic["check_frames"]),
                              replace=False).tolist())
    reference = catalog.module("references", config["reference"])
    ref = reference.Reference(config, device)
    low = reference.Reference(config, device, dtype=dtype)
    per_frame = []
    for j in picks:
        want = [t.float().cpu().numpy() for t in ref(*inputs[j])]
        got = [t.float().cpu().numpy() for t in low(*inputs[j])]
        per_frame.append(reference.numbers(got, want, limits))
    ok, check = compare.verdict(compare.worst(per_frame, reference.NAMES), limits,
                                reference.NAMES)
    return {"workload": workload, "seed": seed, "dtype": str(dtype).removeprefix("torch."),
            "frames": picks, "correct": ok, "check": check}


# a stateful cell's controls: (the reference's settings, whether the state
# fed to it is one frame stale)
STATEFUL_CONTROLS = {
    "tf32": ({"dtype": "tf32"}, False),
    "bfloat16": ({"dtype": torch.bfloat16}, False),
    "stale_state": ({}, True),
    "alpha_moving": ({"faults": ("alpha",)}, False),
    "flow_on_right": ({"faults": ("flow_right",)}, False),
    "rng_ahead": ({"faults": ("rng_ahead",)}, False),
}


def stateful_readings(catalog: Catalog, workload: str, seed: int, device, frames: int = 24) -> dict:
    """The program's readings and each control's, from the program's own
    states (see the module's notes)."""
    cell = catalog.cell(workload)
    config, traffic = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    limits = catalog.limits(cell["config"])
    inputs = catalog.module("generators", traffic["generator"]).inputs(config, traffic, seed,
                                                                       device)
    sut = catalog.module("systems", config["system"]).build(config, device)
    for j in range(int(traffic["warmup_frames"])):
        sut.call(*inputs[j % len(inputs)])
    states, outs = [sut.snapshot()], []
    for k in range(frames):
        outs.append([t.clone() for t in sut.outputs(sut.call(*inputs[k % len(inputs)]))])
        states.append(sut.snapshot())
    outs = [[t.float().cpu().numpy() for t in o] for o in outs]
    sut.close()
    del sut
    rng = np.random.default_rng(np.random.SeedSequence(seed % (1 << 64)))
    picks = sorted((1 + rng.choice(frames - 1, size=min(frames - 1, traffic["check_frames"]),
                                   replace=False)).tolist())
    reference = catalog.module("references", config["reference"])
    ref = reference.Reference(config, device)
    wants = {k: ref.step(states[k], *inputs[k % len(inputs)], follow=states[k + 1])
             for k in picks}

    def judged(step, stale, got=None):
        per_frame, per_gaps = [], []
        for k in picks:
            want, want_next = wants[k]
            want = [t.float().cpu().numpy() for t in want]
            if got is None:  # a control, handed the program's next state as the reference is
                mine, mine_next = step(states[k - 1 if stale else k], *inputs[k % len(inputs)],
                                       follow=states[k + 1])
                mine = [t.float().cpu().numpy() for t in mine]
            else:
                mine, mine_next = got[k], states[k + 1]
            per_frame.append(reference.numbers(mine, want, limits, mine_next, want_next))
            per_gaps.append(reference.gaps(mine, want))
        ok, check = compare.verdict(compare.worst(per_frame, reference.NAMES), limits,
                                    reference.NAMES)
        # the largest gaps of the maps, which the reference's tolerances bound
        return {"correct": ok, "check": {k: v["value"] for k, v in check.items()},
                "gaps": {key: max(g[key] for g in per_gaps) for key in per_gaps[0]}}

    out = {"workload": workload, "seed": seed, "frames": picks,
           "program": judged(None, False, outs), "notes": reference.notes(ref)}
    for name, (settings, stale) in STATEFUL_CONTROLS.items():
        out[name] = judged(reference.Reference(config, device, **settings).step, stale)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=24,
                    help="a stateful cell's frames after the warm-up")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cat = Catalog()
    cell = cat.cell(args.workload)
    reference = cat.module("references", cat.config(cell["config"])["reference"])
    for seed in args.seeds:
        t = time.perf_counter()
        if hasattr(reference.Reference, "step"):
            out = stateful_readings(cat, args.workload, seed, torch.device(args.device),
                                    args.frames)
        else:
            out = readings(cat, args.workload, seed, torch.device(args.device))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
