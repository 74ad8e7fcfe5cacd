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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cat = Catalog()
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(cat, args.workload, seed, torch.device(args.device))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
