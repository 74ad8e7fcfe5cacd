#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards;
without them it exits with 2 and prints no result.
"""

import time

_STARTED = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402


def process_age() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (0 where there is none to read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    _STARTED -= process_age()
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], started=_STARTED))
