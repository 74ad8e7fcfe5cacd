"""On the card: every cell of the spec runs whole and comes out correct, a
traced run reads its per-layer metrics from the device trace, and the
control at the cells' own size comes out not correct.

    python -m pytest benchmark/tests/test_bench_cuda.py -q -m cuda
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control
from benchmark.catalog import Catalog
from benchmark.conftest import fused_copy, with_fused

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in Catalog().spec["workloads"]]


def run(cell, seed, trace, root=REPO):
    """A run of ``cell`` from the checkout at ``root`` (a copy of the
    benchmark finds the program on ``PYTHONPATH``)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "2", "--trace", str(trace)], cwd=root,
                         capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def fused_catalog() -> Catalog:
    """The repository's catalog with the fused cell's entries
    (``conftest.FUSED``, not in ``BENCHMARK.json``)."""
    cat = Catalog()
    cat.spec = with_fused(cat.spec)
    return cat


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_on_the_card(cuda, cell):
    r = run(cell, 2**31 + 77, 0)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {m["name"] for m in Catalog().metrics(cell, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:2] + ["fused-live"])
def test_a_traced_run_reads_every_per_layer_metric(cuda, cell, tmp_path):
    cat = fused_catalog()
    root = REPO if cell in CELLS else fused_copy(tmp_path).parent
    r = run(cell, 2**31 + 78, 1, root)
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in cat.metrics(cell, True)}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert all(0 < v["value"] <= 100 for k, v in r["metrics"].items() if v["unit"] == "%")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["prod-cam20", "full-replay"])
def test_the_control_is_not_correct_on_the_card(cuda, cell):
    out = control.readings(Catalog(), cell, 2**31 + 79, torch.device("cuda"))
    assert out["correct"] is False


@pytest.mark.cuda
def test_the_stateful_controls_are_not_correct_on_the_card(cuda):
    out = control.stateful_readings(fused_catalog(), "fused-live", 2**31 + 80,
                                    torch.device("cuda"))
    assert out["program"]["correct"] is True
    assert not any(out[name]["correct"] for name in control.STATEFUL_CONTROLS)
