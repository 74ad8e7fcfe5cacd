"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): the ``cuda`` marker, for tests that need an NVIDIA
card and skip without one, and the tiny copy of the benchmark that the CPU
tests run."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    """Skips the test where torch sees no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


TINY = {"width": 256, "height": 96, "num_disparities": 64}


def tiny_copy(dest: Path) -> Path:
    """A copy of the benchmark (its folder and its spec) under ``dest``,
    with a cell added by files alone for each of the four cells: the
    configuration at 256x96 and D=64, the mix with a ring of 4 frames at
    4 frames/s (an open loop), the same limits. Returns the copy's folder."""
    root = dest / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("production", "full"):
        c = json.loads((root / "configs" / f"{name}.json").read_text())
        c["name"] = f"tiny_{name}"
        c["rig"].update(width=TINY["width"], height=TINY["height"])
        c["pipeline"]["params"]["num_disparities"] = TINY["num_disparities"]
        (root / "configs" / f"tiny_{name}.json").write_text(json.dumps(c))
        shutil.copy(root / "limits" / f"{name}.json", root / "limits" / f"tiny_{name}.json")
    for name in sorted({w["traffic"] for w in spec["workloads"]}):
        t = json.loads((root / "traffic" / f"{name}.json").read_text())
        t["scene"]["ring_frames"] = 4
        t.update(warmup_frames=1, check_frames=2, trace={"start_fraction": 0.0, "frames": 2})
        if "fps" in t:
            t["fps"] = 4
        (root / "traffic" / f"tiny_{name}.json").write_text(json.dumps(t))
    for cell in list(spec["workloads"]):
        new = dict(cell, name=f"tiny-{cell['name']}", config=f"tiny_{cell['config']}",
                   traffic=f"tiny_{cell['traffic']}")
        spec["workloads"].append(new)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                m["workloads"].append(new["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """The tiny copy's catalog."""
    from benchmark.catalog import Catalog

    root = tiny_copy(tmp_path_factory.mktemp("bench"))
    return Catalog(root)
