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
# the fused configuration's: an 800x480 rig at scale 0.2 processes at
# 160x96 with D = 320 x 0.2 = 64 (a coarse search and a refine window)
TINY_FUSED = {"width": 800, "height": 480, "scale": 0.2, "processing_size": [160, 96],
              "num_disparities": 64}


# The fused cell's entries of the spec. They are not in ``BENCHMARK.json``:
# on the card the cell's frames_per_s spreads more between runs than half
# of the largest bound allows (PERF.md); the tests hold its harness, its
# reference and its readers all the same, from copies of the spec that hold
# these entries (``with_fused``). Admitting the cell is adding them to the
# spec.
FUSED = {
    "configs": [{
        "name": "fused",
        "source": "https://github.com/AlexGr5/StereoVision/blob/main/fused_depth_map.py#L36-L126 "
                  "(PROCESSING_SCALE 0.33, fusion settings) and its main loop L2150-L3399",
        "file": "benchmark/configs/fused.json", "reduced": [],
        "why": "the reference's headline app: stereo (hier, D=96) + MiDaS v2.1 small + "
               "motion depth with the occlusion guard at 422x236, float32, TF32 off; state "
               "frame to frame"}],
    "workloads": [{
        "name": "fused-live", "config": "fused", "traffic": "fused-live", "chips": 1,
        "why": "1280x720 pairs back to back, one in flight, fused at 422x236: hier D=96, "
               "MiDaS small 256x256, LK flow, RANSAC; host dispatch and latency set the "
               "frame, not size"}],
    "end_to_end": ["frames_per_s"],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": "frames_per_s", "workloads": ["fused-live"]}
        for name, unit, better, source, layer in (
            ("call_host_ms.fused", "ms", "lower", "host_clock", "fused pipeline"),
            ("idle_share.fused", "%", "lower", "device_trace", "device"),
            ("net_device_ms.fused", "ms", "lower", "device_trace", "mono-depth network"),
            ("stereo_device_ms.fused", "ms", "lower", "device_trace",
             "stereo engine and its kernels"),
            ("other_device_ms.fused", "ms", "lower", "device_trace", "fused pipeline"),
            ("mfu.fused", "%", "higher", "device_trace", "device"))],
}


def with_fused(spec: dict) -> dict:
    """A copy of ``spec`` that holds the fused cell's entries (``FUSED``)
    where it does not hold them already."""
    spec = json.loads(json.dumps(spec))
    for key in ("configs", "workloads", "per_layer"):
        have = {e["name"] for e in spec[key]}
        spec[key] += [e for e in FUSED[key] if e["name"] not in have]
    for m in spec["end_to_end"]:
        if m["name"] in FUSED["end_to_end"] and "fused-live" not in m["workloads"]:
            m["workloads"].append("fused-live")
    return spec


def fused_copy(dest: Path) -> Path:
    """A copy of the benchmark under ``dest`` whose spec holds the fused
    cell (``with_fused``); run it with the repository on ``PYTHONPATH``.
    Returns the copy's folder."""
    root = dest / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    spec = with_fused(json.loads((REPO / "BENCHMARK.json").read_text()))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def tiny_copy(dest: Path) -> Path:
    """A copy of the benchmark (its folder and its spec, with the fused
    cell's entries: ``with_fused``) under ``dest``, with a cell added by
    files alone for each of its cells: the depth configurations at 256x96
    and D=64, the fused one at 160x96 and D=64 (``TINY_FUSED``), the mix
    with a ring of 4 frames at 4 frames/s (an open loop), the same limits.
    Returns the copy's folder."""
    root = dest / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    spec = with_fused(json.loads((REPO / "BENCHMARK.json").read_text()))
    for name in ("production", "full", "fused"):
        c = json.loads((root / "configs" / f"{name}.json").read_text())
        c["name"] = f"tiny_{name}"
        if name == "fused":
            c["rig"].update(width=TINY_FUSED["width"], height=TINY_FUSED["height"])
            c["fused"].update(scale=TINY_FUSED["scale"],
                              processing_size=TINY_FUSED["processing_size"])
            c["sgm"]["num_disparities"] = TINY_FUSED["num_disparities"]
        else:
            c["rig"].update(width=TINY["width"], height=TINY["height"])
            c["pipeline"]["params"]["num_disparities"] = TINY["num_disparities"]
        (root / "configs" / f"tiny_{name}.json").write_text(json.dumps(c))
        shutil.copy(root / "limits" / f"{name}.json", root / "limits" / f"tiny_{name}.json")
    for name in sorted({w["traffic"] for w in spec["workloads"]}):
        t = json.loads((root / "traffic" / f"{name}.json").read_text())
        t["scene"]["ring_frames"] = 4
        t.update(warmup_frames=1, check_frames=2, trace={"start_fraction": 0.0, "frames": 2})
        if t["generator"] == "scene_pingpong":
            # the window starts again at the ring's first frame: after two
            # warm-up frames it differs from the last (a frame that repeats
            # the one before has no motion, and its flow depth is noise)
            t["warmup_frames"] = 2
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
