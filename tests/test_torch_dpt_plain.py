"""The port's DPT (``models/dpt.py``) and ``mono.nn.estimate_depth`` against
the benchmark's plain reference (``benchmark/references/dpt_depth.py``),
which imports nothing of the program.

The reference's hub names and shapes equal the port's
``expected_manifest`` at ``DPT_LARGE`` (built on ``meta``) and at
``DPT_TINY``. The reference's seeded weights load through
``create_model(arch="dpt_large", torch_state_dict=...)``, the hub
checkpoint's path; at ``DPT_TINY`` the forward agrees within 1e-5 of the
output's range at a square grid (64×64, the native 4×4) and a non-square
one (64×128: the position embedding resized from 4×4 to 4×8), and
``estimate_depth`` on a uint8 BGR frame agrees with the reference's pre-
and post-processing within 1e-5 of each map's range. ``dpt_work``'s count
of the products' operations is within 2% of
``torch.utils.flop_counter``'s count of the port's forward, at
``DPT_TINY`` and at full width on ``meta``. A profiled ``estimate_depth``
writes the ``mono.*`` spans around the ``dpt.*`` ones.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import dpt_work
from benchmark.references import dpt_depth
from stereovision_tpu_torch.models import dpt as tdpt
from stereovision_tpu_torch.mono import nn as tnn

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "dpt-large.json").read_text())
GRIDS = ((64, 64), (64, 128))
TOL = 1e-5  # of the output's range: float32 products summed in another order


def widths(cfg: tdpt.DPTConfig) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(cfg).items()}


def tiny_config(net_hw, seed=5) -> dict:
    return dict(CONFIG, dpt=widths(tdpt.DPT_TINY), net_hw=list(net_hw), weights_seed=seed)


def port(config):
    cfg = tdpt.DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in config["dpt"].items()})
    return tnn.create_model(arch="dpt_large", dpt_cfg=cfg, net_hw=tuple(config["net_hw"]),
                            torch_state_dict=dpt_depth.weights(config, "cpu"), device="cpu")


def test_the_config_states_dpt_large():
    assert CONFIG["dpt"] == widths(tdpt.DPT_LARGE)
    assert CONFIG["net_hw"] == [384, 672]


@pytest.mark.parametrize("cfg", [tdpt.DPT_LARGE, tdpt.DPT_TINY], ids=["large", "tiny"])
def test_reference_names_and_shapes_are_the_ports(cfg):
    got = [(k, tuple(s)) for k, s in dpt_depth.manifest(widths(cfg))]
    assert got == list(tdpt.expected_manifest(cfg))
    if cfg == tdpt.DPT_LARGE:
        assert sum(int(np.prod(s)) for _, s in got) == 344_055_465


@pytest.mark.parametrize("hw", GRIDS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_forward_matches_the_plain_reference(hw):
    config = tiny_config(hw)
    x = torch.from_numpy(np.random.default_rng(hw[1]).uniform(0, 1, (*hw, 3)).astype(np.float32))
    with torch.no_grad():
        got = port(config)(x[None])[0]
        want = dpt_depth.dpt_forward(dpt_depth.weights(config, "cpu"), config["dpt"], x)
    span = float(want.max() - want.min())
    assert got.shape == want.shape == hw and span > 0
    assert float((got - want).abs().max()) <= TOL * span


@pytest.mark.parametrize("hw", GRIDS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_estimate_depth_matches_the_plain_reference(hw):
    config = tiny_config(hw)
    frame = np.random.default_rng(7).integers(0, 256, (72, 136, 3), dtype=np.uint8)
    got = tnn.estimate_depth(port(config), frame, net_hw=hw, device="cpu")
    want = dpt_depth.Reference(config, "cpu")(frame)
    for g, w, top in zip(got, want, (255.0, 1.0)):
        assert g.shape == w.shape == frame.shape[:2]
        assert float(w.max() - w.min()) == pytest.approx(top)
        assert float((g - w).abs().max()) <= TOL * top


def test_a_constant_reference_map_fails_the_check():
    depth = np.full((8, 8), 0.0, np.float32)
    conf = np.zeros((8, 8), np.float32)
    n = dpt_depth.numbers((depth, conf), (depth, conf), {})
    assert n == {"depth_err": dpt_depth.WORST, "conf_err": 0.0}


@pytest.mark.parametrize("name", ["tiny", "large"])
def test_work_counts_the_flop_counters_operations(name):
    cfg, hw = {"tiny": (tdpt.DPT_TINY, (64, 128)), "large": (tdpt.DPT_LARGE, (384, 672))}[name]
    config = dict(CONFIG, dpt=widths(cfg), net_hw=list(hw))
    device = "cpu" if name == "tiny" else "meta"
    with torch.device(device):
        model = tdpt.DPTDepth(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, *hw, 3, device=device))
    assert dpt_work.flops(config) == pytest.approx(counter.get_total_flops(), rel=0.02)
    assert dpt_work.least_seconds(dpt_work.stages(config)) > 0


def test_estimate_depth_opens_its_spans():
    config = tiny_config((64, 128))
    model = port(config)
    frame = np.random.default_rng(3).integers(0, 256, (72, 136, 3), dtype=np.uint8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tnn.estimate_depth(model, frame, net_hw=(64, 128), device="cpu")
    spans = {}
    for e in prof.events():
        if e.name.startswith(("mono.", "dpt.", "sync.")):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(spans) == {"mono.upload", "mono.resize", "mono.net", "mono.post", "dpt.embed",
                          "dpt.blocks", "dpt.reassemble", "dpt.fusion", "dpt.head"}
    assert all(len(v) == 1 for v in spans.values())
    (n0, n1), = spans["mono.net"]
    assert all(n0 <= s and t <= n1 for k, ((s, t),) in spans.items() if k.startswith("dpt."))
