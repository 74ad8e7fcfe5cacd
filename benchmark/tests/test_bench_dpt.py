"""The ``dpt-mono`` cell at a tiny size on the CPU (``DPT_TINY``'s widths,
a 160x90 camera, the network at 64x128), the check for a card skipped: a
sound run is correct; a stale frame, the network at bfloat16, a constant
map and the bfloat16 control are not. The readers of the program's
``mono.*`` and ``dpt.*`` spans on a made-up trace, and nothing read where
the program opens none of them."""

import json

import pytest
import torch

from benchmark import control, dpt_work, harness, timeline
from benchmark.catalog import Catalog
from benchmark.harness import Context
from benchmark.window import Frame

CELL = "tiny-dpt-mono"
TINY_DPT = {"embed_dim": 32, "depth": 4, "num_heads": 4, "mlp_ratio": 2, "patch_size": 16,
            "img_size": 64, "hooks": [0, 1, 2, 3], "post_channels": [8, 12, 16, 16],
            "features": 16, "num_classes": 10}
READERS = ("net_device_ms.mono", "encoder_device_ms.mono", "decoder_device_ms.mono",
           "net_roofline.mono")


@pytest.fixture(scope="module")
def cat(tiny):
    """The tiny copy with ``tiny_dpt-large``: the configuration at
    ``DPT_TINY``'s widths and a small camera, the same limits."""
    c = json.loads((tiny.root / "configs" / "dpt-large.json").read_text())
    c.update(name="tiny_dpt-large", camera={"width": 160, "height": 90}, net_hw=[64, 128],
             dpt=TINY_DPT)
    (tiny.root / "configs" / "tiny_dpt-large.json").write_text(json.dumps(c))
    (tiny.root / "limits" / "tiny_dpt-large.json").write_bytes(
        (tiny.root / "limits" / "dpt-large.json").read_bytes())
    return tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cat, capsys, trace=0, wrap=None):
    rc = harness.main(["--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "1.0",
                       "--trace", str(trace)], catalog=cat, device="cpu", wrap=wrap)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(cat, capsys):
    r = run(cat, capsys)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(r["check"]) == {"depth_err", "conf_err"}
    # traced on the CPU: no device work, so only the host's metric is read
    assert set(run(cat, capsys, trace=1)["metrics"]) == {"call_host_ms.mono"}


def stale(call):
    """Each frame gets the maps of the frame before it."""
    last = []

    def f(frame):
        fresh = call(frame)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    return f


def bfloat16(call):
    """The network's products in bfloat16."""
    def f(frame):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            return call(frame)

    return f


def constant(call):
    """A depth map of one value."""
    def f(frame):
        depth, conf = call(frame)
        return torch.zeros_like(depth), conf

    return f


@pytest.mark.parametrize("fault", [stale, bfloat16, constant])
def test_planted_faults_are_not_correct(cat, capsys, fault):
    r = run(cat, capsys, wrap=fault)
    assert r["correct"] is False and r["check"]["depth_err"]["value"] > 10 * r["check"][
        "depth_err"]["limit"]


def test_the_control_is_not_correct(cat):
    out = control.readings(cat, CELL, 2**31 + 5, torch.device("cpu"))
    assert out["correct"] is False and out["dtype"] == "bfloat16"


def _ev(kind, name, ts_us, dur_us, corr=None):
    e = {"ph": "X", "cat": kind, "name": name, "ts": ts_us, "dur": dur_us, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up_trace(program_spans=True):
    """Two frames of 30 ms, each one call whose network runs an encoder
    kernel of 20 ms and a decoder kernel of 6 ms."""
    events = []
    for k, t in enumerate((0, 40000)):
        c = 10 * k
        events += [_ev("user_annotation", "frame", t, 30000),
                   _ev("user_annotation", "call", t + 100, 29000),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 1100, 10, corr=c + 1),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 1300, 10, corr=c + 2),
                   _ev("kernel", "gemm", t + 1200, 20000, corr=c + 1),
                   _ev("kernel", "conv", t + 21300, 6000, corr=c + 2)]
        if program_spans:
            events += [_ev("user_annotation", "mono.net", t + 1000, 500),
                       _ev("user_annotation", "dpt.blocks", t + 1050, 100),
                       _ev("user_annotation", "dpt.embed", t + 1010, 20),
                       _ev("user_annotation", "dpt.reassemble", t + 1250, 100),
                       _ev("user_annotation", "dpt.fusion", t + 1360, 50),
                       _ev("user_annotation", "dpt.head", t + 1420, 50)]
    return events


def context(cat, events):
    summary = timeline.Timeline(events).summary()
    config = cat.config("dpt-large")
    return Context({}, config, {}, 20.0, 5.0, 0.0,
                   [Frame(0, 0.0, 0.0, 0.029, 0.03), Frame(1, 0.04, 0.04, 0.029, 0.07)],
                   summary)


def test_the_program_spans_readers():
    cat = Catalog()
    ctx = context(cat, made_up_trace())
    read = {name: cat.reader(name)(ctx) for name in READERS}
    assert read["net_device_ms.mono"] == pytest.approx(26.0)
    assert read["encoder_device_ms.mono"] == pytest.approx(20.0)
    assert read["decoder_device_ms.mono"] == pytest.approx(6.0)
    least = dpt_work.least_seconds(dpt_work.stages(ctx.config))
    assert read["net_roofline.mono"] == pytest.approx(100 * least / 26e-3)
    # two frames of the full network's operations in 60 ms of service
    assert cat.reader("mfu.mono")(ctx) == pytest.approx(
        100 * 2 * dpt_work.flops(ctx.config) / (60e-3 * 67e12))


def test_a_program_without_its_spans_reads_nothing():
    cat = Catalog()
    ctx = context(cat, made_up_trace(program_spans=False))
    assert {name: cat.reader(name)(ctx) for name in READERS} == dict.fromkeys(READERS)
    assert cat.reader("mfu.mono")(ctx) is not None  # the harness's own spans
    ctx.trace = None
    assert {name: cat.reader(name)(ctx) for name in (*READERS, "mfu.mono")} == dict.fromkeys(
        (*READERS, "mfu.mono"))


def test_the_cells_yardstick_imports_nothing_of_the_program():
    """The reference, the work count and the generator import neither the
    program nor JAX (``test_bench_imports`` holds the older files)."""
    import ast
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1]
    for name in ("references/dpt_depth.py", "dpt_work.py", "generators/camera.py"):
        for node in ast.walk(ast.parse((bench / name).read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for mod in mods:
                top = mod.split(".", 1)[0]
                assert not top.startswith("stereovision") and top not in ("jax", "flax"), (name,
                                                                                          mod)
