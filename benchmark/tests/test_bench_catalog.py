"""Discovery by name: configurations, mixes, limits and metric readers are
files found by the names in the spec, and a new cell or metric is added
by files and entries alone."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.catalog import Catalog
from benchmark.conftest import tiny_copy, with_fused


def test_the_spec_names_files_that_exist():
    cat = Catalog()
    spec = cat.spec
    for c in spec["configs"]:
        assert cat.config(c["name"])["name"] == c["name"]
        assert (cat.root.parent / c["file"]).is_file()
        assert cat.limits(c["name"])
    for w in spec["workloads"]:
        assert cat.traffic(w["traffic"])["loop"] in ("open", "closed")
        assert w["chips"] == 1
        for traced in (False, True):
            names = [m["name"] for m in cat.metrics(w["name"], traced)]
            assert names, (w["name"], traced)
            for n in names:
                assert callable(cat.reader(n))
        assert "setup_s" in [m["name"] for m in cat.metrics(w["name"], False)]


def test_metric_names_resolve_to_their_files():
    cat = Catalog()
    assert cat.reader("call_host_ms.live") is not None
    with pytest.raises(KeyError):
        cat.reader("no_such_metric.live")
    with pytest.raises(KeyError):
        cat.config("no_such_config")
    assert [m["name"] for m in cat.metrics("full-cam60", False)] == ["latency_p50_ms", "setup_s"]
    assert [m["name"] for m in cat.metrics("prod-cam20", False)] == ["latency_p50_ms", "setup_s"]
    assert [m["name"] for m in cat.metrics("full-replay", True)] == [
        "call_host_ms.replay", "engine_roofline.replay", "idle_share.replay",
        "upload_device_ms.replay", "host_syncs.replay", "graph_replays.replay"]
    assert [m["name"] for m in cat.metrics("dpt-mono", False)] == ["frames_per_s", "setup_s"]


NEW_FILES = {
    # a metric's reader
    "metrics/frames_done.py": (
        '"""frames_done: frames whose outputs reached the host."""\n\n\n'
        "def read(ctx):\n    return float(sum(r.done is not None for r in ctx.records))\n"),
    # a generator: the scene's first frame, still
    "generators/still.py": (
        '"""The generator ``still``: the first frame of the scene, repeated."""\n\n'
        "from benchmark.generators import scene\n\n\n"
        "def inputs(config, traffic, seed, device):\n"
        "    first = scene.inputs(config, traffic, seed, device)[0]\n"
        "    return [first] * traffic['scene']['ring_frames']\n"),
    # a loop: a fixed count of frames, one at a time
    "loops/counted.py": (
        '"""The loop ``counted``: as many frames as the mix says, one at a time."""\n\n'
        "import time\n\nfrom benchmark.window import Frame, timed_call\n\n\n"
        "def run(call, inputs, traffic, seconds, sink, tracer):\n"
        "    records, t0 = [], time.perf_counter()\n"
        "    for k in range(traffic['frames']):\n"
        "        tracer.before(time.perf_counter() - t0, seconds)\n"
        "        with tracer.span('frame'):\n"
        "            start = time.perf_counter()\n"
        "            result, call_s = timed_call(call, inputs[k % len(inputs)], tracer)\n"
        "            token = sink.put(result)\n"
        "            sink.wait(token)\n"
        "        sink.done(k, token)\n"
        "        records.append(Frame(k, start, start, call_s, time.perf_counter()))\n"
        "        tracer.after()\n"
        "    tracer.stop()\n"
        "    return t0, records\n"),
    # a system: the depth pipeline's, found under another name
    "systems/depth_again.py": (
        '"""The system ``depth_again``: the depth pipeline, under a name of its own."""\n\n'
        "import importlib.util\nimport pathlib\n\n"
        "_spec = importlib.util.spec_from_file_location(\n"
        "    'depth_again_base', pathlib.Path(__file__).with_name('depth_pipeline.py'))\n"
        "_base = importlib.util.module_from_spec(_spec)\n_spec.loader.exec_module(_base)\n"
        "PROGRAM = _base.PROGRAM\nbuilt = []\n\n\n"
        "def build(config, device):\n"
        "    built.append(config['name'])\n"
        "    return _base.build(config, device)\n"),
}


def test_a_new_cell_loop_generator_system_and_metric_by_files_alone(tmp_path, capsys):
    """A copy of the benchmark gains a configuration naming a new system, a
    mix naming a new generator and a new loop, a metric's reader and their
    spec entries, without a change to any file it had, and its new cell
    runs on the new modules."""
    root = tiny_copy(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    for name, text in NEW_FILES.items():
        (root / name).write_text(text)
    c = json.loads((root / "configs" / "tiny_full.json").read_text())
    c.update(name="tiny_full_again", system="depth_again")
    (root / "configs" / "tiny_full_again.json").write_text(json.dumps(c))
    (root / "limits" / "tiny_full_again.json").write_bytes(
        (root / "limits" / "tiny_full.json").read_bytes())
    t = json.loads((root / "traffic" / "tiny_replay.json").read_text())
    t.update(generator="still", loop="counted", frames=3)
    (root / "traffic" / "tiny_still3.json").write_text(json.dumps(t))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-new", "config": "tiny_full_again",
                              "traffic": "tiny_still3", "chips": 1, "why": "added by files alone"})
    next(m for m in spec["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "tiny-new")
    spec["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "pipeline",
                              "moves": "frames_per_s", "workloads": ["tiny-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)

    torch.set_num_threads(2)
    cat = Catalog(root)
    for traced in (0, 1):
        rc = harness.main(["--workload", "tiny-new", "--seed", "3", "--seconds", "1",
                           "--trace", str(traced)], catalog=cat, device="cpu")
        out, err = capsys.readouterr()
        assert rc == 0, err
        r = json.loads(out.strip().splitlines()[-1])
        assert r["correct"] is True and r["attempted"] == 3
        want = {"frames_done"} if traced else {"frames_per_s", "setup_s"}
        assert set(r["metrics"]) == want
    assert cat.module("systems", "depth_again").built == ["tiny_full_again"] * 2


def test_the_fused_cell_resolves_in_a_copy_of_the_spec_that_holds_it():
    """The fused cell's entries (``conftest.FUSED``) are not in
    ``BENCHMARK.json``; a copy of the spec that holds them
    (``with_fused``) finds every file they name, and its own cells read what
    they read without them."""
    cat = Catalog()
    spec = json.loads(cat.spec_path.read_text())
    assert "fused-live" not in {w["name"] for w in spec["workloads"]}
    cat.spec = with_fused(spec)
    assert with_fused(cat.spec) == cat.spec  # the entries are added once
    cell = cat.cell("fused-live")
    config = cat.config(cell["config"])
    assert (cat.root.parent / cat.spec["configs"][-1]["file"]).is_file()
    assert cat.traffic(cell["traffic"])["loop"] == "closed" and cat.limits(config["name"])
    assert [m["name"] for m in cat.metrics("fused-live", False)] == ["frames_per_s", "setup_s"]
    assert [m["name"] for m in cat.metrics("fused-live", True)] == [
        "call_host_ms.fused", "idle_share.fused", "net_device_ms.fused",
        "stereo_device_ms.fused", "other_device_ms.fused", "mfu.fused"]
    assert all(callable(cat.reader(m["name"])) for m in cat.metrics("fused-live", True))
    assert cat.reader("mfu.fused") is not cat.reader("mfu.mono")
    for name in [w["name"] for w in spec["workloads"]]:
        for traced in (False, True):
            assert ([m["name"] for m in cat.metrics(name, traced)]
                    == [m["name"] for m in Catalog().metrics(name, traced)])
    for key in ("configs", "workloads"):
        for e in cat.spec[key]:
            assert len(e["why"]) <= 200 and len(e.get("source", "")) <= 200
