"""Whole runs of the tiny cells on the CPU, the check for a card skipped:
sound runs come out correct; the control and each planted fault of the
timed path come out not correct; without a card a run prints nothing."""

import dataclasses
import json

import pytest
import torch

from benchmark import control, harness, window


def run(tiny, capsys, cell, seed=2**31 + 7, trace=0, wrap=None):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
                       "--trace", str(trace)], catalog=tiny, device="cpu", wrap=wrap)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    # the numbers compared close standard error and the result line
    assert list(result)[-1] == "check"
    tail = err.strip().splitlines()[-3:]
    assert [line.split()[1] for line in tail] == list(result["check"])
    return result


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["tiny-prod-cam20", "tiny-full-replay"])
def test_sound_runs_are_correct(tiny, capsys, cell):
    r = run(tiny, capsys, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    spec = {m["name"]: m for m in tiny.metrics(cell, traced=False)}
    assert set(r["metrics"]) == set(spec)
    assert all(r["metrics"][k]["unit"] == spec[k]["unit"] for k in spec)
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_run_reports_the_per_layer_metrics(tiny, capsys):
    r = run(tiny, capsys, "tiny-prod-replay", trace=1)
    assert r["correct"] is True
    # the CPU's trace holds no device work: only the host's metric is read
    assert set(r["metrics"]) == {"call_host_ms.replay"}


def test_an_empty_profile_is_traced_again(tiny, capsys, monkeypatch):
    """A profile of the window that recorded no operation on the card is
    thrown away and the next frames are traced; the run still reads its
    per-layer metrics and is correct."""
    asked = []

    def holds(self, prof):
        asked.append(prof)
        return len(asked) != 2  # the set-up's profile sees the card, the window's first does not

    monkeypatch.setattr(window.Tracer, "_holds_device_work", holds)
    r = run(tiny, capsys, "tiny-prod-replay", trace=1)
    assert r["correct"] is True and set(r["metrics"]) == {"call_host_ms.replay"}
    assert len(asked) == 3 and asked[1] is not asked[2]


def test_a_profiler_blind_to_the_card_gives_no_result(tiny, capsys, monkeypatch):
    monkeypatch.setattr(window.Tracer, "_holds_device_work", lambda self, prof: False)
    rc = harness.main(["--workload", "tiny-prod-replay", "--seed", "3", "--seconds", "1",
                       "--trace", "1"], catalog=tiny, device="cpu")
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no result" in err


def stale(pipe):
    """A step that returns its state unchanged: each frame gets the maps of
    the frame before it."""
    last = []

    def call(left, right):
        fresh = pipe(left, right)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    return call


def altered(pipe):
    """An answer altered where it is produced: a quarter pixel added to the
    disparity of the top rows."""
    def call(left, right):
        r = pipe(left, right)
        d = r.disparity.clone()
        d[: d.shape[0] // 4] += 0.25
        return dataclasses.replace(r, disparity=d)

    return call


def scaled_depth(pipe):
    """An answer altered in the depth conversion alone."""
    def call(left, right):
        r = pipe(left, right)
        return dataclasses.replace(r, depth_m=r.depth_m * 1.001)

    return call


@pytest.mark.parametrize("fault", [stale, altered, scaled_depth])
@pytest.mark.parametrize("cell", ["tiny-prod-cam20", "tiny-full-replay"])
def test_planted_faults_are_not_correct(tiny, capsys, fault, cell):
    assert run(tiny, capsys, cell, wrap=fault)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny-prod-cam20", "tiny-full-replay"])
def test_the_control_is_not_correct(tiny, cell):
    out = control.readings(tiny, cell, 2**31 + 5, torch.device("cpu"))
    assert out["correct"] is False and out["dtype"] == "bfloat16"


def test_no_card_no_result(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "tiny-prod-cam20", "--seed", "1", "--seconds", "1"],
                      catalog=tiny)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err
