"""The fused cell on the CPU at a tiny size (160x96, D=64): the plain
reference follows the program frame by frame from the program's own
states; a whole run of the tiny stateful cell comes out correct; a wrong
update of the state, a stale state and the other planted faults, and each
control, come out not correct; the network's count matches torch's flop
counter; the mix walks its ring forth and back."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import control, fused_work, harness, window

CELL = "tiny-fused-live"
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(tiny, capsys, wrap=None, seed=SEED, trace=0):
    rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", "2",
                       "--trace", str(trace)], catalog=tiny, device="cpu", wrap=wrap)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "check"
    return result


def parts(tiny):
    config, traffic = tiny.config("tiny_fused"), tiny.traffic("tiny_fused-live")
    inputs = tiny.module("generators", traffic["generator"]).inputs(config, traffic, SEED,
                                                                   torch.device("cpu"))
    sut = tiny.module("systems", config["system"]).build(config, torch.device("cpu"))
    reference = tiny.module("references", config["reference"])
    return config, inputs, sut, reference, reference.Reference(config, torch.device("cpu"))


def test_the_reference_follows_the_program(tiny):
    """Four frames from the initial state, each computed by the reference
    from the program's state before it (and handed the program's state
    after it, to choose among RANSAC's near-ties). Tolerances: the network's
    output differs in its last bits (the convolutions' order of sums, the
    batch norms' form), and the homography's refits are matrix products in
    the reference (the JAX package's form) where the program sums products,
    so the ego-flow differs in its last bits too; the min-max normalisations
    scale these up to ~4e-4 of a level of the fused map (a hundredth
    allowed), ~3e-5 of the metres' relative value (1e-4 allowed) and ~1e-4
    of the EMA depth's largest value (1e-3 allowed, the state's limit);
    everything else (the rectified images, the stereo maps, the confidence,
    the flags, the generator, the hysteresis) is equal."""
    _, inputs, sut, reference, ref = parts(tiny)
    state = sut.snapshot()
    assert reference.state_error(state, ref.initial_state()) == 0.0
    for k in range(4):
        got = [t.clone() for t in sut.outputs(sut.call(*inputs[k]))]
        after = sut.snapshot()
        want, want_next = ref.step(state, *inputs[k], follow=after)
        fused, conf, meters, mode, moving = got
        assert (fused - want[0]).abs().max() <= 0.01
        assert torch.equal(conf, want[1].to(conf.dtype))
        inside = (meters < 30.0) & (want[2] < 30.0)
        assert ((meters - want[2]).abs() / want[2])[inside].max() <= 1e-4
        assert int(mode) == int(want[3]) and bool(moving) == bool(want[4])
        for key in ("prev_gray", "has_prev", "has_stable", "last_move_time", "rng_state"):
            assert torch.equal(after[key], want_next[key]), key
        top = float(want_next["stable_depth"].abs().max())
        assert float((after["stable_depth"] - want_next["stable_depth"]).abs().max()) <= 1e-3 * top
        for key in ("hysteresis", "frame", "clock"):
            assert after[key] == want_next[key], key
        assert reference.state_error(after, want_next) <= 1e-3
        state = after


def test_a_stateful_run_is_correct(tiny, capsys):
    r = run(tiny, capsys)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 3
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(r["check"]) == list(tiny.module("references", "fused_frame").NAMES)


def state_unchanged(call):
    """A step that returns its state unchanged: the flow state is put back
    after each call."""
    def step(left, right):
        pipe = call.__self__.pipe
        saved = pipe.flow_state
        out = call(left, right)
        pipe.flow_state = saved
        return out

    return step


def ema_off(call):
    """The EMA's moving α off by 0.01 in the program."""
    def step(left, right):
        pipe = call.__self__.pipe
        pipe.flow_params = dataclasses.replace(pipe.flow_params, alpha_moving=0.91)
        return call(left, right)

    return step


def rng_ahead(call):
    """The program's generator advanced by one draw before each frame."""
    def step(left, right):
        g = call.__self__.pipe.flow_state.rng
        torch.randint(0, 2, (1,), generator=g, device=g.device)
        return call(left, right)

    return step


def stale_outputs(call):
    """Each frame gets the outputs of the frame before it."""
    last = []

    def step(left, right):
        fresh = call(left, right)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    return step


def altered(call):
    """An answer altered where it is produced: a level added to the fused
    map's top rows."""
    def step(left, right):
        out = dict(call(left, right))
        fused = out["fused"].clone()
        fused[: fused.shape[0] // 4] += 1.0
        out["fused"] = fused
        return out

    return step


def motion_lost(call):
    """A flag altered where it is produced: the camera never reads as moving."""
    def step(left, right):
        out = dict(call(left, right))
        out["camera_moving"] = torch.zeros_like(out["camera_moving"])
        return out

    return step


@pytest.mark.parametrize("fault", [state_unchanged, ema_off, rng_ahead, stale_outputs, altered,
                                   motion_lost])
def test_planted_faults_are_not_correct(tiny, capsys, fault):
    assert run(tiny, capsys, wrap=fault)["correct"] is False


def test_the_controls_are_not_correct(tiny):
    out = control.stateful_readings(tiny, CELL, SEED, torch.device("cpu"), frames=6)
    assert out["program"]["correct"] is True
    # TF32 exists on a card alone: on the CPU that control is the reference
    # itself (test_bench_cuda holds it on the card)
    assert out["tf32"]["correct"] is True and out["tf32"]["gaps"]["fused"] == 0.0
    for name in set(control.STATEFUL_CONTROLS) - {"tf32"}:
        assert out[name]["correct"] is False, (name, out[name])


def test_a_stateless_sink_keeps_frames_as_before():
    """Without a snapshot a sink's tokens carry no state, and the frames it
    keeps are the reservoir sample the sink kept before it could hold
    states (the same draws from the same generator)."""
    sink = window.Sink(lambda r: (r,), 3, np.random.default_rng(5), torch.device("cpu"))
    assert sink.start is None
    rng, kept, seen = np.random.default_rng(5), [], 0
    for k in range(40):
        token = sink.put(torch.full((2,), float(k)))
        assert token[2] is None
        sink.done(k, token)
        seen += 1
        if len(kept) < 3:
            kept.append(k)
            continue
        j = int(rng.integers(0, seen))
        if j < 3:
            kept.remove(sorted(kept)[j])
            kept.append(k)
    assert sorted(sink.outputs_kept()) == sorted(kept) and sink.states_kept() == {}
    assert all(v[0][0] == k for k, v in sink.outputs_kept().items())


def test_a_stateful_sink_pairs_each_kept_frame_with_its_states():
    count = [0]

    def snapshot():
        count[0] += 1
        return {"n": count[0]}

    sink = window.Sink(lambda r: (r,), 2, np.random.default_rng(1), torch.device("cpu"),
                       snapshot=snapshot)
    assert sink.start == {"n": 1}
    for k in range(10):
        sink.done(k, sink.put(torch.zeros(1)))
    for k, (before, after) in sink.states_kept().items():
        assert (before["n"], after["n"]) == (k + 1, k + 2)
    assert sorted(sink.states_kept()) == sorted(sink.outputs_kept())


def test_the_network_count_matches_the_flop_counter(tiny):
    from torch.utils.flop_counter import FlopCounterMode

    _, _, _, _, ref = parts(tiny)
    with FlopCounterMode(display=False) as counter:
        ref.net(torch.rand(256, 256, 3))
    assert fused_work.net_flops((256, 256)) == pytest.approx(counter.get_total_flops(), rel=0.02)


def test_the_fused_stages_at_the_cells_size():
    from benchmark.catalog import Catalog

    config = Catalog().config("fused")
    assert fused_work.processing_size(config) == (422, 236) == tuple(
        config["fused"]["processing_size"])
    by = {s.name: s for s in fused_work.stages(config)}
    # the coarse search at 118 x 211 over max(16, ceil(96 / 2)) = 48 disparities, four paths
    assert by["coarse cost"].bytes == 118 * 211 * 6 + 118 * 211 * 48
    # the refine window at 236 x 422, R = 32, two paths (2 x 120 = 240: a one-byte sum)
    assert by["refine aggregate"].bytes == 236 * 422 * 32 * 2


def test_the_ring_walks_forth_and_back():
    from benchmark.catalog import Catalog

    cat = Catalog()
    config, traffic = cat.config("fused"), cat.traffic("fused-live")
    traffic = dict(traffic, scene=dict(traffic["scene"], ring_frames=8))
    ring = cat.module("generators", "scene_pingpong").inputs(config, traffic, SEED,
                                                              torch.device("cpu"))
    assert len(ring) == 8
    order = [0, 1, 2, 3, 4, 3, 2, 1]  # the scene's frames: forth to the middle, back
    forth = ring[:5]
    for j, k in enumerate(order):
        assert all(np.array_equal(a, b) for a, b in zip(ring[j], forth[k]))
    pan = traffic["scene"]["pan_px_per_frame"]
    # frame 1 shows frame 0 moved right by the pan
    assert np.array_equal(ring[1][0][:, pan:], ring[0][0][:, :-pan])
    for j in range(8):  # no frame repeats the one before it, round the ring too
        assert not np.array_equal(ring[j][0], ring[(j + 1) % 8][0])


def test_the_fused_readers():
    from benchmark.catalog import Catalog

    cat = Catalog()
    spans = {"call": {"calls": 10, "device_s": 0.2}, "sgm.replay": {"calls": 10,
                                                                    "device_s": 0.05},
             "mono.net": {"calls": 10, "device_s": 0.03}}
    ctx = harness.Context({"name": "fused-live"}, cat.config("fused"), {}, 40.0, 1.0, 0.0, [],
                          {"spans": spans, "service_s": 0.5, "service_busy_s": 0.3,
                           "frames": 10})
    assert cat.reader("stereo_device_ms.fused")(ctx) == pytest.approx(5.0)
    assert cat.reader("other_device_ms.fused")(ctx) == pytest.approx(12.0)
    assert cat.reader("net_device_ms.fused")(ctx) == pytest.approx(3.0)
    assert cat.reader("idle_share.fused")(ctx) == pytest.approx(40.0)
    want = 100.0 * fused_work.ops(cat.config("fused")) * 10 / (0.5 * 67e12)
    assert cat.reader("mfu.fused")(ctx) == pytest.approx(want)
    assert cat.reader("mfu.mono") is not cat.reader("mfu.fused")
    empty = dataclasses.replace(ctx, trace={"spans": {"call": {"calls": 10, "device_s": 0.2}}})
    assert cat.reader("stereo_device_ms.fused")(empty) is None
    assert cat.reader("other_device_ms.fused")(empty) is None
