"""The port's spans (``utils.profiling.annotate``): what a profiled
``DepthPipeline`` call writes into a trace, and, on a card, that every
wait of the host on the card inside a call lies in a ``sync.*`` span.

Without a profile ``annotate`` is one shared null context. A profiled call
at a small size on the CPU writes the pipeline's ``depth.*`` spans and the
engine's ``sgm.*`` spans of its mode (production at a height that takes the
stacked refine and one that does not, the full search, the full search with
the exact speckle filter): each ``sgm.*`` span lies inside ``depth.engine``,
no name opens inside itself, and the pipeline still calls the engine
through its module's name. ``StageTimer`` stages are ``fused.<stage>``
spans. The ``cuda`` tests (skipped without a card) trace 720p calls and
hold every synchronising CUDA runtime call to a ``sync.*`` span, and so do
720p calls of ``mono.nn.estimate_depth``:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_tracing.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import pipeline
from stereovision_tpu_torch.stereo import SGMParams, production_preset
from stereovision_tpu_torch.utils import StageTimer
from stereovision_tpu_torch.utils import profiling

PIPELINE = {"depth.upload", "depth.rectify", "depth.engine", "depth.metric"}
HIER2 = {"sgm.search", "sgm.coarse", "sgm.shifts", "sgm.census", "sgm.refine",
         "sgm.arbitrate", "sgm.speckle", "sgm.fill", "sgm.median"}
FULL = {"sgm.search", "sgm.speckle", "sgm.median"}
# runtime calls after which the host has waited for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def calibration(w, h, f=700.0, tx=-6.0):
    """An identity-rectified rig: focal length f px, baseline tx cm along x."""
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = P1.copy()
    P2[0, 3] = tx * f
    return {"mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5),
            "dist_right": np.zeros(5), "R": np.eye(3), "T": np.array([[tx], [0.0], [0.0]]),
            "R1": np.eye(3), "R2": np.eye(3), "P1": P1, "P2": P2,
            "img_size": np.array([w, h])}


def pair(h, w, shift, seed=5):
    """uint8 noise and the same noise seen shift px to the left."""
    base = np.random.default_rng(seed).integers(0, 256, (h, w + shift), dtype=np.uint8)
    return np.ascontiguousarray(base[:, shift:]), np.ascontiguousarray(base[:, :w])


def spans_of(events, prefixes=("depth.", "sgm.", "sync.")):
    """name → sorted [(start, end)] µs of the trace's annotations with one of
    the prefixes."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(prefixes):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def traced(tmp_path, fn):
    with profiling.trace(tmp_path):
        fn()
    return json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_annotate_without_a_profile_is_the_shared_null_context():
    assert profiling.annotate("depth.engine") is profiling.annotate("sgm.search")
    with profiling.annotate("depth.engine") as inside:
        assert inside is None
    with torch.profiler.profile():
        assert isinstance(profiling.annotate("depth.engine"),
                          torch.profiler.record_function)
    assert profiling.annotate("depth.engine") is profiling.annotate("sgm.search")


MODES = {
    "production-stacked": (48, 192, dataclasses.replace(production_preset(), num_disparities=64),
                           {}, PIPELINE | HIER2),
    "production-two-passes": (40, 192,
                              dataclasses.replace(production_preset(), num_disparities=64),
                              {}, PIPELINE | HIER2),
    "full": (48, 128, SGMParams(num_disparities=32), {}, PIPELINE | FULL),
    "full-exact-speckle": (48, 128, SGMParams(num_disparities=32), {"exact_speckle": True},
                           PIPELINE | {"sgm.search", "sgm.median", "depth.exact_speckle",
                                       "sync.speckle_round", "sync.exact_speckle"}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_a_profiled_call_writes_the_spans_of_its_mode(tmp_path, mode):
    h, w, params, kw, names = MODES[mode]
    pipe = pipeline.DepthPipeline(calibration(w, h), params, device="cpu", **kw)
    left, right = pair(h, w, 6)
    want = pipe(left, right)
    got = []
    events = traced(tmp_path, lambda: got.append(pipe(left, right)))
    for a, b in zip(dataclasses.astuple(want), dataclasses.astuple(got[0])):
        assert torch.equal(a, b)
    spans = spans_of(events)
    assert set(spans) == names
    assert not {e.get("name") for e in events} & {"frame", "call", "engine"}
    assert len(spans["depth.engine"]) == 1
    (e0, e1), = spans["depth.engine"]
    for name, ss in spans.items():
        if name.startswith("sgm."):
            assert all(e0 <= s and t <= e1 for s, t in ss), name
        # no name opens inside itself
        assert all(t <= s for (_, t), (s, _) in zip(ss, ss[1:])), name


def test_the_engine_is_called_through_the_pipelines_module(monkeypatch):
    """The benchmark's ``engine`` span wraps ``pipeline.disparity_with_confidence``."""
    h, w = 48, 128
    pipe = pipeline.DepthPipeline(calibration(w, h), SGMParams(num_disparities=32),
                                  device="cpu")
    inner, seen = pipeline.disparity_with_confidence, []

    def engine(*args, **kw):
        seen.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(pipeline, "disparity_with_confidence", engine)
    pipe(*pair(h, w, 6))
    assert seen == [(h, w)]


def test_stage_timer_stages_are_fused_spans(tmp_path):
    timer = StageTimer(report_every=100)

    def stages():
        for stage in ("stereo", "midas"):
            with timer.stage(stage):
                pass

    events = traced(tmp_path, stages)
    assert spans_of(events, ("fused.",)).keys() == {"fused.stereo", "fused.midas"}
    assert set(timer.report()) >= {"stereo", "midas"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def waits_outside_sync_spans(events):
    """The synchronising runtime calls (and copies from pageable memory) of
    the trace's ``call`` spans that lie in no ``sync.*`` span, and the count
    of ``sync.*`` spans in the calls."""
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "call"]
    syncs = [s for name, ss in spans_of(events, ("sync.",)).items() for s in ss]
    pageable = {e["args"]["correlation"] for e in events if e.get("cat") == "gpu_memcpy"
                and "Pageable" in e.get("name", "")}

    def inside(e, spans):
        return any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t in spans)

    waits = [e for e in events if e.get("cat") == "cuda_runtime" and inside(e, calls)
             and (e["name"] in SYNC_CALLS
                  or e.get("args", {}).get("correlation") in pageable)]
    return ([e["name"] for e in waits if not inside(e, syncs)],
            sum(1 for s in syncs if any(a <= s[0] and s[1] <= b for a, b in calls)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["production", "full", "full-exact-speckle"])
def test_every_wait_of_a_720p_call_is_a_sync_span(cuda, tmp_path, mode):
    h, w = 720, 1280
    params = production_preset() if mode == "production" else SGMParams(num_disparities=320)
    pipe = pipeline.DepthPipeline(calibration(w, h), params, device=cuda,
                                  exact_speckle=mode == "full-exact-speckle")
    left, right = pair(h, w, 40)
    inputs = {"numpy": (left, right),
              "pinned": tuple(torch.from_numpy(x).pin_memory() for x in (left, right)),
              "card": tuple(torch.from_numpy(x).to(cuda) for x in (left, right))}
    for args in inputs.values():  # builds the kernels and warms every shape
        pipe(*args)
    torch.cuda.synchronize()
    for kind, args in inputs.items():
        def one():
            with torch.profiler.record_function("call"):
                pipe(*args)
            torch.cuda.synchronize()

        loose, n_sync = waits_outside_sync_spans(traced(tmp_path / kind, one))
        assert loose == [], (kind, loose)
        uploads = 0 if kind == "card" else 2
        if mode == "full-exact-speckle":
            assert n_sync > uploads, kind  # a round of the labelling at least
        else:
            assert n_sync == uploads, kind


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["numpy", "card"])
def test_every_wait_of_a_720p_mono_depth_call_is_a_sync_span(cuda, tmp_path, source):
    """``mono.nn.estimate_depth`` on a 1280x720 BGR frame (a ``DPT_TINY``
    at 64x128): the host waits only for the upload of a frame in host
    memory, inside its ``sync.upload``."""
    from stereovision_tpu_torch.models import dpt
    from stereovision_tpu_torch.mono import nn as mnn

    model = mnn.create_model(arch="dpt_large", dpt_cfg=dpt.DPT_TINY, net_hw=(64, 128),
                             device=cuda)
    frame = np.random.default_rng(4).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    arg = frame if source == "numpy" else torch.from_numpy(frame).to(cuda)
    mnn.estimate_depth(model, arg, net_hw=(64, 128), device=cuda)  # warms every shape
    torch.cuda.synchronize()

    def one():
        with torch.profiler.record_function("call"):
            mnn.estimate_depth(model, arg, net_hw=(64, 128), device=cuda)
        torch.cuda.synchronize()

    loose, n_sync = waits_outside_sync_spans(traced(tmp_path, one))
    assert loose == [] and n_sync == (1 if source == "numpy" else 0)
