"""The port's ``FusedPipeline.stream`` against its per-frame form and the
JAX package's pipeline.

``stream`` in two chunks equals the port's per-frame form exactly (the same
operations; the flow state carries across chunks) and the reference's
per-frame form within the per-frame tolerances (``_fused_rig``); a uint8
chunk (cast on the device) equals the float32 chunk of the same values
exactly. The on-device hysteresis is ``tests/test_torch_fused_hysteresis.py``.
"""

import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.pipeline import FusedPipeline as JFused
from stereovision_tpu_torch.fusion import OCCLUSION_CODES
from stereovision_tpu_torch.mono import ego
from stereovision_tpu_torch.pipeline import FusedPipeline

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import (assert_frame_close, reference_model, ReferenceDraws,
                        rig_calibration, stereo_pair)

pytestmark = pytest.mark.usefixtures("few_threads")

RNG = np.random.default_rng(82)


@pytest.fixture
def make(monkeypatch):
    monkeypatch.setattr(jnn, "create_model", reference_model)
    monkeypatch.setattr(ego, "draw_hypotheses", ReferenceDraws())
    cal = rig_calibration()

    def build(reference=False, **kw):
        return (JFused(cal, scale=0.75, **kw) if reference
                else FusedPipeline(cal, scale=0.75, device="cpu", **kw))

    return build


def _frames(n=5):
    left, right = stereo_pair(RNG)
    return (np.stack([np.roll(left, k, 1) for k in range(n)]),
            np.stack([np.roll(right, k, 1) for k in range(n)]))


def _stacked(outs):
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def test_stream_matches_per_frame(make):
    lefts, rights = _frames()
    n = len(lefts)
    per_frame, ref = make(), make(reference=True)
    pf = [per_frame(lefts[k], rights[k], t_now=float(np.float32(k / 30.0))) for k in range(n)]
    want = [ref(lefts[k], rights[k], t_now=k / 30.0) for k in range(n)]
    st = make()
    outs = _stacked([st.stream(lefts[:3], rights[:3], t0=0.0, dt=1 / 30.0),
                     st.stream(lefts[3:], rights[3:], t0=3 / 30.0, dt=1 / 30.0)])
    assert outs["fused"].shape == (n, 144, 192) and outs["occlusion_code"].dtype == torch.int32
    for k in range(n):
        for key in ("fused", "confidence", "meters", "mode", "camera_moving"):
            assert torch.equal(outs[key][k], pf[k][key]), (k, key)
        frame = {key: v[k] for key, v in outs.items()}
        frame["occlusion"] = OCCLUSION_CODES[int(frame["occlusion_code"])]
        assert frame["occlusion"] == "none"
        assert_frame_close(frame, want[k], f"frame {k}")
    assert st._frame == per_frame._frame == n
    # uint8 chunks: the cast happens on the device
    u8, f32 = make(), make()
    a = u8.stream(lefts.astype(np.uint8), rights.astype(np.uint8))
    b = f32.stream(lefts.astype(np.uint8).astype(np.float32),
                   rights.astype(np.uint8).astype(np.float32))
    for key in a:
        assert torch.equal(a[key], b[key]), key
