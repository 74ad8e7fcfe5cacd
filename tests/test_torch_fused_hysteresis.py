"""The port's ``FusedPipeline.stream`` against the JAX package's: the
occlusion hysteresis on the device.

Eight frames with the left lens covered, then eight uncovered, each chunk
in one ``stream`` call against the reference's ``stream`` (192x144, D=240,
MidasSmall, flow depth with the reference's hypothesis draws): the int32
hysteresis updates every frame and flips to "left" after five, the mode
goes to MiDaS or flow and comes back; ``occlusion_code`` and ``mode``
exact, the state carried back to the host equal; ``fused`` within 0.1 on
the 0-255 scale, ``meters`` within rtol 1e-4 (``_fused_rig``).
"""

import numpy as np
import pytest

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.pipeline import FusedPipeline as JFused
from stereovision_tpu_torch.mono import ego
from stereovision_tpu_torch.pipeline import FusedPipeline

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import (assert_frame_close, reference_model, ReferenceDraws,
                        rig_calibration, sharp_pair)

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


def test_stream_hysteresis_on_device_matches(make):
    port, ref = make(use_midas=True), make(reference=True, use_midas=True)
    left, right = sharp_pair(RNG)
    covered = np.full_like(left, 15.0)
    n = 8  # the hysteresis updates every frame in the stream form; 5 confirm
    for chunk, lefts in enumerate((np.stack([covered] * n), np.stack([left] * n))):
        rights = np.stack([right] * n)
        got = port.stream(lefts, rights, t0=chunk * n / 30.0)
        want = ref.stream(lefts, rights, t0=chunk * n / 30.0)
        for k in range(n):
            assert_frame_close({key: v[k] for key, v in got.items()},
                               {key: np.asarray(v)[k] for key, v in want.items()},
                               f"chunk {chunk} frame {k}")
        assert port.hysteresis.state == ref.hysteresis.state
        assert (port.hysteresis._pending, port.hysteresis._count) == (
            ref.hysteresis._pending, ref.hysteresis._count)
        codes = got["occlusion_code"].tolist()
        if chunk == 0:
            assert codes[-1] == 1 and port.hysteresis.state == "left"
            assert int(got["mode"][-1]) in (2, 3) and int(got["mode"][0]) == 1
        else:
            assert port.hysteresis.state == "none" and int(got["mode"][-1]) == 1
