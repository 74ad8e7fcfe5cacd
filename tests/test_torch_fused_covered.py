"""The port's ``FusedPipeline`` per frame against the JAX package's: the
covered left camera of ``tests/test_pipeline.py``.

``FusedPipeline(rig_calibration, scale=0.75, use_midas=True)`` (192x144,
D=240, MidasSmall with the bundled weights, flow depth with the
reference's hypothesis draws), 14 frames with the left lens covered, then
14 uncovered: the hysteresis flips to "left" after its confirmation run
(the occlusion check runs every second frame, a frame late), stereo stops,
the mode goes to MiDaS or flow, and all of it comes back. ``mode``,
``occlusion`` and ``camera_moving`` exact, the hysteresis state each
frame; ``fused`` within 0.1 on the 0-255 scale, ``meters`` within rtol
1e-4 (``_fused_rig.assert_frame_close``).
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

RNG = np.random.default_rng(81)


@pytest.fixture
def pipelines(monkeypatch):
    """Builds (port, reference) pipeline pairs; the reference's model comes
    from ``_fused_rig.reference_model``, the port's hypotheses are the
    reference's."""
    monkeypatch.setattr(jnn, "create_model", reference_model)
    monkeypatch.setattr(ego, "draw_hypotheses", ReferenceDraws())
    cal = rig_calibration()

    def make(**kw):
        return FusedPipeline(cal, scale=0.75, device="cpu", **kw), JFused(cal, scale=0.75, **kw)

    return make


def test_covered_camera_matches(pipelines):
    """28 frames: 14 with the left lens covered, then 14 uncovered."""
    port, ref = pipelines(use_midas=True)
    left, right = sharp_pair(RNG)
    covered = np.full_like(left, 15.0)
    modes = []
    for k in range(28):
        pair = (covered if k < 14 else left, right)
        got, want = port(*pair, t_now=0.1 * k), ref(*pair, t_now=0.1 * k)
        assert_frame_close(got, want, f"frame {k}")
        assert port.hysteresis.state == ref.hysteresis.state, k
        modes.append((int(got["mode"]), got["occlusion"]))
        if k == 13:
            assert port.hysteresis.state == "left" and not port.hysteresis.stereo_enabled
            assert modes[-1][0] in (2, 3)
    assert port.hysteresis.state == "none" and modes[-1][0] == 1
    assert modes[0] == (1, "none")
