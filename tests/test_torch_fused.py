"""The port's ``FusedPipeline`` per frame against the JAX package's.

``FusedPipeline(rig_calibration, scale=0.75)`` (processed at 192x144,
D=240, the hierarchical engine, MidasSmall with the bundled weights, flow
depth with the reference's hypothesis draws) on the scenarios of
``tests/test_pipeline.py``: streaming fusion without MiDaS (the covered
left camera is ``tests/test_torch_fused_covered.py``). ``mode``,
``occlusion`` and ``camera_moving`` exact; ``fused`` within 0.1 on the
0-255 scale, ``meters`` within rtol 1e-4 (``_fused_rig.assert_frame_close``).
"""

import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.pipeline import FusedPipeline as JFused
from stereovision_tpu_torch.mono import ego
from stereovision_tpu_torch.pipeline import FusedPipeline

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import (assert_frame_close, reference_model, ReferenceDraws,
                        rig_calibration, stereo_pair)

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


def test_streaming_fusion_matches(pipelines):
    port, ref = pipelines(use_midas=False)
    assert port.proc == ref.proc == (192, 144) and port.sgm.num_disparities == 240
    left, right = stereo_pair(RNG)
    for k in range(3):
        args = (np.roll(left, k, 1), np.roll(right, k, 1))
        got, want = port(*args, t_now=0.1 * k), ref(*args, t_now=0.1 * k)
        assert_frame_close(got, want, f"frame {k}")
    assert int(got["mode"]) == 1 and bool(got["camera_moving"])
    f, m = got["fused"].numpy(), got["meters"].numpy()
    assert 0 < f.max() <= 255.0 and m.min() >= 0.05 and m.max() <= 30.0


def test_fused_pipeline_entry_points(tmp_path):
    import stereovision_tpu_torch as svt
    from stereovision_tpu_torch.io.store import CalibrationStore

    assert svt.FusedPipeline is FusedPipeline
    cal = rig_calibration()
    CalibrationStore(tmp_path).save("stereo_calibration_data", cal)
    pipe = FusedPipeline.from_store(tmp_path, scale=0.5, use_midas=False, use_flow=False,
                                    device="cpu")
    assert pipe.proc == (128, 96) and pipe.sgm.num_disparities == 160
    assert pipe.set_params(stereo_weight=0.5).stereo_weight == 0.5
    left, right = stereo_pair(RNG)
    out = pipe(left, right, t_now=0.0)
    assert int(out["mode"]) == 1 and not bool(out["camera_moving"])
    nothing = FusedPipeline(cal, scale=0.5, use_stereo=False, use_midas=False, use_flow=False,
                            device="cpu")
    assert nothing(left, right, t_now=0.0) is None
    with pytest.raises(ValueError, match="torch_state_dict loads the hub architectures"):
        FusedPipeline(cal, midas_checkpoint="hub.pt", device="cpu")  # the default arch "small"
    with pytest.raises(FileNotFoundError, match="hub.pt"):
        FusedPipeline(cal, midas_arch="midas_v21_small", midas_checkpoint="hub.pt", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FusedPipeline(cal, use_midas=False)
