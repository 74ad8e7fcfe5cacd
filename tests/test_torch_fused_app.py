"""The port's ``apps.fused`` against the JAX package's app.

Four PNG pairs (a textured scene panning 2 px a frame at an 8 px shift)
under an identity-rectified 256x192 calibration store, at ``--scale 0.5``
(128x96, D=160), all three methods, the port with ``--device cpu`` and
the reference's hypothesis draws: each frame's ``.npz`` holds ``mode`` and
``occlusion`` exact, ``fused`` within 0.1 on the 0-255 scale and
``meters`` within rtol 1e-4 beyond the fused difference's share
(``_fused_rig.assert_frame_close``), ``conf`` within 1e-6. Without its
packages the app stops at start naming them; without a card its default
device raises.
"""

import imageio.v2 as iio
import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu_torch.io.store import CalibrationStore
from stereovision_tpu_torch.mono import ego

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import (assert_frame_close, reference_model, ReferenceDraws,
                        rig_calibration, stereo_pair)

pytestmark = pytest.mark.usefixtures("few_threads")

N = 4


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_captures")
    rng = np.random.default_rng(9)
    left, right = stereo_pair(rng)
    for i in range(N):
        iio.imwrite(root / f"left_{i:03d}.png", np.roll(left, 2 * i, 1).astype(np.uint8))
        iio.imwrite(root / f"right_{i:03d}.png", np.roll(right, 2 * i, 1).astype(np.uint8))
    calib = root / "calib"
    CalibrationStore(calib).save("stereo_calibration_data", rig_calibration())
    return root, calib


def test_fused_app_matches_reference(captures, tmp_path, monkeypatch):
    from stereovision_tpu.apps import fused as jfused
    from stereovision_tpu_torch.apps import fused

    root, calib = captures
    monkeypatch.setattr(ego, "draw_hypotheses", ReferenceDraws())
    monkeypatch.setattr(jnn, "create_model", reference_model)
    flags = ["--calib", str(calib), "--images", str(root), "--scale", "0.5"]
    assert jfused.main(flags + ["--out", str(tmp_path / "ref")]) == 0
    assert fused.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    modes = []
    for i in range(N):
        ref, got = (np.load(tmp_path / d / f"fused_{i:04d}.npz") for d in ("ref", "port"))
        assert str(got["occlusion"]) == str(ref["occlusion"]) == "none"
        assert_frame_close({"fused": torch.from_numpy(got["fused"]),
                            "meters": torch.from_numpy(got["meters"]),
                            "mode": torch.tensor(int(got["mode"]))},
                           {"fused": ref["fused"], "meters": ref["meters"],
                            "mode": int(ref["mode"])}, f"frame {i}")
        np.testing.assert_allclose(got["conf"], ref["conf"], rtol=0, atol=1e-6)
        png = iio.imread(tmp_path / "port" / f"fused_{i:04d}.png")
        assert png.shape == (96, 128, 3) and png.dtype == np.uint8
        modes.append(int(got["mode"]))
    assert modes == [1] * N


@pytest.mark.parametrize("missing", ["imageio", "PIL"])
def test_fused_app_names_what_is_missing(captures, tmp_path, monkeypatch, missing):
    import importlib.util

    from stereovision_tpu_torch.apps import fused

    root, calib = captures
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else real(name, *a))
    with pytest.raises(ImportError, match=missing):
        fused.main(["--calib", str(calib), "--images", str(root), "--out", str(tmp_path),
                    "--device", "cpu"])


def test_fused_app_defaults_to_the_card(captures, tmp_path):
    from stereovision_tpu_torch.apps import fused

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    root, calib = captures
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.main(["--calib", str(calib), "--images", str(root), "--out", str(tmp_path),
                    "--no-midas"])


def test_logging_and_annotation():
    from stereovision_tpu.utils import annotate as jannotate
    from stereovision_tpu_torch.utils import StageTimer, annotate, get_logger

    timer = StageTimer(report_every=2, logger=get_logger("fused-app-test"))
    for _ in range(3):
        with timer.stage("a"):
            pass
        timer.frame_done(0.01)
    rep = timer.report()
    assert rep["frames"] == 3 and "a" in rep and rep["fps"] == 100.0
    img = np.zeros((40, 120, 3), np.uint8)
    np.testing.assert_array_equal(annotate.draw_text(img, ["x 1", "y"]),
                                  jannotate.draw_text(img, ["x 1", "y"]))
    np.testing.assert_array_equal(annotate.status_panel({"mode": 1}),
                                  jannotate.status_panel({"mode": 1}))
    np.testing.assert_array_equal(annotate.depth_legend(50, 8), jannotate.depth_legend(50, 8))
