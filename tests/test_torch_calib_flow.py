"""The port's calibration app through the reference user's flow on the
synthetic captures of ``tests/test_apps.py`` (ten pairs), with ``--device
cpu``: ``mono`` for each camera (with ``--dump-undistorted``), then
``stereo`` with those intrinsics fixed, against the truth (K within 2%,
RMS under 1 px, |T| within 5%: the reference app test's bounds)."""

import numpy as np
import pytest
import torch

import test_apps as ref_apps
from _calib_rig import write_captures
from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu_torch.apps import calibrate as cal_app
from stereovision_tpu_torch.io.store import CalibrationStore

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    return write_captures(tmp_path_factory.mktemp("captures"))


def test_mono_then_stereo_flow(captures, tmp_path):
    images, (K1, K2, R, T) = captures
    out = tmp_path / "out"
    for side in ("left", "right"):
        args = ["--device", "cpu", "mono", "--images", str(images), "--side", side, "--out",
                str(out), "--square-cm", str(ref_apps.SQ)]
        assert cal_app.main(args + (["--dump-undistorted"] if side == "left" else [])) == 0
    store = CalibrationStore(out)
    mono = store.load("calibration_data_left")
    assert mono["reprojection_error"] < 1.0
    np.testing.assert_allclose(mono["camera_matrix"], K1, rtol=2e-2)
    assert len(list((out / "undistorted").glob("undistorted_left_*.png"))) == 10
    assert cal_app.main(["stereo", "--images", str(images), "--out", str(out), "--square-cm",
                         str(ref_apps.SQ), "--device", "cpu"]) == 0
    cal = store.load("stereo_calibration_data")
    # fix_intrinsic: the mono results carried over unchanged
    np.testing.assert_array_equal(cal["mtx_left"], mono["camera_matrix"])
    assert cal["ret"] < 1.0
    assert abs(np.linalg.norm(cal["T"]) / np.linalg.norm(T) - 1) < 0.05
    assert (out / "rotation_matrix.txt").exists() and (out / "rectification_check.png").exists()
