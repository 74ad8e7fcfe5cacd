"""The port's Levenberg–Marquardt calibration against the JAX package on
the CPU, both in float64 (the reference's tests run with x64, as the
conftest sets).

``calibrate_camera`` and ``stereo_calibrate`` (``fix_intrinsic`` and
``UNIVERSAL``) on the same corners: K, dist, R, T, E, F and the RMS within
1e-9 relative of the reference's (measured: 1e-16-1e-13), and within the
reference app test's bounds of the truth. The corners are the port's
detections on twelve rendered stereo pairs (the reference app test's rig,
``tests/_calib_rig.py``), and ``stereo_calibrate`` also on the reference
calibration tests' projected views of a distorted rig. The mono
calibration on those views, ``reprojection_rms``, the rectification
check and the damping schedule are in ``tests/test_torch_calib_verify.py``.
"""

import numpy as np
import pytest

import test_apps as ref_apps
import test_calib as ref_calib
from _calib_rig import detected_rig
from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.calib import CalibrationFlags as JFlags
from stereovision_tpu.calib import ba as jba
from stereovision_tpu_torch.calib import CalibrationFlags, ba

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RTOL = 1e-9
KEYS_MONO = ("camera_matrix", "distortion_coefficients", "rotation_vectors",
             "translation_vectors", "reprojection_error")
KEYS_STEREO = ("ret", "R", "T", "E", "F", "mtx_left", "dist_left", "mtx_right", "dist_right",
               "num_valid_pairs")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _assert_same(got: dict, want: dict, keys):
    assert set(keys) <= set(got)
    for k in keys:
        assert np.shape(got[k]) == np.shape(want[k]), k
        assert _rel(got[k], want[k]) < RTOL, (k, _rel(got[k], want[k]))


def flags_of(jflags):
    return CalibrationFlags(**{f: getattr(jflags, f) for f in (
        "fix_intrinsic", "fix_aspect_ratio", "same_focal_length", "fix_principal_point",
        "zero_tangent_dist", "fix_k")})


@pytest.fixture(scope="module")
def rig():
    return detected_rig()


def test_calibrate_camera_on_detected_corners(rig):
    obj, cl, _, (K1, _, _, _), _ = rig
    want = jba.calibrate_camera(obj, cl, (ref_apps.W, ref_apps.H))
    got = ba.calibrate_camera(obj, cl, (ref_apps.W, ref_apps.H), device="cpu")
    _assert_same(got, want, KEYS_MONO)
    assert got["reprojection_error"] < 1.0
    np.testing.assert_allclose(got["camera_matrix"], K1, rtol=2e-2)


@pytest.mark.parametrize("mode", ["fix_intrinsic", "universal"])
def test_stereo_calibrate_on_detected_corners(rig, mode):
    obj, cl, cr, (K1, K2, R, T), _ = rig
    size = (ref_apps.W, ref_apps.H)
    if mode == "universal":
        jflags, kw = JFlags.UNIVERSAL, {}
    else:
        jflags = JFlags(fix_intrinsic=True)
        kw = dict(K1=K1, d1=np.zeros(5), K2=K2, d2=np.zeros(5))
    want = jba.stereo_calibrate(obj, cl, cr, size, flags=jflags, **kw)
    got = ba.stereo_calibrate(obj, cl, cr, size, flags=flags_of(jflags), device="cpu", **kw)
    _assert_same(got, want, KEYS_STEREO)
    # the reference app test's bounds of the truth (tests/test_apps.py)
    assert got["ret"] < 1.0
    assert abs(np.linalg.norm(got["T"]) / np.linalg.norm(T) - 1) < 0.05
    if mode == "universal":
        assert got["mtx_left"][0, 0] == got["mtx_right"][0, 0]
        assert np.all(got["dist_left"].ravel()[2:4] == 0)


def test_stereo_calibrate_on_the_reference_tests_views():
    """``tests/test_calib.py``'s projected views of a distorted rig at
    1280x720 (noise 0.05 px), intrinsics fixed, within the reference
    tests' bounds of the truth."""
    T = ref_calib.TestStereoCalibration()
    T.setup_method()
    obj, imL, imR = T.views(noise=0.05, n=12)
    want = jba.stereo_calibrate(obj, imL, imR, T.size, T.K1, T.d1, T.K2, T.d2)
    got = ba.stereo_calibrate(obj, imL, imR, T.size, T.K1, T.d1, T.K2, T.d2, device="cpu")
    _assert_same(got, want, KEYS_STEREO)
    np.testing.assert_allclose(got["R"], T.R, atol=1e-3)
    np.testing.assert_allclose(got["T"].ravel(), T.T, atol=0.02)
