"""The rest of the port's calibration against the JAX package on the CPU,
in float64: ``calibrate_camera`` on the reference calibration tests'
projected views of a distorted camera (``tests/test_calib.py``, 1280x720)
within 1e-9 relative of the reference's and its tests' bounds of the
truth; on four pairs of the rendered rig (``tests/_calib_rig.py``),
``reprojection_rms`` within 1e-9 relative;
``rectification_epipolar_error`` within 1e-9 relative on the same
detections; the damping schedule when ``solve_ex`` fails; the flags'
masks; the card by default.
"""

import numpy as np
import pytest
import torch

import test_apps as ref_apps
import test_calib as ref_calib
from _calib_rig import detected_rig
from _fused_rig import few_threads  # noqa: F401 (a fixture)
from test_torch_calib_ba import KEYS_MONO, RTOL, _assert_same, _rel
from stereovision_tpu.calib import CalibrationFlags as JFlags
from stereovision_tpu.calib import ba as jba
from stereovision_tpu.calib.verify import rectification_epipolar_error as j_epi
from stereovision_tpu_torch.calib import CalibrationFlags, ba, detect_chessboard
from stereovision_tpu_torch.calib.verify import rectification_epipolar_error
from stereovision_tpu_torch.core import geometry as geom

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def rig():
    return detected_rig(n_pairs=4)


def test_calibrate_camera_on_the_reference_tests_views():
    """``tests/test_calib.py``'s projected views of a distorted camera at
    1280x720, noise 0.05 px, within the reference tests' bounds."""
    T = ref_calib.TestStereoCalibration()
    T.setup_method()
    obj, imL, _ = T.views(noise=0.05, n=12)
    want = jba.calibrate_camera(obj, imL, T.size)
    got = ba.calibrate_camera(obj, imL, T.size, device="cpu")
    _assert_same(got, want, KEYS_MONO)
    assert got["reprojection_error"] < 0.1
    np.testing.assert_allclose(got["camera_matrix"], T.K1, rtol=2e-3)


def test_reprojection_rms(rig):
    obj, cl, _, _, _ = rig
    cal = ba.calibrate_camera(obj, cl, (ref_apps.W, ref_apps.H), device="cpu")
    args = (obj, cl, cal["camera_matrix"], cal["distortion_coefficients"],
            cal["rotation_vectors"], cal["translation_vectors"])
    pv, overall = ba.reprojection_rms(*args, device="cpu")
    pv_ref, overall_ref = jba.reprojection_rms(*args)
    assert _rel(pv, pv_ref) < RTOL and abs(overall - overall_ref) <= RTOL * overall_ref
    assert abs(overall - cal["reprojection_error"]) < 1e-9


def test_rectification_epipolar_error(rig, monkeypatch):
    """Both functions detect with the port's detector (whose parity is
    ``tests/test_torch_calib_board.py``'s; the reference's eager detector
    recompiles for every image), so the comparison holds the undistortion
    and the rectification to float64 rounding."""
    from stereovision_tpu.calib import board as jboard

    monkeypatch.setattr(jboard, "detect_chessboard",
                        lambda img, pattern: detect_chessboard(img, pattern, device="cpu"))
    obj, cl, cr, _, images = rig
    size = (ref_apps.W, ref_apps.H)
    cal = ba.stereo_calibrate(obj, cl, cr, size, flags=CalibrationFlags.UNIVERSAL, device="cpu")
    R1, R2, P1, P2, Q = geom.stereo_rectify(
        torch.from_numpy(cal["mtx_left"]), torch.from_numpy(cal["dist_left"].ravel()),
        torch.from_numpy(cal["mtx_right"]), torch.from_numpy(cal["dist_right"].ravel()), size,
        torch.from_numpy(cal["R"]), torch.from_numpy(cal["T"].ravel()), alpha=0.0)
    cal.update(R1=R1.numpy(), R2=R2.numpy(), P1=P1.numpy(), P2=P2.numpy())
    got = rectification_epipolar_error(cal, images, ref_apps.BOARD, device="cpu")
    want = j_epi(cal, images, ref_apps.BOARD)
    assert got["n_pairs"] == want["n_pairs"] == 4
    for k in ("mean_abs_dy", "max_abs_dy", "mean_disparity"):
        assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), k
    assert got["mean_abs_dy"] < 0.3 and got["mean_disparity"] > 0
    assert rectification_epipolar_error(cal, [(np.zeros((60, 80)),) * 2], ref_apps.BOARD,
                                        device="cpu") == {"n_pairs": 0}


def test_lm_counts_a_failed_solve_as_a_rejected_step(monkeypatch):
    """``solve_ex``'s nonzero info counts as the reference's non-finite cost:
    λ grows tenfold and the solve is tried again."""
    A = torch.tensor([[2.0, 1.0], [1.0, 3.0], [0.5, -1.0]], dtype=torch.float64)
    b = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
    real, calls = torch.linalg.solve_ex, []

    def failing(M, g):
        calls.append(M)
        x, info = real(M, g)
        return x, torch.ones_like(info) if len(calls) <= 2 else info

    monkeypatch.setattr(torch.linalg, "solve_ex", failing)
    trace = []
    theta, cost = ba._lm(lambda t: A @ t - b, torch.zeros(2, dtype=torch.float64),
                         np.ones(2), trace=trace)
    assert trace[0] == 3  # two failed solves, then an accepted one
    lam_ratio = (calls[1] - calls[0]).diagonal() / (calls[0] - A.T @ A).diagonal()
    assert torch.allclose(lam_ratio, torch.full((2,), 9.0, dtype=torch.float64))
    x_ls = torch.linalg.lstsq(A, b).solution
    assert torch.allclose(theta, x_ls, atol=1e-8)
    assert abs(cost - float(((A @ x_ls - b) ** 2).sum())) < 1e-12


def test_flags_and_their_masks():
    assert CalibrationFlags.UNIVERSAL == CalibrationFlags(
        fix_aspect_ratio=True, same_focal_length=True, zero_tangent_dist=True,
        fix_k=(False, False, True))
    for flags in (CalibrationFlags(), CalibrationFlags(fix_intrinsic=True),
                  CalibrationFlags.UNIVERSAL, CalibrationFlags(fix_principal_point=True)):
        jflags = JFlags(**{f: getattr(flags, f) for f in (
            "fix_intrinsic", "fix_aspect_ratio", "same_focal_length", "fix_principal_point",
            "zero_tangent_dist", "fix_k")})
        np.testing.assert_array_equal(ba._intrinsics_mask(flags), jba._intrinsics_mask(jflags))


def test_calibration_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    obj = ref_calib.board_points()
    img = np.zeros((3, 54, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ba.calibrate_camera(obj, img, (640, 480))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ba.stereo_calibrate(obj, img, img, (640, 480))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ba.reprojection_rms(obj, img, np.eye(3), np.zeros(5), np.zeros((3, 3)), np.ones((3, 3)))
