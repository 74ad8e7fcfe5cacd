"""The port's calibration app against the reference app on the same
synthetic captures (``tests/test_apps.py``'s rig, 320x240 JPEG pairs;
ten, the reference's least for ``universal``), with ``--device cpu``.

``universal`` with ``--reference-pkl``: the saved store's arrays, the
reference pkl and the txt sidecars hold the same keys, files, shapes and
dtypes as the reference app's; the integer entries are equal and the
float entries within 1e-4 relative (the two detectors' corners differ in
their last float32 bits, ≤ 5e-4 px: ``tests/test_torch_calib_board.py``;
the solvers agree to 1e-13 on equal corners:
``tests/test_torch_calib_ba.py``), but the distortion coefficients, near
zero on this rig and correlated, which are held by their effect: the two
distortion fields within 1e-3 px over the image (the reference's own
calibration test compares fields, ``tests/test_calib.py``). The ``mono``
→ ``stereo`` flow is in ``tests/test_torch_calib_flow.py``.

The reference app's closing epipolar check only prints (it detects all
the boards again, ~20 s of the reference's eager detector on this
machine), and its ``rectification_check.png`` is not compared; in its
run here both are stubs, which leave every file compared as it was. The
port app runs both.
"""

import pickle

import imageio.v2 as iio
import numpy as np
import pytest
import torch

import test_apps as ref_apps
from _calib_rig import write_captures
from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.apps import calibrate as ref_cal_app
from stereovision_tpu_torch.apps import calibrate as cal_app
from stereovision_tpu_torch.io.store import CalibrationStore

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RTOL = 1e-4
SIDECARS = ("rotation_matrix.txt", "translation_vector.txt", "essential_matrix.txt",
            "fundamental_matrix.txt", "Q_matrix.txt")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    return write_captures(tmp_path_factory.mktemp("captures"))


def _field_px(dist, K):
    """A distortion's displacement (px) on a grid over the 320x240 image."""
    k1, k2, p1, p2, k3 = np.ravel(dist)[:5]
    x, y = np.meshgrid(np.linspace(-160, 160, 9) / K[0, 0], np.linspace(-120, 120, 7) / K[1, 1])
    r2 = x * x + y * y
    rad = k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    dx = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([dx * K[0, 0], dy * K[1, 1]])


def _close(got, want, what, K=None):
    got, want = np.asarray(got), np.asarray(want)
    if K is not None:  # distortion coefficients: by their field
        assert got.shape == want.shape and got.dtype == want.dtype, what
        assert np.abs(_field_px(got, K) - _field_px(want, K)).max() < 1e-3, what
        return
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.dtype.kind == "f":
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= RTOL * scale, (what, np.abs(got - want).max() / scale)
    else:
        assert got.tolist() == want.tolist(), what


@pytest.fixture(scope="module")
def universal_outputs(captures, tmp_path_factory):
    from stereovision_tpu.calib import verify as ref_verify

    images, _ = captures
    outs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_verify, "rectification_epipolar_error", lambda *a, **k: {"n_pairs": 0})
    mp.setattr(ref_cal_app, "_write_rectification_check", lambda *a, **k: None)
    for name, main, extra in (("ref", ref_cal_app.main, []),
                              ("port", cal_app.main, ["--device", "cpu"])):
        out = tmp_path_factory.mktemp(f"universal_{name}")
        rc = main(["universal", "--images", str(images), "--board", "9x6", "--square-cm",
                   str(ref_apps.SQ), "--out", str(out), "--reference-pkl", *extra])
        assert rc == 0
        outs[name] = out
    mp.undo()
    return outs


def test_universal_store_matches_the_reference_app(universal_outputs, captures):
    got = CalibrationStore(universal_outputs["port"]).load("stereo_calibration_data")
    want = CalibrationStore(universal_outputs["ref"]).load("stereo_calibration_data")
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k, want[f"mtx_{k[5:]}"] if k.startswith("dist_") else None)
    _, (K1, K2, R, T) = captures
    assert got["ret"] < 1.0
    assert abs(np.linalg.norm(got["T"]) / np.linalg.norm(T) - 1) < 0.05


def test_universal_pkl_and_sidecars_match_the_reference_app(universal_outputs):
    pkls = {}
    for name, out in universal_outputs.items():
        with open(out / "stereo_calibration_data.pkl", "rb") as f:
            pkls[name] = pickle.load(f)
    assert set(pkls["port"]) == set(pkls["ref"])
    ref = pkls["ref"]
    for k, v in ref.items():
        K = ref[f"mtx_{k[5:]}"] if k.startswith("dist_") else None
        _close(pkls["port"][k], v, f"pkl {k}", K)
    assert pkls["port"]["calibration_type"] == "universal_stereo"
    for name in SIDECARS:
        _close(np.loadtxt(universal_outputs["port"] / name),
               np.loadtxt(universal_outputs["ref"] / name), name)
    check = iio.imread(universal_outputs["port"] / "rectification_check.png")
    assert check.shape == (ref_apps.H, 2 * ref_apps.W, 3)
    assert (check[::50, :, 1] == 255).all() and (check[::50, :, 0] == 0).all()


def test_the_app_defaults_to_the_card(captures, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    images, _ = captures
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cal_app.main(["universal", "--images", str(images), "--out", str(tmp_path)])


def test_too_few_boards_stops(tmp_path):
    (tmp_path / "left_000.jpg").write_bytes(b"")
    iio.imwrite(tmp_path / "left_000.jpg", np.full((60, 80), 127, np.uint8))
    with pytest.raises(SystemExit, match="need >= 10 boards, found 0"):
        cal_app.main(["mono", "--images", str(tmp_path), "--side", "left", "--out",
                      str(tmp_path / "o"), "--device", "cpu"])
