"""The port's chessboard detector against the JAX package on the CPU (the
geometry and image pieces it and SfM add are in
``tests/test_torch_calib_core.py``).

``corner_response`` within 1e-5 relative of the response's range (eagerly
it is exact: each op rounds as the port's do). ``detect_chessboard``: the found flag equal and the
corners within 5e-4 px: the corners are float32 in both, the reference
runs its subpixel loop compiled, where its 529-term sums round in another
order, and 30 fixed-point steps end at float32's noise floor (the two
differ by 1.2e-4-3.1e-4 px at coordinates of 90-420), on the reference
tests' renders (``tests/test_calib.py``), the low-contrast fallback among
them. ``refine_corners_subpix`` on seeded corners within the same 5e-4 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_calib as ref_calib
from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.calib import board as jboard
from stereovision_tpu_torch.calib import board

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RNG = np.random.default_rng(13)
PATTERN = (ref_calib.BOARD_W, ref_calib.BOARD_H)


def _close_corners(got, want):
    """Within 5e-4 px: float32's noise floor of the 30-step refinement."""
    return bool(np.abs(got - want).max() <= 5e-4)


def _render(Hmat):
    # the reference test's own renderer (cv2.warpPerspective + blur)
    return ref_calib.TestBoardDetection._render_board(None, Hmat)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

RENDERS = {
    "mild": np.array([[0.9, 0.05, 80], [-0.04, 0.92, 60], [1e-5, 2e-5, 1.0]]),
    "upright": np.array([[1.0, 0.0, 60.0], [0.0, 1.0, 50.0], [0.0, 0.0, 1.0]]),
    "tilted": np.array([[0.55, 0.18, 110.0], [-0.12, 0.62, 90.0], [4e-4, 3e-4, 1.0]]),
}


def test_corner_response():
    img = _render(RENDERS["mild"]).astype(np.float32)
    want = np.asarray(jboard.corner_response(jnp.asarray(img)))
    got = board.corner_response(torch.from_numpy(img)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_detect_chessboard(name):
    img = _render(RENDERS[name])
    f_ref, c_ref = jboard.detect_chessboard(img, PATTERN)
    found, corners = board.detect_chessboard(img, PATTERN, device="cpu")
    assert found == f_ref and found
    assert corners.dtype == np.float64 and corners.shape == (54, 2)
    assert _close_corners(corners, c_ref), np.abs(corners - c_ref).max()


def test_detect_chessboard_rejects_a_featureless_image():
    img = np.full((480, 640), 127, np.uint8)  # the renders' size: the reference's ops compiled
    assert jboard.detect_chessboard(img, PATTERN) == (False, None)
    assert board.detect_chessboard(img, PATTERN, device="cpu") == (False, None)


def test_detect_chessboard_low_contrast_fallback():
    """The reference test's dim, vignetted board under a lighting gradient
    (``tests/test_calib.py:207``): the plain pass fails in both, the retry
    on the locally normalized image finds the same corners."""
    rng = np.random.default_rng(9)
    base = _render(RENDERS["mild"]).astype(np.float32)
    yy, xx = np.mgrid[0:base.shape[0], 0:base.shape[1]].astype(np.float32)
    cx, cy = base.shape[1] / 2, base.shape[0] / 2
    vign = 1.0 - 0.4 * (((xx - cx) / cx) ** 2 + ((yy - cy) / cy) ** 2)
    noise = rng.normal(0, 0.6, base.shape)

    def degrade(gr):
        img = (22.0 + base / 255.0 * 8.0) * vign * (1.0 + gr * xx / base.shape[1])
        return np.clip(img + noise, 0, 255)

    def plain_pass(mod, img, to):
        resp = np.asarray(mod.corner_response(to(img)))
        cands = mod._ring_filter(img, mod._nms_candidates(resp, 54 + 16))
        return len(cands) >= 54 and mod._order_grid(cands, PATTERN) is not None

    img = next(degrade(g) for g in (3.0, 4.0, 5.0, 6.0, 8.0, 12.0)
               if not plain_pass(jboard, degrade(g), jnp.asarray))
    assert not plain_pass(board, img.astype(np.float32), torch.from_numpy)
    img = img.astype(np.uint8)
    f_ref, c_ref = jboard.detect_chessboard(img, PATTERN)
    found, corners = board.detect_chessboard(img, PATTERN, device="cpu")
    assert found and f_ref
    assert _close_corners(corners, c_ref), np.abs(corners - c_ref).max()


def test_refine_corners_subpix_on_seeded_corners():
    img = _render(RENDERS["upright"]).astype(np.float32)
    _, exact = jboard.detect_chessboard(img, PATTERN)
    seeds = (exact + RNG.uniform(-2.5, 2.5, exact.shape)).astype(np.float32)
    want = np.asarray(jboard.refine_corners_subpix(jnp.asarray(img), jnp.asarray(seeds)))
    got = board.refine_corners_subpix(torch.from_numpy(img), torch.from_numpy(seeds)).numpy()
    assert _close_corners(got, want), np.abs(got - want).max()
    assert np.abs(got - exact).max() < 0.05  # the seeds pulled back onto the corners


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        board.detect_chessboard(np.zeros((40, 40), np.uint8), PATTERN)
