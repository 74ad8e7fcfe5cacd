"""Calibration verification: the reference's manual epipolar check image
(stereo_calibration.py:316-338, green scanlines) as a measured quantity.

Counterpart of ``stereovision_tpu/calib/verify.py``. After rectification,
corresponding chessboard corners must share a scanline; the mean |Δy| over
detected corner pairs is the rectification error in pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def rectification_epipolar_error(cal: dict, pairs, pattern, device="cuda") -> dict:
    """cal: stereo calibration dict (R1/R2/P1/P2 + intrinsics); pairs:
    iterable of (left_gray, right_gray); pattern: chessboard (w, h).

    Returns {n_pairs, mean_abs_dy, max_abs_dy, mean_disparity} ({n_pairs: 0}
    where no pair shows the board in both views)."""
    from stereovision_tpu_torch.calib.board import detect_chessboard
    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(device)

    def f64(key):
        return torch.as_tensor(np.asarray(cal[key], np.float64), device=dev)

    dys, disps = [], []
    for left, right in pairs:
        fl, cl = detect_chessboard(left, pattern, device=dev)
        fr, cr = detect_chessboard(right, pattern, device=dev)
        if not (fl and fr):
            continue
        ul = geom.undistort_points(torch.as_tensor(cl, device=dev), f64("mtx_left"),
                                   f64("dist_left").ravel(), R=f64("R1"), P=f64("P1"))
        ur = geom.undistort_points(torch.as_tensor(cr, device=dev), f64("mtx_right"),
                                   f64("dist_right").ravel(), R=f64("R2"), P=f64("P2"))
        d = (ul - ur).cpu().numpy()
        dys.append(d[:, 1])
        disps.append(d[:, 0])
    if not dys:
        return {"n_pairs": 0}
    dy = np.concatenate(dys)
    return {
        "n_pairs": len(dys),
        "mean_abs_dy": float(np.abs(dy).mean()),
        "max_abs_dy": float(np.abs(dy).max()),
        "mean_disparity": float(np.concatenate(disps).mean()),
    }
