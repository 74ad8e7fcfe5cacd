"""Disparity evaluation: standard stereo metrics + Middlebury PFM I/O.

The port's own copy of ``stereovision_tpu/stereo/eval.py`` (numpy only),
used by ``apps/eval_disparity.py`` on standard benchmark data (Middlebury
2014 / KITTI disparity conventions):

- ``epe``: mean absolute disparity error over evaluated pixels.
- ``bad``: fraction of evaluated pixels with error > a threshold
  (Middlebury "bad-2.0"; KITTI D1 uses >3 px AND >5% of truth).
- ``d1``: the KITTI D1-all outlier fraction.
- ``coverage``: fraction of ground-truth pixels the estimate marks valid
  (density — SGM with LR/speckle checks trades coverage for accuracy).

PFM is Middlebury's float disparity format (header ``Pf``, scale line whose
sign encodes endianness, rows bottom-up).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_pfm", "write_pfm", "evaluate_disparity"]


def read_pfm(path: str) -> np.ndarray:
    """Read a grayscale PFM file → float32 (H, W), NaN/inf preserved
    (Middlebury encodes unknown disparity as inf)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"Pf":
            raise ValueError(f"not a grayscale PFM file: header {header!r}")
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"bad PFM dims line: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().strip())
        data = np.frombuffer(
            f.read(w * h * 4), dtype="<f4" if scale < 0 else ">f4"
        ).astype(np.float32)
    return data.reshape(h, w)[::-1]  # PFM rows are bottom-up


def write_pfm(path: str, img: np.ndarray) -> None:
    """Write float32 (H, W) as little-endian grayscale PFM."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError("write_pfm expects (H, W)")
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little-endian
        f.write(img[::-1].astype("<f4").tobytes())


def evaluate_disparity(
    disp: np.ndarray,
    gt: np.ndarray,
    valid: np.ndarray | None = None,
    gt_valid: np.ndarray | None = None,
    bad_thresholds: tuple = (0.5, 1.0, 2.0, 4.0),
    count_invalid_as_error: bool = True,
) -> dict:
    """Standard disparity metrics of ``disp`` against ground truth ``gt``.

    - ``gt_valid`` defaults to finite, positive gt (Middlebury: unknown = inf;
      KITTI: unknown = 0).
    - ``valid`` is the estimator's own validity mask; pixels it rejects are
      counted as errors in bad-N/D1 when ``count_invalid_as_error`` (the
      Middlebury "all" protocol for sparse methods) and excluded from EPE
      (which is only meaningful over produced values).
    """
    disp = np.asarray(disp, np.float32)
    gt = np.asarray(gt, np.float32)
    if gt_valid is None:
        gt_valid = np.isfinite(gt) & (gt > 0)
    if valid is None:
        valid = np.isfinite(disp)
    both = gt_valid & valid
    err = np.abs(disp - gt)
    out = {
        "coverage": float(both.sum() / max(1, gt_valid.sum())),
        "epe": float(err[both].mean()) if both.any() else float("nan"),
    }
    denom = gt_valid if count_invalid_as_error else both
    for t in bad_thresholds:
        bad = (err > t) & both
        if count_invalid_as_error:
            bad = bad | (gt_valid & ~valid)
        out[f"bad{t:g}"] = float(bad.sum() / max(1, denom.sum()))
    d1 = ((err > 3.0) & (err > 0.05 * np.abs(gt))) & both
    if count_invalid_as_error:
        d1 = d1 | (gt_valid & ~valid)
    out["d1_all"] = float(d1.sum() / max(1, denom.sum()))
    return out
