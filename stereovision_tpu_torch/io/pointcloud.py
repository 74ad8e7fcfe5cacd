"""Point-cloud export: metric 3-D from the disparity engine to standard PLY.

Closes the loop on the rectification Q matrix that the reference stores in
every stereo calibration but never consumes (stereo_calibration.py:276-297):
disparity → ``core.geometry.reproject_image_to_3d`` → a viewer-ready file.
The port's own copy of ``stereovision_tpu/io/pointcloud.py`` (numpy only;
give it host arrays).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
{color_props}end_header
"""
_COLOR_PROPS = "property uchar red\nproperty uchar green\nproperty uchar blue\n"


def write_ply(path, points, colors=None, valid=None) -> int:
    """Write (…, 3) float points to a binary little-endian PLY.

    ``colors``: optional (…, 3) uint8 or (…,) grayscale (replicated to RGB).
    ``valid``: optional boolean mask; invalid and non-finite points are
    dropped. Returns the number of vertices written.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    keep = np.isfinite(pts).all(axis=1)
    if valid is not None:
        keep &= np.asarray(valid, bool).reshape(-1)
    pts = pts[keep]
    cols = None
    if colors is not None:
        cols = np.asarray(colors)
        if cols.ndim == pts.ndim - 1 or cols.shape[-1] != 3:
            cols = np.repeat(cols.reshape(-1, 1), 3, axis=1)
        else:
            cols = cols.reshape(-1, 3)
        cols = np.clip(cols, 0, 255).astype(np.uint8)[keep]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_HEADER.format(
            n=len(pts), color_props=_COLOR_PROPS if cols is not None else ""
        ).encode())
        if cols is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            rec = np.zeros(len(pts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
    return len(pts)


def read_ply(path):
    """Minimal reader for files produced by :func:`write_ply` (round-trip
    validation; not a general PLY parser). Returns (points, colors|None)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        n = int(next(x.split()[-1] for x in lines if x.startswith("element vertex")))
        has_color = any("uchar red" in x for x in lines)
        if has_color:
            rec = np.frombuffer(
                f.read(), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(), dtype="<f4", count=n * 3).reshape(n, 3)
        return pts.copy(), None
