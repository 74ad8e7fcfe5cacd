"""Input-consistency validators (reference 2camers.py:1280-1365 and the
frame-corruption guards fused_depth_map.py:2466-2476).

The port's own copy of ``stereovision_tpu/io/validate.py`` (numpy, with
``imageio`` imported where an image is read)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def verify_image_sizes(directory: str | Path, glob: str = "*.jpg"):
    """All images must share one size (2camers.py:1280-1308).

    Returns (ok, reference_size, mismatches:[(name, size)]).
    """
    import imageio.v2 as iio

    files = sorted(Path(directory).glob(glob))
    ref = None
    bad = []
    for p in files:
        img = np.asarray(iio.imread(p))
        size = (img.shape[1], img.shape[0])
        if ref is None:
            ref = size
        elif size != ref:
            bad.append((p.name, size))
    return (len(bad) == 0, ref, bad)


def verify_stereo_images(directory: str | Path):
    """Every left image must have a right twin of the same size
    (2camers.py:1310-1365). Returns (ok, n_pairs, problems:[str])."""
    import imageio.v2 as iio

    d = Path(directory)
    problems = []
    n = 0
    for lp in sorted(d.glob("left_*")):
        rp = lp.with_name("right_" + lp.name[len("left_"):])
        if not rp.exists():
            problems.append(f"missing twin for {lp.name}")
            continue
        li = np.asarray(iio.imread(lp))
        ri = np.asarray(iio.imread(rp))
        if li.shape[:2] != ri.shape[:2]:
            problems.append(f"size mismatch {lp.name}: {li.shape[:2]} vs {ri.shape[:2]}")
            continue
        n += 1
    return (len(problems) == 0, n, problems)


def frame_ok(frame: np.ndarray | None, min_std: float = 1.0) -> bool:
    """Corruption guard: reject empty/flat frames (fused_depth_map.py:2466-2476)."""
    if frame is None or frame.size == 0:
        return False
    return float(np.std(frame)) >= min_std
