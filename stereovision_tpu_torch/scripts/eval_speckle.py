"""The windowed speckle filter against the exact one on the four quality
scenes; the counterpart of ``scripts/eval_speckle.py``.

    python -m stereovision_tpu_torch.scripts.eval_speckle [--mode hier2] [--quick]
        [--device cuda]

The engine's speckle suppression is a windowed upper bound of
cv2.filterSpeckles (``stereo/sgm.py::_speckle_suppress``); the exact
connected-component semantics are the native flood fill of
``native/speckle.cpp``. For each scene (seed 42) this compares the engine
at ``reference_preset(mode)`` with the same engine at
``speckle_window_size=0`` followed by
``exact_speckle_postpass(..., impl="native")``: the share of pixels whose
validity the two disagree on (over-kill: the windowed filter removes what
the exact one keeps; under-kill: the reverse), the bad2 of each, and the
pixels each removed. Prints one JSON line per scene, then a table; where
the native library cannot be built, an error line and exit code 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from stereovision_tpu_torch.scripts.eval_quality import D_SEARCH, SCENES
from stereovision_tpu_torch.stereo.eval import evaluate_disparity
from stereovision_tpu_torch.stereo.sgm import (compute_disparity, exact_speckle_postpass,
                                               reference_preset)


def speckle_row(scene: str, left, right, gt, gt_valid, p_win, device="cuda") -> dict:
    """One scene's row: the engine at ``p_win`` (windowed filter) against
    the engine with the filter off and the native exact post-pass."""
    dw, vw = (t.cpu().numpy() for t in compute_disparity(left, right, p_win, device=device))
    p_off = dataclasses.replace(p_win, speckle_window_size=0)
    d0, v0 = (t.cpu().numpy() for t in compute_disparity(left, right, p_off, device=device))
    de, ve = (t.numpy() for t in exact_speckle_postpass(d0, p_win, impl="native"))
    over = v0 & ~vw & ve    # windowed killed, exact kept
    under = v0 & vw & ~ve   # windowed kept, exact killed
    mw = evaluate_disparity(dw, gt, valid=vw, gt_valid=gt_valid)
    me = evaluate_disparity(de, gt, valid=ve, gt_valid=gt_valid)
    # of the pixels only the exact filter removed, the share that were wrong
    # by more than 2 px: the speckles that slip through the windowed filter
    under_bad = (float((np.abs(dw - gt) > 2.0)[under & gt_valid].mean())
                 if (under & gt_valid).any() else 0.0)
    return {
        "scene": scene,
        "disagree_frac": round(float((over | under).mean()), 6),
        "overkill_frac": round(float(over.mean()), 6),
        "underkill_frac": round(float(under.mean()), 6),
        "underkill_bad2_frac": round(under_bad, 4),
        "bad2_windowed": round(mw["bad2"], 5),
        "bad2_exact": round(me["bad2"], 5),
        "exact_removed": int((v0 & ~ve).sum()),
        "windowed_removed": int((v0 & ~vw).sum()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="hier2")
    ap.add_argument("--quick", action="store_true", help="360x640, D=128")
    ap.add_argument("--device", default="cuda", help="the engine's device")
    args = ap.parse_args(argv)

    from stereovision_tpu_torch.ops import native

    if not native.available():
        print(json.dumps({"error": "native library unavailable"}))
        return 1
    H, W, D = (360, 640, 128) if args.quick else (720, 1280, D_SEARCH)
    p_win = reference_preset(mode=args.mode)
    rows = []
    for name, fn in SCENES.items():
        left, right, gt, gt_valid = fn(np.random.default_rng(42), H, W, D)
        rows.append(speckle_row(name, left, right, gt, gt_valid, p_win, args.device))
        print(json.dumps(rows[-1]), flush=True)

    keys = ["disagree_frac", "overkill_frac", "underkill_frac", "bad2_windowed", "bad2_exact"]
    print(f"\n{'scene':>7} " + " ".join(f"{k:>16}" for k in keys))
    for r in rows:
        print(f"{r['scene']:>7} " + " ".join(f"{r[k]:>16.6f}" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
