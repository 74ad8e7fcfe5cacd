"""Disparity evaluation CLI: the engine on benchmark pairs with ground
truth, and the standard metrics (EPE, bad-N, KITTI D1-all, coverage).

Counterpart of ``stereovision_tpu/apps/eval_disparity.py``, with its flags
plus ``--device`` (default ``cuda``). Middlebury 2014 scene directories
(im0.png / im1.png / disp0.pfm, the ground truth of the left view im0) and
left/right/ground-truth triples (PFM, or a PNG scaled by --gt-scale, 256
for KITTI's disp_occ):

    python -m stereovision_tpu_torch.apps.eval_disparity --scenes /data/middlebury/* \\
        --num-disparities 256 --mode hier
    python -m stereovision_tpu_torch.apps.eval_disparity \\
        --left L.png --right R.png --gt gt.pfm

Needs ``imageio`` (the pairs) and, for PNG ground truth, ``cv2``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_gray(path: Path) -> np.ndarray:
    from stereovision_tpu_torch.io.frames import imread_gray

    return imread_gray(path)


def _load_gt(path: Path, scale: float) -> np.ndarray:
    from stereovision_tpu_torch.stereo.eval import read_pfm

    if path.suffix.lower() == ".pfm":
        return read_pfm(str(path))
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    return raw.astype(np.float32) / scale


def _eval_one(left, right, gt, args):
    import dataclasses

    from stereovision_tpu_torch.stereo import SGMParams, compute_disparity, production_preset
    from stereovision_tpu_torch.stereo.eval import evaluate_disparity

    if args.mode == "prod":
        p = dataclasses.replace(production_preset(), num_disparities=args.num_disparities)
    else:
        p = SGMParams(num_disparities=args.num_disparities, mode=args.mode,
                      refine_range=args.refine_range)
    disp, valid = compute_disparity(left, right, p, device=args.device)
    return evaluate_disparity(disp.cpu().numpy(), gt, valid=valid.cpu().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.eval_disparity")
    ap.add_argument("--scenes", nargs="*", default=[],
                    help="Middlebury scene dirs (im0.png im1.png disp0.pfm)")
    ap.add_argument("--left")
    ap.add_argument("--right")
    ap.add_argument("--gt")
    ap.add_argument("--gt-scale", type=float, default=256.0,
                    help="divisor for integer PNG ground truth (KITTI: 256)")
    ap.add_argument("--num-disparities", type=int, default=256)
    ap.add_argument("--mode", choices=["full", "hier", "hier2", "prod"], default="hier")
    ap.add_argument("--refine-range", type=int, default=32,
                    help="hier refine window")
    ap.add_argument("--json", action="store_true", help="one JSON line per scene")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    triples = []
    for s in args.scenes:
        d = Path(s)
        triples.append((d.name, d / "im0.png", d / "im1.png", d / "disp0.pfm"))
    if args.left:
        triples.append(("pair", Path(args.left), Path(args.right), Path(args.gt)))
    if not triples:
        ap.error("give --scenes or --left/--right/--gt")

    from stereovision_tpu_torch.apps import require

    require("stereovision_tpu_torch.apps.eval_disparity", "imageio",
            *(("cv2",) if any(gp.suffix.lower() != ".pfm" for *_, gp in triples) else ()))
    from stereovision_tpu_torch.utils.backend import resolve_device

    resolve_device(args.device)
    agg = []
    for name, lp, rp, gp in triples:
        left, right = _load_gray(lp), _load_gray(rp)
        gt = _load_gt(gp, args.gt_scale)
        m = _eval_one(left, right, gt, args)
        agg.append(m)
        if args.json:
            print(json.dumps({"scene": name, **{k: round(v, 4) for k, v in m.items()}}))
        else:
            print(f"{name:>20}: " + "  ".join(f"{k}={v:.3f}" for k, v in m.items()))
    if len(agg) > 1 and not args.json:
        mean = {k: float(np.mean([m[k] for m in agg])) for k in agg[0]}
        print(f"{'MEAN':>20}: " + "  ".join(f"{k}={v:.3f}" for k, v in mean.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
