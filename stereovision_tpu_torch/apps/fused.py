"""Fused-depth command line: occlusion detection with hysteresis → stereo +
neural + flow depth → range calibration → confidence-weighted fusion →
metric legend, with per-frame timing stats. A thin wrapper over
``pipeline.FusedPipeline``; the counterpart of ``stereovision_tpu.apps.fused``
with its flags plus ``--device``.

    python -m stereovision_tpu_torch.apps.fused --calib output --images captures_stereo \\
        --out fused_out --scale 0.33
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from stereovision_tpu_torch.apps import require


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.fused")
    ap.add_argument("--calib", default="output")
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="fused_out")
    ap.add_argument("--scale", type=float, default=0.33, help="processing scale")
    ap.add_argument("--no-stereo", action="store_true")
    ap.add_argument("--no-midas", action="store_true")
    ap.add_argument("--no-flow", action="store_true")
    ap.add_argument("--skip-frames", type=int, default=1, help="process every Nth frame")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    require("stereovision_tpu_torch.apps.fused", "imageio", "PIL", "matplotlib")

    import imageio.v2 as iio
    import torch

    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.fusion.fuse import mode_text
    from stereovision_tpu_torch.io.frames import PairedImageSource
    from stereovision_tpu_torch.pipeline import FusedPipeline
    from stereovision_tpu_torch.utils import StageTimer
    from stereovision_tpu_torch.utils.annotate import draw_text

    pipe = FusedPipeline.from_store(
        args.calib, scale=args.scale, use_stereo=not args.no_stereo,
        use_midas=not args.no_midas, use_flow=not args.no_flow, device=args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    timer = StageTimer(report_every=30)
    t_sim = 0.0
    n_out = 0
    for i, (left, right) in enumerate(PairedImageSource(args.images)):
        if i % args.skip_frames:
            continue
        t0 = time.perf_counter()
        t_sim += 0.033 * args.skip_frames
        with timer.stage("fused"):
            out = pipe(left, right, t_now=t_sim)
        timer.frame_done(time.perf_counter() - t0)
        if out is None:
            continue
        fused = out["fused"]
        mode = int(out["mode"])  # the display reads it: waits for the frame
        moving = bool(out["camera_moving"]) if not args.no_flow else False
        cmap = im.apply_colormap(fused.to(torch.uint8), "jet", bgr=False)
        annotated = draw_text(
            cmap.cpu().numpy().astype(np.uint8),
            [f"FUSED: {mode_text(mode, pipe.fusion_params, not args.no_midas, not args.no_flow)}",
             f"occlusion: {out['occlusion']}"
             + ("" if pipe.hysteresis.stereo_enabled else "  [stereo OFF]"),
             ("CAM MOVING" if moving else "STATIC") if not args.no_flow else ""])
        iio.imwrite(out_dir / f"fused_{i:04d}.png", annotated)
        np.savez(out_dir / f"fused_{i:04d}.npz", fused=fused.cpu().numpy(),
                 conf=out["confidence"].cpu().numpy(), meters=out["meters"].cpu().numpy(),
                 mode=mode, occlusion=out["occlusion"])
        n_out += 1
        print(f"frame {i}: occl={out['occlusion']} mode={mode} "
              f"{(time.perf_counter() - t0) * 1000:.0f} ms")
    print(json.dumps({"frames": n_out, **timer.report()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
