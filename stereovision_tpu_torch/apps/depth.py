"""Depth-map CLI: stereo calibration → rectified pairs → disparity → metric
depth → colormapped images (and optionally the arrays and point clouds).

Counterpart of ``stereovision_tpu/apps/depth.py``, with its flags plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions):

    python -m stereovision_tpu_torch.apps.depth --calib output \\
        --images captures_stereo --out depth_captures --min-depth 0.2 --max-depth 4.0

Needs ``imageio`` (the images written) and ``matplotlib`` (the colormaps).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.depth")
    ap.add_argument("--calib", default="output")
    src_g = ap.add_mutually_exclusive_group(required=True)
    src_g.add_argument("--images", help="directory of left_*/right_* pairs")
    src_g.add_argument("--videos", nargs=2, metavar=("LEFT", "RIGHT"),
                       help="left/right video files (decoded via imageio-ffmpeg or cv2)")
    ap.add_argument("--video-step", type=int, default=1,
                    help="with --videos: process every Nth frame")
    ap.add_argument("--out", default="depth_captures")
    ap.add_argument("--num-disparities", type=int, default=320)
    ap.add_argument("--mode", choices=["full", "hier", "hier2", "prod"], default="full",
                    help="hier = coarse-to-fine; hier2 = dual-window coarse-to-fine; "
                         "prod = the production_preset")
    ap.add_argument("--refine-range", type=int, default=32,
                    help="hier refine window")
    ap.add_argument("--min-depth", type=float, default=0.2, help="meters")
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--cmap", default="turbo", choices=["turbo", "jet"])
    ap.add_argument("--save-npz", action="store_true")
    ap.add_argument("--save-ply", action="store_true",
                    help="metric point cloud via the calibration Q matrix")
    ap.add_argument("--limit", type=int, default=0, help="process only the first N pairs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from stereovision_tpu_torch.apps import require

    require("stereovision_tpu_torch.apps.depth", "imageio", "matplotlib")
    import dataclasses

    import imageio.v2 as iio
    import torch

    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.io.frames import PairedImageSource, VideoSource
    from stereovision_tpu_torch.io.store import CalibrationStore
    from stereovision_tpu_torch.stereo import SGMParams, compute_disparity, production_preset
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(args.device)
    cal = CalibrationStore(args.calib).load("stereo_calibration_data")

    def f64(key):
        return torch.as_tensor(np.asarray(cal[key]), dtype=torch.float64, device=dev)

    size = tuple(int(v) for v in np.asarray(cal["img_size"]))
    mx1, my1 = geom.init_undistort_rectify_map(
        f64("mtx_left"), f64("dist_left").ravel(), f64("R1"), f64("P1"), size)
    mx2, my2 = geom.init_undistort_rectify_map(
        f64("mtx_right"), f64("dist_right").ravel(), f64("R2"), f64("P2"), size)
    focal = float(np.asarray(cal["P1"])[0, 0])
    baseline_m = abs(float(np.asarray(cal["T"]).ravel()[0])) / 100.0  # cm → m

    if args.mode == "prod":
        params = production_preset()
        if args.num_disparities != 320:
            params = dataclasses.replace(params, num_disparities=args.num_disparities)
    else:
        params = SGMParams(num_disparities=args.num_disparities, mode=args.mode,
                           refine_range=args.refine_range)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.videos:
        src = zip(VideoSource(args.videos[0], step=args.video_step),
                  VideoSource(args.videos[1], step=args.video_step))
    else:
        src = PairedImageSource(args.images)
    stats = []
    for i, (left, right) in enumerate(src):
        if args.limit and i >= args.limit:
            break
        t0 = time.perf_counter()
        lr = im.remap(torch.as_tensor(left, dtype=torch.float32, device=dev), mx1, my1)
        rr = im.remap(torch.as_tensor(right, dtype=torch.float32, device=dev), mx2, my2)
        disp, valid = compute_disparity(lr, rr, params, device=dev)
        depth = geom.disparity_to_depth(disp, focal, baseline_m)
        depth = depth.clamp(args.min_depth, args.max_depth)
        # valid where disp > min_disparity − 1, as the reference's mask
        depth = torch.where(valid, depth, 0.0)
        # near = warm: the colormap reads the inverted normalized depth
        norm = (depth - args.min_depth) / (args.max_depth - args.min_depth)
        vis_u8 = ((1.0 - norm) * 255.0).clamp(0, 255).to(torch.uint8)
        cmap = im.apply_colormap(vis_u8, args.cmap, bgr=False)
        cmap_np = cmap.cpu().numpy()  # waits for the device: the frame's time ends here
        dt = time.perf_counter() - t0
        stats.append(dt)
        iio.imwrite(out_dir / f"depth_{i:04d}.png", cmap_np.astype(np.uint8))
        if args.save_npz:
            np.savez(out_dir / f"depth_{i:04d}.npz", disparity=disp.cpu().numpy(),
                     depth=depth.cpu().numpy(), valid=valid.cpu().numpy())
        if args.save_ply:
            from stereovision_tpu_torch.io.pointcloud import write_ply

            # Q is built from the cm-unit calibration (T in cm): points in
            # cm, exported in meters
            pts = geom.reproject_image_to_3d(disp, f64("Q")) / 100.0
            n = write_ply(out_dir / f"depth_{i:04d}.ply", pts.cpu().numpy(),
                          colors=lr.clamp(0, 255).cpu().numpy(), valid=valid.cpu().numpy())
            print(f"  point cloud: {n} vertices")
        print(f"frame {i}: {dt * 1000:.1f} ms, valid {valid.float().mean().item():.0%}")
    if stats:
        print(json.dumps({"frames": len(stats),
                          "mean_ms": 1000 * float(np.mean(stats[1:] or stats))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
