"""Motion-parallax mono-depth command line: sequential frames → flow and
ego-motion parallax depth, normalized to its 3/97 percentiles and shown
through the inverted TURBO colormap. The counterpart of
``stereovision_tpu.apps.mono_motion`` with its flags plus ``--device``.

    python -m stereovision_tpu_torch.apps.mono_motion --images frames/ --out mono_motion_out
"""

from __future__ import annotations

import argparse
import fnmatch
import sys
from pathlib import Path

from stereovision_tpu_torch.apps import require


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.mono_motion")
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="mono_motion_out")
    ap.add_argument("--glob", default="*.jpg")
    ap.add_argument("--fps", type=float, default=30.0, help="assumed timestamp spacing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    require("stereovision_tpu_torch.apps.mono_motion", "imageio", "matplotlib")

    import imageio.v2 as iio
    import torch

    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.io.frames import _imread_gray
    from stereovision_tpu_torch.mono import FlowDepthParams, flow_depth_init, flow_depth_step
    from stereovision_tpu_torch.utils.backend import resolve_device, upload

    dev = resolve_device(args.device)
    files = sorted(p for p in Path(args.images).iterdir() if fnmatch.fnmatch(p.name, args.glob))
    if not files:
        raise SystemExit(f"no frames matching {args.glob} in {args.images}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    state = flow_depth_init(_imread_gray(files[0]).shape, device=dev)
    params = FlowDepthParams()
    for i, p in enumerate(files):
        state, depth, has, moving = flow_depth_step(
            state, upload(_imread_gray(p), dev), i / args.fps, params, device=dev)
        has, moving = bool(has), bool(moving)  # the status line reads them: waits for the frame
        if has:
            norm = im.percentile_normalize(depth, 3.0, 97.0)
            vis = im.apply_colormap(((1.0 - norm) * 255.0).to(torch.uint8), "turbo", bgr=False)
            iio.imwrite(out_dir / f"motion_{i:04d}.png", vis.to(torch.uint8).cpu().numpy())
        print(f"{p.name}: {'MOVING' if moving else 'STATIC'}{'' if has else ' (no depth)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
