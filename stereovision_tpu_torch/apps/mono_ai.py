"""Neural mono-depth command line: per-frame MiDaS-class inference with the
near = warm TURBO view (the depth inverted before the colormap). The
counterpart of ``stereovision_tpu.apps.mono_ai`` with its flags plus
``--device``.

    python -m stereovision_tpu_torch.apps.mono_ai --images frames/ --out mono_ai_out \\
        [--arch small|midas_v21_small|dpt_large] [--checkpoint hub.pt] [--net-hw H W]

``--net-hw`` is the network's input size (256 256 by default, the
reference's); DPT-Large at the MiDaS hub's size for a 1280x720 frame is
``--arch dpt_large --net-hw 384 672``.
"""

from __future__ import annotations

import argparse
import fnmatch
import sys
from pathlib import Path

import numpy as np

from stereovision_tpu_torch.apps import require


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.mono_ai")
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", default="mono_ai_out")
    ap.add_argument("--glob", default="*.jpg")
    ap.add_argument("--arch", default="small",
                    choices=("small", "midas_v21_small", "dpt_large"))
    ap.add_argument("--checkpoint", default=None,
                    help="hub-format torch .pt state_dict for midas_v21_small/dpt_large")
    ap.add_argument("--net-hw", type=int, nargs=2, default=(256, 256), metavar=("H", "W"),
                    help="the network's input height and width (default 256 256)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    require("stereovision_tpu_torch.apps.mono_ai", "imageio", "matplotlib")

    import imageio.v2 as iio
    import torch

    from stereovision_tpu_torch.io.frames import _imread_bgr
    from stereovision_tpu_torch.mono import nn as mnn

    net_hw = tuple(args.net_hw)
    model = mnn.create_model(arch=args.arch, torch_state_dict=args.checkpoint, device=args.device,
                             net_hw=net_hw)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in Path(args.images).iterdir() if fnmatch.fnmatch(p.name, args.glob))
    for i, p in enumerate(files):
        vis = frame_view(model, _imread_bgr(p), args.device, net_hw)
        iio.imwrite(out_dir / f"depth_{i:04d}.png", vis.to(torch.uint8).cpu().numpy())
        print(f"{p.name} → depth_{i:04d}.png")
    return 0


def frame_view(model, frame_bgr: np.ndarray, device, net_hw=(256, 256)):
    """One frame's work: ``estimate_depth`` at ``net_hw``, then the inverted depth
    through the TURBO colormap, as RGB float32 (H, W, 3) on ``device``."""
    import torch

    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.mono.nn import estimate_depth

    depth, _ = estimate_depth(model, frame_bgr, net_hw=net_hw, device=device)
    return im.apply_colormap((255 - depth).to(torch.uint8), "turbo", bgr=False)


if __name__ == "__main__":
    sys.exit(main())
