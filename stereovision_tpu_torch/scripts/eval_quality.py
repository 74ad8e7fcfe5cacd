"""Quality benchmark: the port's engine against the cv2.StereoSGBM recipe on
synthetic scenes with exact ground-truth disparity; the counterpart of
``scripts/eval_quality.py``.

    python -m stereovision_tpu_torch.scripts.eval_quality [--quick] [--modes hier,full]
        [--scenes boxes,slant,steps,gain] [--seeds 1] [--device cuda]

Both engines run the same 320-disparity search (the reference recipe
``depth_map.py:894-909`` for cv2; ``reference_preset`` or
``production_preset`` for the port) and are scored against ground truth
by :func:`stereo.eval.evaluate_disparity` (EPE over produced pixels; bad-N
and D1 with rejected pixels counted as errors, the Middlebury "all"
protocol). Prints one JSON line per (scene, engine), then a table.

Scenes (1280x720 and a 320-pixel search; ``--quick`` 640x360 and 128):

- ``boxes``: shaded, textured fronto-parallel boxes over a far background;
  occluded bands are left out of ``gt_valid``;
- ``slant``: a slanted surface (disparity linear in x and y), rendered by
  exact inverse warping: subpixel ground truth;
- ``steps``: a disparity staircase, a discontinuity every 160 columns;
- ``gain``: ``boxes`` with an exposure mismatch between the cameras.

The textures are blurred by :func:`gaussian_blur_5` (numpy), which stands
in for the reference's ``cv2.GaussianBlur(base, (5, 5), 1.2)``: the same
weights and border, summed in float64, so a texture differs from the
reference's by its float32 rounding only; ``gt`` and ``gt_valid`` do not
depend on the texture and are the reference's bit for bit. The search
range ``D`` is an argument of each scene (the reference keeps it in a
module global). The cv2 engine runs where ``cv2`` imports; elsewhere its
rows say ``"skipped"`` and score nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from stereovision_tpu_torch.stereo.eval import evaluate_disparity
from stereovision_tpu_torch.stereo.sgm import (compute_disparity, production_preset,
                                               reference_preset)

D_SEARCH = 320
# cv2.getGaussianKernel(5, 1.2): exp(-x² / (2·1.2²)) over x = -2..2, normalised
_G = np.exp(-np.arange(-2.0, 3.0) ** 2 / (2 * 1.2 ** 2))
GAUSS_5 = _G / _G.sum()


def gaussian_blur_5(img):
    """A separable 5-tap Gaussian (sigma 1.2) with cv2's default border
    (``BORDER_REFLECT_101``, numpy's ``"reflect"``), summed in float64:
    ``cv2.GaussianBlur(img, (5, 5), 1.2)`` up to cv2's float32 rounding."""
    x = np.pad(np.asarray(img, np.float64), 2, mode="reflect")
    h, w = x.shape[0] - 4, x.shape[1] - 4
    rows = sum(GAUSS_5[i] * x[i:i + h] for i in range(5))
    return sum(GAUSS_5[j] * rows[:, j:j + w] for j in range(5)).astype(np.float32)


def _texture(rng, h, w, lo=40.0, hi=210.0):
    base = rng.uniform(lo, hi, (h, w)).astype(np.float32)
    base = gaussian_blur_5(base)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base += 25 * np.sin(xx / 41.0) + 18 * np.cos(yy / 29.0)
    return base


def _render_layers(rng, layers, bg_d, H, W, D):
    """Exact layered stereo renderer. ``layers`` = [(y0, x0, h, w, d, tex)].
    Painter's algorithm far→near in both views with per-pixel surface ids;
    a left pixel's ground truth is valid iff the right view shows the same
    surface at its match point."""
    canvas = _texture(rng, H, W + D)
    # background at constant disparity bg_d: left[x] = canvas[x] matches
    # right[x − bg_d] = canvas[(x − bg_d) + bg_d]
    left = canvas[:, :W].copy()
    right = canvas[:, bg_d:bg_d + W].copy()
    lid = np.zeros((H, W), np.int32)
    rid = np.zeros((H, W), np.int32)
    gt = np.full((H, W), float(bg_d), np.float32)
    for i, (y0, x0, h, w, d, tex) in enumerate(sorted(layers, key=lambda t: t[4]), start=1):
        assert 0 <= x0 - d and x0 + w <= W and y0 + h <= H, (y0, x0, h, w, d)
        left[y0:y0 + h, x0:x0 + w] = tex
        lid[y0:y0 + h, x0:x0 + w] = i
        gt[y0:y0 + h, x0:x0 + w] = d
        right[y0:y0 + h, x0 - d:x0 - d + w] = tex
        rid[y0:y0 + h, x0 - d:x0 - d + w] = i
    xs = np.arange(W)[None, :]
    rows = np.broadcast_to(np.arange(H)[:, None], (H, W))
    xr = xs - gt.astype(np.int32)
    gt_valid = (xr >= 0) & (rid[rows, np.clip(xr, 0, W - 1)] == lid)
    gt_valid[:, :D] = False  # no in-image match guaranteed
    return left, right, gt, gt_valid


def scene_boxes(rng, H=720, W=1280, D=D_SEARCH):
    """Shaded fronto-parallel boxes over a far background."""
    bg_d = 24 * D // 320
    rel_boxes = [  # (y0, x0, h, w) as fractions; d as a fraction of D
        (0.08, 0.30, 0.30, 0.20, 0.20),
        (0.18, 0.48, 0.36, 0.23, 0.375),
        (0.60, 0.35, 0.28, 0.26, 0.56),
        (0.58, 0.64, 0.33, 0.25, 0.30),
        (0.06, 0.80, 0.21, 0.14, 0.47),
    ]
    layers = []
    for fy, fx, fh, fw, fd in rel_boxes:
        fy = fy + rng.uniform(-0.03, 0.03)
        fx = fx + rng.uniform(-0.03, 0.03)
        fd = float(np.clip(fd + rng.uniform(-0.08, 0.08), 0.12, 0.9))
        y0, x0, h, w = int(fy * H), int(fx * W), int(fh * H), int(fw * W)
        d = int(fd * D)
        x0 = max(x0, d)
        y0 = max(0, min(y0, H - h))
        tex = _texture(rng, h, w, 60, 230) * np.outer(
            np.linspace(1.0, 0.75, h), np.linspace(0.8, 1.1, w)).astype(np.float32)
        layers.append((y0, x0, h, w, d, tex))
    return _render_layers(rng, layers, bg_d, H, W, D)


def scene_slant(rng, H=720, W=1280, D=D_SEARCH):
    """Disparity plane d = a + b·x + c·y, rendered by exact inverse warp:
    right[y, xr] = left[y, (xr + a + c·y)/(1 − b)] (subpixel bilinear). ``D``
    is not used: the plane's range is fixed."""
    a, b, c = 40.0, 0.09, 0.04
    pad = 16
    Lw = W + pad
    left_full = _texture(rng, H, Lw)
    xr = np.arange(W, dtype=np.float32)[None, :]
    yy = np.arange(H, dtype=np.float32)[:, None]
    xs = (xr + a + c * yy) / (1.0 - b)  # left column sampled for right[y, xr]
    x0 = np.floor(xs).astype(np.int64)
    frac = (xs - x0).astype(np.float32)
    x0c = np.clip(x0, 0, Lw - 2)
    rows = np.broadcast_to(np.arange(H)[:, None], (H, W))
    right = (1 - frac) * left_full[rows, x0c] + frac * left_full[rows, x0c + 1]
    left = left_full[:, :W]
    gt = a + b * np.broadcast_to(xr, (H, W)) + c * yy
    gt_valid = (xr - gt >= 0) & (xs >= 0) & (xs <= Lw - 1)
    return left, right.astype(np.float32), gt.astype(np.float32), gt_valid


def scene_steps(rng, H=720, W=1280, D=D_SEARCH):
    """A disparity staircase along x (a discontinuity every W/8 columns; the
    farthest level doubles as the background)."""
    fracs = (0.09, 0.22, 0.34, 0.47, 0.59, 0.72, 0.59, 0.34)
    steps = [int(f * D) for f in fracs]
    bg_d = min(steps)
    seg = W // len(steps)
    layers = []
    for i, d in enumerate(steps):
        x0 = i * seg
        x1 = W if i == len(steps) - 1 else x0 + seg
        if d == bg_d:
            continue  # the background layer already covers it
        x0 = max(x0, d)  # keep the right-view footprint in-image
        layers.append((0, x0, H, x1 - x0, d, _texture(rng, H, x1 - x0)))
    return _render_layers(rng, layers, bg_d, H, W, D)


def scene_gain(rng, H=720, W=1280, D=D_SEARCH):
    """The boxes scene with an exposure mismatch between the cameras (right
    gain 1.25x, offset +12, mild vignette). Census is invariant to monotonic
    local intensity maps; SGBM's BT cost is not."""
    left, right, gt, gt_valid = scene_boxes(rng, H, W, D)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    vign = 1.0 - 0.15 * (((xx / W - 0.5) ** 2 + (yy / H - 0.5) ** 2) * 2.0)
    right = np.clip(right * 1.25 * vign + 12.0, 0, 255).astype(np.float32)
    return left, right, gt, gt_valid


SCENES = {"boxes": scene_boxes, "slant": scene_slant, "steps": scene_steps, "gain": scene_gain}


def cv2_or_none():
    """The ``cv2`` module, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def run_reference(left, right, D=D_SEARCH):
    """The reference's disparity path (``depth_map.py:894-912``): the SGBM
    recipe, /16, medianBlur 5; valid where disp > MIN_DISP (``:933``).
    Returns (disp, valid, seconds), or None where cv2 is not installed."""
    cv2 = cv2_or_none()
    if cv2 is None:
        return None
    sgbm = cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=D, blockSize=7,
        P1=8 * 3 * 49, P2=32 * 3 * 49, disp12MaxDiff=1, uniquenessRatio=10,
        speckleWindowSize=100, speckleRange=32, preFilterCap=63,
        mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY,
    )
    lu8 = np.clip(left, 0, 255).astype(np.uint8)
    ru8 = np.clip(right, 0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    disp = sgbm.compute(lu8, ru8).astype(np.float32) / 16.0
    disp = cv2.medianBlur(disp, 5)
    return disp, disp > 0, time.perf_counter() - t0


def params_for(mode: str):
    """A mode string of the reference's script → the engine's params:
    ``prod`` is ``production_preset()`` (``prod_cp4`` with four coarse
    paths, ``prod_csN`` at coarse scale N, ``prod_bfull`` without window B's
    decimation); any other is ``reference_preset(mode)``, where a suffix
    ``_rN`` sets the refine range to N and ``_rNpM`` also the paths to M."""
    if mode.startswith("prod"):
        p = production_preset()
        if mode == "prod_cp4":
            p = dataclasses.replace(p, coarse_paths=4)
        elif mode.startswith("prod_cs"):
            p = dataclasses.replace(p, coarse_scale=int(mode[7:]))
        elif mode == "prod_bfull":
            p = dataclasses.replace(p, b_decimate=1)
        return p
    refine = paths = None
    if "_r" in mode:
        mode, rr = mode.split("_r")
        if "p" in rr:
            rr, pp = rr.split("p")
            paths = int(pp)
        refine = int(rr)
    p = reference_preset(mode=mode)
    if refine is not None:
        p = dataclasses.replace(p, refine_range=refine)
    if paths is not None:
        p = dataclasses.replace(p, paths=paths)
    return p


def run_ours(left, right, mode: str, device="cuda"):
    """The port's engine on ``device`` at :func:`params_for` ``(mode)`` →
    (disp, valid) as numpy arrays, and None for the time, as the
    reference's script returns."""
    disp, valid = compute_disparity(left, right, params_for(mode), device=device)
    return disp.cpu().numpy(), valid.cpu().numpy(), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="360x640, D=128")
    ap.add_argument("--modes", default="hier", help="comma list: hier,full")
    ap.add_argument("--scenes", default="boxes,slant,steps,gain")
    ap.add_argument("--seeds", type=int, default=1, help="instances per scene (averaged)")
    ap.add_argument("--device", default="cuda", help="the port's engine's device")
    args = ap.parse_args(argv)
    H, W, D = (360, 640, 128) if args.quick else (720, 1280, D_SEARCH)

    rows = []
    for name in args.scenes.split(","):
        acc = {}
        for seed in range(args.seeds):
            rng = np.random.default_rng(42 + 1000 * seed)
            left, right, gt, gt_valid = SCENES[name](rng, H, W, D)
            engines = [("cv2_sgbm_3way", lambda: run_reference(left, right, D))]
            engines += [(f"ours_{mode}", lambda m=mode: run_ours(left, right, m, args.device))
                        for mode in args.modes.split(",")]
            for ename, fn in engines:
                out = fn()
                acc.setdefault(ename, []).append(None if out is None else evaluate_disparity(
                    out[0], gt, valid=out[1], gt_valid=gt_valid))
        for ename, ms in acc.items():
            if ms[0] is None:
                row = {"scene": name, "engine": ename, "skipped": "cv2 is not installed"}
            else:
                m = {k: float(np.mean([x[k] for x in ms])) for k in ms[0]}
                row = {"scene": name, "engine": ename, **{k: round(v, 4) for k, v in m.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)

    keys = ["coverage", "epe", "bad1", "bad2", "d1_all"]
    print(f"\n{'scene':>7} {'engine':>16} " + " ".join(f"{k:>8}" for k in keys))
    for r in rows:
        print(f"{r['scene']:>7} {r['engine']:>16} "
              + " ".join(f"{r.get(k, float('nan')):>8.4f}" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
