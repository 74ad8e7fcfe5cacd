"""Calibration CLI: mono, stereo and universal (joint) calibration from
chessboard captures.

Counterpart of ``stereovision_tpu/apps/calibrate.py``, with its flags plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU). The reference
pins its CPU unless ``--accelerator`` is given; the port runs on the card
unless asked otherwise.

    python -m stereovision_tpu_torch.apps.calibrate mono --images captures \\
        --pattern left_*.jpg --side left --board 9x6 --square-cm 2.5 --out output
    python -m stereovision_tpu_torch.apps.calibrate stereo --images captures_stereo \\
        --board 9x6 --square-cm 2.5 --out output
    python -m stereovision_tpu_torch.apps.calibrate universal --images captures \\
        --board 9x6 --square-cm 2.5 --out output

The store (``.npz``), the reference's pkl (``--reference-pkl``) and the
txt sidecars are the reference's formats. Needs ``imageio`` (frames read,
``rectification_check.png`` and the undistorted dumps written).
"""

from __future__ import annotations

import argparse
import fnmatch
import sys
from pathlib import Path

import numpy as np
import torch


def board_object_points(pattern, square):
    w, h = pattern
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([xs.ravel() * square, ys.ravel() * square, np.zeros(w * h)], -1)


def detect_in_directory(directory, glob, pattern, min_images, log=print, device="cuda"):
    from stereovision_tpu_torch.calib import detect_chessboard
    from stereovision_tpu_torch.io.frames import _imread_gray

    files = sorted(p for p in Path(directory).iterdir() if fnmatch.fnmatch(p.name, glob))
    detected, used = [], []
    for p in files:
        found, corners = detect_chessboard(_imread_gray(p), pattern, device=device)
        log(f"  {p.name}: {'ok' if found else 'no board'}")
        if found:
            detected.append(corners)
            used.append(p)
    if len(detected) < min_images:
        raise SystemExit(f"need >= {min_images} boards, found {len(detected)} in {directory}")
    return np.asarray(detected), used


def _image_size(path):
    from stereovision_tpu_torch.io.frames import _imread_gray

    img = _imread_gray(path)
    return (img.shape[1], img.shape[0])


def run_mono(args, dev):
    from stereovision_tpu_torch.calib import calibrate_camera
    from stereovision_tpu_torch.io.store import CalibrationStore

    pattern = tuple(int(v) for v in args.board.split("x"))
    glob = args.pattern or f"{args.side}_*.jpg"
    corners, used = detect_in_directory(args.images, glob, pattern, args.min_images, device=dev)
    size = _image_size(used[0])
    out = calibrate_camera(board_object_points(pattern, args.square_cm), corners, size,
                           device=dev)
    rms = out["reprojection_error"]
    # the reference's quality gates: success < 3.0; tiers 0.5 / 1.0
    tier = "excellent" if rms < 0.5 else ("ok" if rms < 1.0 else "re-calibrate advised")
    print(f"RMS = {rms:.4f} px ({tier}); success gate <3.0: {'PASS' if rms < 3.0 else 'FAIL'}")
    store = CalibrationStore(args.out)
    store.save(f"calibration_data_{args.side}", {**out, "img_size": np.asarray(size)})
    if args.reference_pkl:
        store.save_reference_pkl(Path(args.out) / f"calibration_data_{args.side}.pkl", out)
    if args.dump_undistorted:
        _dump_undistorted(used, out, size, Path(args.out) / "undistorted", dev)
    print(f"saved → {args.out}/calibration_data_{args.side}.npz")
    return 0 if rms < 3.0 else 1


def _dump_undistorted(files, cal, size, out_dir, dev):
    """Per-image undistortion dumps: getOptimalNewCameraMatrix(alpha=1) +
    undistort (reference camera_calibration.py:122-178)."""
    import imageio.v2 as iio

    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.io.frames import _imread_gray

    out_dir.mkdir(parents=True, exist_ok=True)
    K = torch.as_tensor(np.asarray(cal["camera_matrix"], np.float64), device=dev)
    dist = torch.as_tensor(np.asarray(cal["distortion_coefficients"], np.float64), device=dev)
    newK, _ = geom.get_optimal_new_camera_matrix(K, dist, size, alpha=1.0)
    mx, my = geom.init_undistort_rectify_map(K, dist, torch.eye(3, dtype=K.dtype, device=dev),
                                             newK, size)
    for p in files:
        und = im.remap(torch.as_tensor(_imread_gray(p), device=dev), mx, my).cpu().numpy()
        iio.imwrite(out_dir / f"undistorted_{p.name}.png", np.clip(und, 0, 255).astype(np.uint8))


def _detect_pairs(args, pattern, min_pairs, dev):
    from stereovision_tpu_torch.calib import detect_chessboard
    from stereovision_tpu_torch.io.frames import PairedImageSource, _imread_gray

    cl, cr = [], []
    size = None
    for lp, rp in PairedImageSource(args.images).pairs():
        gl, gr = _imread_gray(lp), _imread_gray(rp)
        size = (gl.shape[1], gl.shape[0])
        fl, col_l = detect_chessboard(gl, pattern, device=dev)
        fr, col_r = detect_chessboard(gr, pattern, device=dev)
        print(f"  {lp.name}: {'ok' if fl and fr else 'skip'}")
        if fl and fr:
            cl.append(col_l)
            cr.append(col_r)
    if len(cl) < min_pairs:
        raise SystemExit(f"need >= {min_pairs} valid pairs, found {len(cl)}")
    return np.asarray(cl), np.asarray(cr), size


def rectify_calibration(out, size, pattern, square_cm, device="cuda") -> dict:
    """A stereo_calibrate result → the full stereo store: R1/R2/P1/P2/Q from
    ``stereo_rectify`` (alpha 0), the ROIs, the board and the image size."""
    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(device)

    def f64(key):
        return torch.as_tensor(np.asarray(out[key], np.float64), device=dev)

    R1, R2, P1, P2, Q = geom.stereo_rectify(
        f64("mtx_left"), f64("dist_left").ravel(), f64("mtx_right"), f64("dist_right").ravel(),
        size, f64("R"), f64("T").ravel(), alpha=0.0)
    return {
        **out,
        "R1": R1.cpu().numpy(), "R2": R2.cpu().numpy(),
        "P1": P1.cpu().numpy(), "P2": P2.cpu().numpy(), "Q": Q.cpu().numpy(),
        "roi1": np.asarray([0, 0, *size]), "roi2": np.asarray([0, 0, *size]),
        "chessboard_size": np.asarray(pattern), "square_size": square_cm,
        "img_size": np.asarray(size),
    }


def run_stereo(args, dev, universal=False):
    from stereovision_tpu_torch.calib import CalibrationFlags, stereo_calibrate
    from stereovision_tpu_torch.calib.verify import rectification_epipolar_error
    from stereovision_tpu_torch.io.frames import PairedImageSource
    from stereovision_tpu_torch.io.store import CalibrationStore

    pattern = tuple(int(v) for v in args.board.split("x"))
    # the reference: dependent stereo needs >= 8 pairs, universal >= 10
    cl, cr, size = _detect_pairs(args, pattern, 10 if universal else 8, dev)
    obj = board_object_points(pattern, args.square_cm)
    store = CalibrationStore(args.out)
    if universal:
        out = stereo_calibrate(obj, cl, cr, size, flags=CalibrationFlags.UNIVERSAL, device=dev)
        out["calibration_type"] = "universal_stereo"
    else:
        mono_l = store.load("calibration_data_left")
        mono_r = store.load("calibration_data_right")
        out = stereo_calibrate(
            obj, cl, cr, size,
            K1=mono_l["camera_matrix"], d1=mono_l["distortion_coefficients"],
            K2=mono_r["camera_matrix"], d2=mono_r["distortion_coefficients"],
            flags=CalibrationFlags(fix_intrinsic=True), device=dev)
    rms = out["ret"]
    baseline = float(np.linalg.norm(out["T"]))
    print(f"stereo RMS = {rms:.4f} px" + ("  [warn >1.0]" if rms > 1.0 else ""))
    print(f"baseline = {baseline:.2f} cm"
          + ("" if 1 <= baseline <= 50 else "  [outside 1–50 cm sanity window]"))
    full = rectify_calibration(out, size, pattern, args.square_cm, dev)
    store.save("stereo_calibration_data",
               {k: v for k, v in full.items() if not isinstance(v, str)})
    if args.reference_pkl:
        store.save_reference_pkl(Path(args.out) / "stereo_calibration_data.pkl", full)
    store.export_txt_sidecars("stereo_calibration_data")
    _write_rectification_check(args, full, size, universal, dev)
    # the reference's scanline image, measured
    metrics = rectification_epipolar_error(full, iter(PairedImageSource(args.images)), pattern,
                                           device=dev)
    if metrics.get("n_pairs"):
        print(f"rectification check: mean |Δy| = {metrics['mean_abs_dy']:.3f} px "
              f"(max {metrics['max_abs_dy']:.2f}) over {metrics['n_pairs']} pairs")
    print(f"saved → {args.out}/stereo_calibration_data.npz")
    return 0


def _write_rectification_check(args, cal, size, scanlines: bool, dev):
    """The first pair rectified side by side (stereo_calibration.py:316-338);
    the universal variant draws green scanlines every 50 px."""
    import imageio.v2 as iio

    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.io.frames import PairedImageSource, _imread_gray

    pairs = PairedImageSource(args.images).pairs()
    if not pairs:
        return

    def f64(key):
        return torch.as_tensor(np.asarray(cal[key], np.float64), device=dev)

    views = []
    for path, side, n in zip(pairs[0], ("left", "right"), ("1", "2")):
        mx, my = geom.init_undistort_rectify_map(f64(f"mtx_{side}"), f64(f"dist_{side}").ravel(),
                                                 f64(f"R{n}"), f64(f"P{n}"), size)
        views.append(im.remap(torch.as_tensor(_imread_gray(path), device=dev), mx, my)
                     .cpu().numpy())
    rgb = np.stack([np.concatenate(views, axis=1)] * 3, axis=-1)
    if scanlines:
        rgb[::50, :, :] = [0, 255, 0]
    iio.imwrite(Path(args.out) / "rectification_check.png",
                np.clip(rgb, 0, 255).astype(np.uint8))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.calibrate")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--images", required=True)
    common.add_argument("--board", default="9x6", help="inner corners WxH")
    common.add_argument("--square-cm", type=float, default=2.5)
    common.add_argument("--out", default="output")
    common.add_argument("--min-images", type=int, default=10)
    common.add_argument("--reference-pkl", action="store_true",
                        help="also write the reference's pickle format")
    common.add_argument("--device", default=argparse.SUPPRESS, help="cuda (default) or cpu")
    m = sub.add_parser("mono", parents=[common])
    m.add_argument("--side", choices=["left", "right"], required=True)
    m.add_argument("--pattern", default=None, help="filename glob (default <side>_*.jpg)")
    m.add_argument("--dump-undistorted", action="store_true",
                   help="write alpha=1 undistorted copies (camera_calibration.py:122-178)")
    sub.add_parser("stereo", parents=[common])
    sub.add_parser("universal", parents=[common])
    args = ap.parse_args(argv)

    from stereovision_tpu_torch.apps import require
    from stereovision_tpu_torch.utils.backend import resolve_device

    require("stereovision_tpu_torch.apps.calibrate", "imageio")
    dev = resolve_device(args.device)
    if args.cmd == "mono":
        return run_mono(args, dev)
    return run_stereo(args, dev, universal=(args.cmd == "universal"))


if __name__ == "__main__":
    sys.exit(main())
