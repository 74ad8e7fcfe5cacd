"""The port's ``io`` modules and its two apps against the JAX package's.

``io``: ``write_ply``/``read_ply`` (the same bytes as the reference's
writer, read back by both readers), the frame sources
(``SyntheticStereoSource``, ``PairedImageSource`` through the native
loader and through ``imageio``), the native loader's decode, and the
validators, each equal to the reference's.

The apps run on the CPU (``--device cpu``) on synthetic captures: a
textured pair at a known shift, written as PNG, under an identity
rectification whose maps sample at half pixels (x + 0.5, y + 0.5), where
the exact remap's lerp rounds the same eagerly and fused. ``apps.depth``'s
``.npz`` outputs against the reference app's: ``valid`` exact, disparity
within 1e-4, depth rtol 1e-6; its colour images and point clouds too.
``apps.eval_disparity``'s metrics equal the reference app's, on a
Middlebury-style scene (PFM ground truth) and a pair with PNG ground
truth. Without their packages the apps stop at start with an
``ImportError`` naming them; without a card their default device raises.
"""

import json

import imageio.v2 as iio
import jax.numpy as jnp
import numpy as np
import pytest

from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.io import frames as jframes
from stereovision_tpu.io import native_loader as jloader
from stereovision_tpu.io import pointcloud as jply
from stereovision_tpu.io import validate as jvalidate
from stereovision_tpu_torch.io import frames, native_loader, pointcloud, validate
from stereovision_tpu_torch.io.store import CalibrationStore

W, H, SHIFT = 128, 64, 7


def _textured_pair(rng, shift=SHIFT):
    from scipy.signal import convolve2d

    base = rng.uniform(0, 255, (H, W + shift + 4))
    base = convolve2d(base, np.ones((3, 3)) / 9.0, mode="same", boundary="symm")
    return base[:, :W].astype(np.uint8), base[:, shift:shift + W].astype(np.uint8)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """Two PNG pairs and an identity-rectified calibration store."""
    root = tmp_path_factory.mktemp("captures")
    rng = np.random.default_rng(8)
    for i in range(2):
        left, right = _textured_pair(rng)
        iio.imwrite(root / f"left_{i:03d}.png", left)
        iio.imwrite(root / f"right_{i:03d}.png", right)
    K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]])
    T = np.array([-5.0, 0.0, 0.0])
    d0 = np.zeros(5)
    R1, R2, P1, P2, Q = jgeom.stereo_rectify(jnp.asarray(K), jnp.asarray(d0), jnp.asarray(K),
                                             jnp.asarray(d0), (W, H), jnp.eye(3), jnp.asarray(T),
                                             alpha=0.0)
    cal = {"mtx_left": K, "mtx_right": K, "dist_left": d0, "dist_right": d0, "R": np.eye(3),
           "T": T.reshape(3, 1), "R1": np.asarray(R1), "R2": np.asarray(R2),
           "P1": np.asarray(P1), "P2": np.asarray(P2), "Q": np.asarray(Q),
           "img_size": np.array([W, H])}
    calib = root / "calib"
    CalibrationStore(calib).save("stereo_calibration_data", cal)
    return root, calib


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("colors", [None, "rgb", "gray"])
def test_ply_round_trip_matches_reference(tmp_path, colors):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(6, 5, 3)).astype(np.float32)
    pts[0, 0, 1] = np.nan
    valid = rng.uniform(size=(6, 5)) > 0.2
    col = {None: None, "rgb": rng.integers(0, 300, (6, 5, 3)),
           "gray": rng.uniform(0, 255, (6, 5))}[colors]
    n = pointcloud.write_ply(tmp_path / "a.ply", pts, colors=col, valid=valid)
    assert n == jply.write_ply(tmp_path / "b.ply", pts, colors=col, valid=valid)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    got, got_c = pointcloud.read_ply(tmp_path / "a.ply")
    want, want_c = jply.read_ply(tmp_path / "a.ply")
    keep = valid.reshape(-1) & np.isfinite(pts.reshape(-1, 3)).all(axis=1)
    np.testing.assert_array_equal(got, pts.reshape(-1, 3)[keep])
    np.testing.assert_array_equal(got, want)
    assert (got_c is None) == (colors is None)
    if colors:
        np.testing.assert_array_equal(got_c, want_c)


def test_frame_sources_match_reference(captures, tmp_path):
    root, _ = captures
    for a, b in zip(frames.SyntheticStereoSource(48, 96, n_frames=2),
                    jframes.SyntheticStereoSource(48, 96, n_frames=2)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert native_loader.available() and jloader.available()
    mine, ref = frames.PairedImageSource(root), jframes.PairedImageSource(root)
    assert mine.pairs() == ref.pairs() and len(mine) == 2
    for (l1, r1), (l2, r2) in zip(mine, ref):
        assert l1.shape == (H, W) and l1.dtype == np.float32
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(r1, r2)
    # colour frames and files the native loader does not read: imageio
    for (l1, _), (l2, _) in zip(frames.PairedImageSource(root, color=True),
                                jframes.PairedImageSource(root, color=True)):
        assert l1.shape == (H, W, 3)
        np.testing.assert_array_equal(l1, l2)
    img = np.asarray(iio.imread(root / "left_000.png"))
    iio.imwrite(tmp_path / "left_a.bmp", img)
    iio.imwrite(tmp_path / "right_a.bmp", img)
    (bl, _), = frames.PairedImageSource(tmp_path)
    np.testing.assert_array_equal(bl, frames.imread_gray(root / "left_000.png"))
    np.testing.assert_array_equal(native_loader.decode(root / "left_000.png"),
                                  jloader.decode(root / "left_000.png"))


def test_validators_match_reference(captures, tmp_path):
    root, _ = captures
    assert validate.verify_stereo_images(root) == jvalidate.verify_stereo_images(root)
    assert validate.verify_stereo_images(root)[:2] == (True, 2)
    assert validate.verify_image_sizes(root, "*.png") == jvalidate.verify_image_sizes(
        root, "*.png")
    iio.imwrite(tmp_path / "left_x.png", np.zeros((8, 8), np.uint8))
    iio.imwrite(tmp_path / "right_x.png", np.zeros((8, 9), np.uint8))
    iio.imwrite(tmp_path / "left_y.png", np.zeros((8, 8), np.uint8))
    assert validate.verify_stereo_images(tmp_path) == jvalidate.verify_stereo_images(tmp_path)
    assert not validate.verify_stereo_images(tmp_path)[0]
    assert validate.verify_image_sizes(tmp_path, "*.png")[2] == [("right_x.png", (9, 8))]
    flat = np.full((5, 5), 3.0)
    for f in (None, np.zeros((0,)), flat, flat + np.eye(5) * 9):
        assert validate.frame_ok(f) == jvalidate.frame_ok(f)


# ---------------------------------------------------------------------------
# apps
# ---------------------------------------------------------------------------


def test_depth_app_matches_reference(captures, tmp_path):
    from stereovision_tpu.apps import depth as jdepth
    from stereovision_tpu_torch.apps import depth

    root, calib = captures
    flags = ["--calib", str(calib), "--images", str(root), "--num-disparities", "16",
             "--save-npz", "--save-ply", "--max-depth", "20"]
    assert jdepth.main(flags + ["--out", str(tmp_path / "ref")]) == 0
    assert depth.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for i in range(2):
        ref, got = (np.load(tmp_path / d / f"depth_{i:04d}.npz") for d in ("ref", "port"))
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        np.testing.assert_allclose(got["disparity"], ref["disparity"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-6)
        d = got["disparity"][4:-4, SHIFT + 4:-4][got["valid"][4:-4, SHIFT + 4:-4]]
        assert d.size > 0.5 * (H - 8) * (W - SHIFT - 8) and abs(np.median(d) - SHIFT) < 0.5
        png = [iio.imread(tmp_path / dd / f"depth_{i:04d}.png") for dd in ("ref", "port")]
        assert png[1].shape == (H, W, 3)
        np.testing.assert_array_equal(png[1], png[0])
        (p_pts, p_col), (r_pts, r_col) = (pointcloud.read_ply(tmp_path / dd / f"depth_{i:04d}.ply")
                                          for dd in ("port", "ref"))
        np.testing.assert_allclose(p_pts, r_pts, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(p_col, r_col)


def test_eval_app_matches_reference(captures, tmp_path, capsys):
    import cv2

    from stereovision_tpu.apps import eval_disparity as jeval_app
    from stereovision_tpu_torch.apps import eval_disparity
    from stereovision_tpu_torch.stereo.eval import write_pfm

    root, _ = captures
    scene = tmp_path / "scene"
    scene.mkdir()
    for src, dst in (("left_000.png", "im0.png"), ("right_000.png", "im1.png")):
        (scene / dst).write_bytes((root / src).read_bytes())
    gt = np.full((H, W), float(SHIFT), np.float32)
    gt[:, :SHIFT] = np.inf
    write_pfm(str(scene / "disp0.pfm"), gt)
    cv2.imwrite(str(tmp_path / "gt.png"), (np.nan_to_num(gt, posinf=0) * 256).astype(np.uint16))
    flags = ["--scenes", str(scene), "--left", str(scene / "im0.png"), "--right",
             str(scene / "im1.png"), "--gt", str(tmp_path / "gt.png"), "--num-disparities", "16",
             "--mode", "full", "--json"]
    assert jeval_app.main(flags) == 0
    ref = capsys.readouterr().out.splitlines()
    assert eval_disparity.main(flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(got) == 2
    assert json.loads(got[0])["bad2"] < 0.2


@pytest.mark.parametrize("app,missing", [("depth", "matplotlib"), ("depth", "imageio"),
                                         ("eval_disparity", "imageio"),
                                         ("eval_disparity", "cv2")])
def test_apps_name_what_is_missing(captures, tmp_path, monkeypatch, app, missing):
    import importlib
    import importlib.util

    root, calib = captures
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else real(name, *a))
    mod = importlib.import_module(f"stereovision_tpu_torch.apps.{app}")
    argv = (["--calib", str(calib), "--images", str(root), "--out", str(tmp_path)]
            if app == "depth" else
            ["--left", str(root / "left_000.png"), "--right", str(root / "right_000.png"),
             "--gt", str(tmp_path / "gt.png")])
    with pytest.raises(ImportError, match=missing):
        mod.main(argv + ["--device", "cpu"])


def test_apps_default_to_the_card(captures, tmp_path):
    import torch

    from stereovision_tpu_torch.apps import depth

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    root, calib = captures
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        depth.main(["--calib", str(calib), "--images", str(root), "--out", str(tmp_path)])
