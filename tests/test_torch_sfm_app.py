"""The port's SfM app on the 6-frame rig of ``tests/test_apps.py`` with
``--device cpu``, against the truth (its RANSAC draws come from a
``torch.Generator``, the reference's from ``jax.random``, so the two runs
test different hypotheses), and its BA checkpoint against the reference
app's in both directions: the port resumes from a checkpoint the
reference app wrote, and the reference app from one the port wrote.

``build_tracks`` against the reference's on a smooth 12-frame sequence
(``tests/test_sfm_tracks.py``'s): corners, tracks and matches exact.
"""

import cv2
import imageio.v2 as iio
import numpy as np
import pytest
import torch

from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.apps import sfm as ref_sfm
from stereovision_tpu_torch.apps import sfm

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

ARGS = ["--glob", "*.jpg", "--fx", "250", "--fy", "250", "--cx", "100", "--cy", "60",
        "--min-track-length", "3"]


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Two fronto-parallel textured planes, each shifted by its own
    parallax a frame (``tests/test_apps.py::TestSfmApp``'s rig)."""
    d = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(71)
    far = cv2.GaussianBlur(rng.uniform(0, 255, (140, 260)).astype(np.float32), (5, 5), 1.0)
    near = cv2.GaussianBlur(rng.uniform(0, 255, (60, 80)).astype(np.float32), (5, 5), 1.0)
    for f in range(6):
        img = np.roll(far, -2 * f, axis=1)[:120, :200].copy()
        x0 = 60 - 5 * f
        img[35:95, x0:x0 + 80] = near
        iio.imwrite(d / f"f_{f:03d}.jpg", img.astype(np.uint8))
    return d


def _check_result(z):
    assert z["poses"].shape == (6, 6) and z["rms"] < 3.0
    t = z["poses"][:, 3:]
    assert np.abs(np.diff(t[:, 0])).sum() > np.abs(np.diff(t[:, 1])).sum()


def test_sequence_sfm(frames_dir, tmp_path, capsys):
    out = tmp_path / "sfm"
    assert sfm.main(["--images", str(frames_dir), "--out", str(out), "--ba-iters", "6",
                     "--device", "cpu", *ARGS]) == 0
    z = np.load(out / "sfm_result.npz")
    _check_result(z)
    assert list(z["files"]) == [f"f_{f:03d}.jpg" for f in range(6)]
    ck = np.load(out / "ba_checkpoint.npz")
    assert int(ck["iters_done"]) == 6
    np.testing.assert_array_equal(ck["poses"], z["poses"])
    assert '"frames": 6' in capsys.readouterr().out


def test_resume_across_the_two_apps(frames_dir, tmp_path, capsys):
    out = tmp_path / "sfm"
    # the reference writes a checkpoint after 5 iterations, the port resumes
    assert ref_sfm.main(["--images", str(frames_dir), "--out", str(out), "--ba-iters", "5",
                         *ARGS]) == 0
    with np.load(out / "ba_checkpoint.npz") as z:
        ref_ck = dict(z)
    assert sfm.main(["--images", str(frames_dir), "--out", str(out), "--ba-iters", "8",
                     "--resume", "--device", "cpu", *ARGS]) == 0
    assert "resumed BA checkpoint at iteration 5" in capsys.readouterr().out
    ck = np.load(out / "ba_checkpoint.npz")
    assert int(ck["iters_done"]) == 8
    assert ck["poses"].shape == ref_ck["poses"].shape
    assert ck["landmarks"].shape == ref_ck["landmarks"].shape
    _check_result(np.load(out / "sfm_result.npz"))
    # the reference resumes from the port's checkpoint
    assert ref_sfm.main(["--images", str(frames_dir), "--out", str(out), "--ba-iters", "10",
                         "--resume", *ARGS]) == 0
    assert "resumed BA checkpoint at iteration 8" in capsys.readouterr().out
    assert int(np.load(out / "ba_checkpoint.npz")["iters_done"]) == 10
    # a finished checkpoint: nothing left to run
    assert sfm.main(["--images", str(frames_dir), "--out", str(out), "--ba-iters", "10",
                     "--resume", "--device", "cpu", *ARGS]) == 0
    assert np.isinf(np.load(out / "sfm_result.npz")["rms"])


def _smooth_sequence(n_frames=12, h=72, w=96, shift=1.0, seed=3):
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    big = ndi.gaussian_filter(rng.uniform(0, 255, (h, w + int(n_frames * shift) + 8)),
                              1.0).astype(np.float32)
    return [big[:, int(f * shift):int(f * shift) + w] for f in range(n_frames)]


def test_build_tracks_matches_the_reference():
    frames = _smooth_sequence()
    want = ref_sfm.build_tracks(frames, np.eye(3), max_corners=64)
    got = sfm.build_tracks(frames, np.eye(3), max_corners=64, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 10
    for (gi, gv), (wi, wv) in zip(got[3], want[3]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_pieces_of_the_app():
    kp = np.zeros((3, 4, 2))
    kp[..., 0] = np.arange(4)
    track_of = np.array([[0, 1, -1, 2], [0, 1, 2, -1], [0, -1, 2, 3]])
    L, uv, lid, mask = sfm.observations(kp, track_of, 4, 2)
    assert L == 3  # tracks 0, 1 and 2 seen twice or more; 3 once
    assert mask.sum(axis=1).tolist() == [3, 3, 2] and uv.shape == (3, 8, 2)
    np.testing.assert_array_equal(lid[0, :3], [0, 1, 2])
    assert sfm.sfm_mesh(6, "cpu").shape == {"frame": 1, "tile": 1}


def test_the_app_defaults_to_the_card(frames_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sfm.main(["--images", str(frames_dir), "--out", str(tmp_path), *ARGS])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sfm.build_tracks(_smooth_sequence(3), np.eye(3))
