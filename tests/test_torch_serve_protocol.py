"""The port's serving daemon alone, on the CPU: the cases of
``tests/test_serve.py`` (requests, ping, stats and shutdown; a bad request
reported and not fatal; ``set`` and ``rescale`` mid-stream; the hot folder
with ``--once``, per pair and batched; ``--save-png``) and what the port
adds: ``--save-png`` stopping at start with an ``ImportError`` naming
``imageio`` where it is missing, the batched dispatch equal to the
per-frame one, and ``io.frames``' binary netpbm decoder against
``imageio``'s.
"""

import importlib.util
import io
import json

import imageio.v2 as iio
import numpy as np
import pytest
import torch

from stereovision_tpu_torch.apps import serve
from stereovision_tpu_torch.io import frames
from stereovision_tpu_torch.io.store import CalibrationStore

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

W, H, DISP, F, TX = 160, 120, 6, 150.0, -5.0


def _calibration():
    """The identity-rectified rig: f = 150 px, baseline 5 cm."""
    K = np.array([[F, 0, (W - 1) / 2], [0, F, (H - 1) / 2], [0, 0, 1]])
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = P1.copy()
    P2[0, 3] = TX * F
    Q = np.array([[1, 0, 0, -K[0, 2]], [0, 1, 0, -K[1, 2]], [0, 0, 0, F], [0, 0, -1 / TX, 0]])
    return {"mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5), "dist_right": np.zeros(5),
            "R": np.eye(3), "T": np.array([[TX], [0.0], [0.0]]), "R1": np.eye(3),
            "R2": np.eye(3), "P1": P1, "P2": P2, "Q": Q, "img_size": np.array([W, H])}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """A calibration store and one pair at DISP px, as PGM."""
    from scipy.signal import convolve2d

    root = tmp_path_factory.mktemp("serve_protocol")
    CalibrationStore(root / "calib").save("stereo_calibration_data", _calibration())
    base = np.random.default_rng(17).uniform(0, 255, (H, W + DISP)).astype(np.float32)
    base = convolve2d(base, np.ones((5, 5), np.float32) / 25.0, mode="same", boundary="symm")
    (root / "frames").mkdir()
    iio.imwrite(root / "frames/left_001.pgm", base[:, :-DISP].astype(np.uint8))
    iio.imwrite(root / "frames/right_001.pgm", base[:, DISP:].astype(np.uint8))
    return root


def _run(argv, requests=()):
    out = io.StringIO()
    rc = serve.main(argv + ["--device", "cpu"], stdin=io.StringIO("\n".join(requests) + "\n"),
                    stdout=out)
    assert rc == 0
    return [json.loads(x) for x in out.getvalue().splitlines()]


def _pair(rig, tmp_path, rid, sub=""):
    return json.dumps({"left": str(rig / "frames/left_001.pgm"),
                       "right": str(rig / "frames/right_001.pgm"), "id": rid,
                       "out": str(tmp_path / sub)})


def _depth(rig, *more):
    return ["--calib", str(rig / "calib"), "--num-disparities", "32", *more]


def test_requests_ping_stats_shutdown(rig, tmp_path):
    reqs = [json.dumps({"cmd": "ping"}), _pair(rig, tmp_path, 1), _pair(rig, tmp_path, 2),
            json.dumps({"cmd": "stats"}), json.dumps({"cmd": "shutdown"}),
            _pair(rig, tmp_path, 3)]   # after shutdown: never served
    resps = _run(_depth(rig, "--save-npz"), reqs)
    assert resps[0] == {"ok": True, "pong": True}
    frame = {x["id"]: x for x in resps if x.get("id")}
    assert sorted(frame) == [1, 2] and frame[1]["ok"] and frame[2]["ok"]
    assert 0.0 < frame[1]["valid_frac"] <= 1.0 and frame[1]["ms"] > 0
    z = np.load(frame[1]["out_npz"])
    assert z["disparity"].shape == (H, W) and z["valid"].dtype == bool
    good = z["disparity"][z["valid"]]
    assert good.size and abs(np.median(good) - DISP) < 1.0
    stats = resps[3]
    assert stats["frames"] == 2 and stats["mean_ms"] > 0 and stats["fps"] > 0
    assert resps[-1]["frames"] == 2   # the closing stats line


def test_bad_request_is_reported_not_fatal(rig, tmp_path):
    reqs = ["not json {", json.dumps({"left": "missing.png", "right": "missing.png", "id": 5}),
            json.dumps({"left": str(tmp_path / "nothing.pgm"), "right": "x.pgm", "id": 6}),
            _pair(rig, tmp_path, 7)]
    resps = _run(_depth(rig), reqs)
    assert resps[0]["ok"] is False and "bad json" in resps[0]["error"]
    assert resps[1]["ok"] is False and resps[1]["id"] == 5
    assert resps[2]["ok"] is False and resps[2]["id"] == 6 and "nothing.pgm" in resps[2]["error"]
    assert resps[3]["ok"] is True and resps[3]["id"] == 7
    assert resps[-1]["frames"] == 1


def test_set_depth_range_mid_stream(rig, tmp_path):
    reqs = [_pair(rig, tmp_path, 1, "a"),
            json.dumps({"cmd": "set", "params": {"min_depth": 0.1, "max_depth": 99.0}}),
            _pair(rig, tmp_path, 2, "b"),
            json.dumps({"cmd": "set", "params": {"stereo_weight": 0.5}})]
    resps = _run(_depth(rig, "--save-npz"), reqs)
    byid = {x["id"]: x for x in resps if x.get("id")}
    setresp = [x for x in resps if "depth_range" in x][0]
    assert setresp == {"ok": True, "depth_range": [0.1, 99.0]}
    assert resps[3]["ok"] is False and "fusion params in depth mode" in resps[3]["error"]
    z1, z2 = np.load(byid[1]["out_npz"]), np.load(byid[2]["out_npz"])
    assert z1["depth_m"][z1["valid"]].max() <= 4.0
    # f·B/d = 150 px · 0.05 m / 6 px = 1.25 m: inside both windows
    assert abs(np.median(z2["depth_m"][z2["valid"]]) - 1.25) < 0.25


def test_set_fusion_params_and_bad_key(rig):
    reqs = [json.dumps({"cmd": "set", "params": {"stereo_weight": 0.6}}),
            json.dumps({"cmd": "set", "params": {"bogus_knob": 1}}),
            json.dumps({"cmd": "set", "params": {"min_depth": 0.3}}),
            json.dumps({"cmd": "rescale", "scale": 0.5})]
    resps = _run(["--calib", str(rig / "calib"), "--mode", "fused", "--scale", "0.75"], reqs)
    assert resps[0]["ok"] and resps[0]["fusion_params"]["stereo_weight"] == 0.6
    assert resps[1]["ok"] is False and "bogus_knob" in resps[1]["error"]
    assert resps[2] == {"ok": False, "error": "depth range applies to depth mode"}
    assert resps[3] == {"ok": True, "scale": 0.5, "proc_size": [80, 60]}


def test_rescale_mid_stream(rig, tmp_path):
    reqs = [_pair(rig, tmp_path, 1, "a"), json.dumps({"cmd": "rescale", "scale": 0.5}),
            _pair(rig, tmp_path, 2, "b"), json.dumps({"cmd": "rescale", "scale": 0.1}),
            json.dumps({"cmd": "rescale"})]
    resps = _run(_depth(rig, "--save-npz"), reqs)
    byid = {x["id"]: x for x in resps if x.get("id")}
    scaled = [x for x in resps if "scale" in x]
    assert scaled[0] == {"ok": True, "scale": 0.5, "proc_size": [80, 60]}
    assert scaled[1]["scale"] == 0.3   # clamped to [0.3, 1.0]
    assert resps[-2]["ok"] is False and "rescale needs a scale" in resps[-2]["error"]
    z1, z2 = np.load(byid[1]["out_npz"]), np.load(byid[2]["out_npz"])
    assert z1["disparity"].shape == (H, W) and z2["disparity"].shape == (H // 2, W // 2)
    good = z2["disparity"][z2["valid"]]
    assert good.size and abs(np.median(good) - DISP / 2) < 1.0


def test_watch_once_processes_every_pair(rig, tmp_path):
    resps = _run(_depth(rig, "--watch", str(rig / "frames"), "--once", "--batch", "1",
                        "--out", str(tmp_path), "--save-npz", "--save-png"))
    assert resps[-1]["frames"] == 1 and resps[0]["ok"]
    assert (tmp_path / "serve_001.npz").exists()
    png = iio.imread(tmp_path / "serve_001.png")
    assert png.shape == (H, W, 3) and png.dtype == np.uint8


def test_watch_once_batches_pending_pairs(rig, tmp_path):
    """Pending pairs ride one batched dispatch; each pair gets its own
    response and file, equal to the per-frame dispatch's; a pair of
    another size makes the batch fall back to per-frame dispatch."""
    d = tmp_path / "frames"
    d.mkdir()
    left = iio.imread(rig / "frames/left_001.pgm")
    right = iio.imread(rig / "frames/right_001.pgm")
    for i in range(3):
        iio.imwrite(d / f"left_{i:03d}.pgm", np.roll(left, i, 1))
        iio.imwrite(d / f"right_{i:03d}.pgm", np.roll(right, i, 1))
    outs = {}
    for batch in ("4", "1"):
        resps = _run(_depth(rig, "--watch", str(d), "--once", "--batch", batch,
                            "--out", str(tmp_path / batch), "--save-npz"))
        assert resps[-1]["frames"] == 3 and resps[-1]["fps"] > 0
        assert [r["ok"] for r in resps[:-1]] == [True] * 3
        outs[batch] = [np.load(tmp_path / batch / f"serve_{i:03d}.npz") for i in range(3)]
    for a, b in zip(*outs.values()):
        for key in ("disparity", "valid", "depth_m"):
            np.testing.assert_array_equal(a[key], b[key])
    iio.imwrite(d / "left_009.pgm", left[:, :W // 2])
    iio.imwrite(d / "right_009.pgm", right[:, :W // 2])
    resps = _run(_depth(rig, "--watch", str(d), "--once", "--out", str(tmp_path / "mixed")))
    assert resps[-1]["frames"] == 4 and all(r["ok"] for r in resps[:-1])


def test_save_png_without_imageio_stops_at_start(rig, monkeypatch):
    found = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "imageio" else found(name, *a))
    with pytest.raises(ImportError, match="imageio"):
        _run(_depth(rig, "--save-png"))
    # without --save-png the daemon starts and reads PGM without imageio
    resps = _run(_depth(rig), [json.dumps({"left": str(rig / "frames/left_001.pgm"),
                                           "right": str(rig / "frames/right_001.pgm")})])
    assert resps[0]["ok"] and resps[-1]["frames"] == 1
    with pytest.raises(ImportError, match="needs imageio"):
        frames.imread_gray(rig / "frames/x.bmp")


def test_the_daemon_defaults_to_the_card(rig):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--calib", str(rig / "calib")], stdin=io.StringIO(""), stdout=io.StringIO())


@pytest.mark.parametrize("shape", [(7, 11), (5, 9, 3), (1, 1), (64, 3, 3)])
def test_netpbm_decode_equals_imageio(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / ("x.pgm" if len(shape) == 2 else "x.ppm")
    iio.imwrite(path, img)
    got, want = frames.read_netpbm(path), np.asarray(iio.imread(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(frames.imread_gray(path), frames._to_gray(want))
    # comments in the header, and the .pnm suffix
    raw = path.read_bytes()
    magic, rest = raw[:2], raw[3:]
    commented = tmp_path / "c.pnm"
    commented.write_bytes(magic + b"\n# a comment\n" + rest.replace(b" ", b"\n# another\n", 1))
    np.testing.assert_array_equal(frames.read_netpbm(commented), want)
    np.testing.assert_array_equal(frames.imread_gray(commented), frames._to_gray(want))


@pytest.mark.parametrize("raw,match", [
    (b"P5\n11 x\n255\n" + bytes(77), "malformed netpbm header"),
    (b"P5\n11 7\n", "malformed netpbm header"),
    (b"P5\n11 7\n65535\n" + bytes(154), "only 8-bit"),
    (b"P5\n11 7\n255\n" + bytes(10), "raster holds 10 bytes, not 77"),
    (b"P6\n0 7\n255\n", "empty netpbm image"),
    (b"P2\n2 2\n255\n1 2 3 4\n", "not a binary PGM/PPM"),
])
def test_netpbm_decode_raises(tmp_path, raw, match):
    path = tmp_path / "bad.pgm"
    path.write_bytes(raw)
    with pytest.raises(ValueError, match=match):
        frames.read_netpbm(path)
    if raw.startswith((b"P5", b"P6")):   # imread_gray takes no other reader for them
        with pytest.raises(ValueError, match=match):
            frames.imread_gray(path)
