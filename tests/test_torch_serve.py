"""The port's serving daemon (``apps/serve.py``) against the JAX package's,
on the CPU, over the stdin JSON-lines protocol.

Both servers run on the identity-rectified 256x192 rig of
``tests/_fused_rig.py`` saved as a calibration store, with the same
requests over pairs written as binary PGM (the port's own decoder against
``imageio``) and as PNG. Depth mode (serve's defaults: ``hier``, refine
32, at ``--num-disparities 32``) with ``set`` and ``rescale`` mid-stream;
fused mode at ``--scale 0.75`` (MidasSmall with the bundled weights, flow
depth with the reference's hypothesis draws, ``time.monotonic`` replaced
in both servers by one sequence, since flow depth and the hysteresis read
``t_now``). Responses are equal but for the timings (``ms``, ``mean_ms``,
``fps``, ``wall_fps``); the saved arrays: depth mode ``valid`` exact,
disparity within 1e-4, depth within rtol 1e-6; fused mode ``fused``
within 0.1 on the 0-255 scale and ``meters`` within rtol 1e-4 beyond what
the fused difference carries (``_fused_rig.assert_frame_close``),
confidence within 1e-4.
"""

import io
import json
import types

import imageio.v2 as iio
import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.apps import serve as jserve
from stereovision_tpu_torch.apps import serve
from stereovision_tpu_torch.io.store import CalibrationStore
from stereovision_tpu_torch.mono import ego

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import (assert_frame_close, reference_model, ReferenceDraws,
                        rig_calibration, stereo_pair)

pytestmark = pytest.mark.usefixtures("few_threads")

TIMINGS = ("ms", "mean_ms", "fps", "wall_fps")
N_FUSED = 4


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """A calibration store and four pairs: 8 px of disparity, panning 1 px
    a pair; the first two as PGM, the others as PNG."""
    root = tmp_path_factory.mktemp("serve_rig")
    CalibrationStore(root / "calib").save("stereo_calibration_data", rig_calibration())
    left, right = stereo_pair(np.random.default_rng(23))
    frames = root / "frames"
    frames.mkdir()
    names = []
    for k in range(N_FUSED):
        ext = "pgm" if k < 2 else "png"
        for side, img in (("left", left), ("right", right)):
            iio.imwrite(frames / f"{side}_{k:03d}.{ext}", np.roll(img, k, 1).astype(np.uint8))
        names.append((str(frames / f"left_{k:03d}.{ext}"), str(frames / f"right_{k:03d}.{ext}")))
    return root, names


def _serve(module, argv, requests):
    out = io.StringIO()
    assert module.main(argv, stdin=io.StringIO("\n".join(requests) + "\n"), stdout=out) == 0
    return [json.loads(x) for x in out.getvalue().splitlines()]


def _frame(names, k, out_dir, rid):
    return json.dumps({"left": names[k][0], "right": names[k][1], "id": rid, "out": out_dir})


def _untimed(resp, root):
    """A response without its timings, with its saved file's path made
    relative to its server's output directory."""
    out = {k: v for k, v in resp.items() if k not in TIMINGS}
    if "out_npz" in out:
        out["out_npz"] = out["out_npz"].replace(str(root), "")
    return out


def _both(rig, tmp_path, argv, requests_of):
    """(port's responses, reference's responses, their output directories)."""
    root, names = rig
    dirs = {who: tmp_path / who for who in ("port", "ref")}
    got = _serve(serve, argv + ["--device", "cpu"], requests_of(names, str(dirs["port"])))
    want = _serve(jserve, argv, requests_of(names, str(dirs["ref"])))
    assert [_untimed(r, dirs["port"]) for r in got] == [_untimed(r, dirs["ref"]) for r in want]
    for resp in got + want:
        for key in TIMINGS:
            assert key not in resp or resp[key] is None or resp[key] > 0
    return got, want, dirs


def test_depth_mode_matches_the_reference(rig, tmp_path):
    calib = str(rig[0] / "calib")

    def requests(names, out):
        return [_frame(names, 0, out, 1), _frame(names, 2, out, 2),
                json.dumps({"cmd": "set", "params": {"min_depth": 0.1, "max_depth": 99.0}}),
                _frame(names, 1, out, 3),
                json.dumps({"cmd": "rescale", "scale": 0.5}),
                _frame(names, 3, out, 4),
                json.dumps({"cmd": "ping"}), json.dumps({"cmd": "stats"})]

    got, _, dirs = _both(rig, tmp_path, ["--calib", calib, "--num-disparities", "32",
                                         "--save-npz"], requests)
    assert [r.get("id") for r in got if "valid_frac" in r] == [1, 2, 3, 4]
    assert got[2]["depth_range"] == [0.1, 99.0] and got[4]["proc_size"] == [128, 96]
    assert got[-1]["frames"] == 4
    for k in range(N_FUSED):
        a, b = (np.load(dirs[w] / f"serve_{k:03d}.npz") for w in ("port", "ref"))
        np.testing.assert_array_equal(a["valid"], b["valid"])
        np.testing.assert_allclose(a["disparity"], b["disparity"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["depth_m"], b["depth_m"], rtol=1e-6, atol=0)
    half = np.load(dirs["port"] / "serve_003.npz")
    assert half["disparity"].shape == (96, 128) and half["valid"].mean() > 0.8


def test_fused_mode_matches_the_reference(rig, tmp_path, monkeypatch):
    monkeypatch.setattr(jnn, "create_model", reference_model)
    monkeypatch.setattr(ego, "draw_hypotheses", ReferenceDraws())
    for module in (serve, jserve):  # one clock sequence for each server
        clock = iter(0.1 * k for k in range(100))
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=module.time.perf_counter, sleep=module.time.sleep,
            monotonic=lambda clock=clock: next(clock)))
    calib = str(rig[0] / "calib")

    def requests(names, out):
        reqs = [_frame(names, k, out, k + 1) for k in range(N_FUSED - 1)]
        return reqs + [json.dumps({"cmd": "set", "params": {"stereo_weight": 0.6}}),
                       _frame(names, N_FUSED - 1, out, N_FUSED), json.dumps({"cmd": "stats"})]

    got, _, dirs = _both(rig, tmp_path, ["--calib", calib, "--mode", "fused", "--scale", "0.75",
                                         "--save-npz"], requests)
    frames = [r for r in got if "fusion_mode" in r]
    assert len(frames) == N_FUSED and {r["occlusion"] for r in frames} == {"none"}
    assert frames[-1]["camera_moving"] is True
    for k in range(N_FUSED):
        a, b = (np.load(dirs[w] / f"serve_{k:03d}.npz") for w in ("port", "ref"))
        assert_frame_close({"fused": torch.from_numpy(a["fused"]),
                            "meters": torch.from_numpy(a["meters"])},
                           {"fused": b["fused"], "meters": b["meters"]}, f"served frame {k}")
        np.testing.assert_allclose(a["confidence"], b["confidence"], atol=1e-4, rtol=0)
