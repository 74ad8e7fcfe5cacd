"""The port's two mono-depth apps and what they call, against the JAX
package's.

``core.image.percentile_normalize`` equals the reference's within 1e-6 on
data with ties, on continuous data and on a constant image.
``utils.profiling``: ``trace`` writes a Chrome trace holding the
``annotate`` range. ``apps.mono_ai``
(``--arch small``, the bundled weights, ``--device cpu``) and
``apps.mono_motion`` (four frames shifted 2 px apart, the reference's
hypothesis draws) on the reference test's frames
(``tests/test_apps.py:126-174``): the same files, each pixel's TURBO index
within 1 level of the reference's (the depth before the colormap, as
uint8), the same printed lines. ``--arch`` and ``--checkpoint`` reach ``create_model``
verbatim. Without their packages the apps stop at start naming them;
without a card their default device raises.
"""

import json

import cv2
import imageio.v2 as iio
import jax
import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.core import image as jim
from stereovision_tpu_torch.core import image as tim
from stereovision_tpu_torch.mono import ego
from stereovision_tpu_torch.mono import nn as tnn
from stereovision_tpu_torch.utils import profiling

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import reference_model, ReferenceDraws

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("case", ["ties", "continuous", "constant"])
def test_percentile_normalize_matches(case):
    rng = np.random.default_rng(3)
    img = {"ties": rng.integers(0, 12, (60, 80)),
           "continuous": rng.normal(5.0, 2.0, (60, 80)),
           "constant": np.full((60, 80), 4.25)}[case].astype(np.float32)
    ref = jax.jit(jim.percentile_normalize, static_argnums=(1, 2))
    for lo, hi in ((3.0, 97.0), (5.0, 95.0)):
        want = np.asarray(ref(img, lo, hi))
        got = tim.percentile_normalize(torch.from_numpy(img), lo, hi)
        assert got.dtype == torch.float32 and got.shape == img.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if case == "constant":
        assert not got.any()


def test_profiling(tmp_path):
    x = torch.rand(64, 64)
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("mono-depth range"):
            (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "mono-depth range" for e in events)


def _jpgs(root, frames):
    root.mkdir()
    for i, f in enumerate(frames):
        iio.imwrite(root / f"f_{i:03d}.jpg", f.astype(np.uint8))
    return root


def _turbo_index(rgb):
    """Each pixel's TURBO entries: the indices whose colour (as the apps
    write it, truncated to uint8) it is (several where entries coincide)."""
    lut = tim._turbo_lut().astype(np.uint8)
    hits = (rgb[..., None, :] == lut).all(-1)  # (H, W, 256)
    assert hits.any(-1).all(), "a pixel holds no TURBO colour"
    return hits


def _same_pngs(out, ref, pattern, n):
    """The same files; each pixel's TURBO index within 1 of the
    reference's (adjacent entries of the table differ by up to 7 levels)."""
    got, want = sorted(out.glob(pattern)), sorted(ref.glob(pattern))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == n
    idx = np.arange(256)
    for g, w in zip(got, want):
        a, b = iio.imread(g), iio.imread(w)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        ha, hb = _turbo_index(a), _turbo_index(b)
        lo_a = np.where(ha, idx, 999).min(-1)
        hi_a = np.where(ha, idx, -999).max(-1)
        lo_b = np.where(hb, idx, 999).min(-1)
        hi_b = np.where(hb, idx, -999).max(-1)
        gap = np.maximum(lo_a - hi_b, lo_b - hi_a)  # ≤ 0 where an entry is shared
        assert gap.max() <= 1, (g.name, gap.max(), int((gap > 0).sum()))


def test_mono_ai_matches_reference(tmp_path, monkeypatch, capsys):
    from stereovision_tpu.apps import mono_ai as jmono_ai
    from stereovision_tpu_torch.apps import mono_ai

    rng = np.random.default_rng(2)
    frames = _jpgs(tmp_path / "frames", [rng.integers(0, 255, (96, 128, 3)) for _ in range(2)])
    monkeypatch.setattr(jnn, "create_model", reference_model)
    assert jmono_ai.main(["--images", str(frames), "--out", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert mono_ai.main(["--images", str(frames), "--out", str(tmp_path / "port"),
                         "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    _same_pngs(tmp_path / "port", tmp_path / "ref", "depth_*.png", 2)
    assert iio.imread(tmp_path / "port" / "depth_0000.png").shape == (96, 128, 3)


def test_mono_ai_arch_and_checkpoint_reach_create_model(tmp_path, monkeypatch):
    from stereovision_tpu_torch.apps import mono_ai

    frames = _jpgs(tmp_path / "frames",
                   [np.random.default_rng(4).integers(0, 255, (64, 96, 3))])
    seen = []
    real = tnn.create_model

    def spy(**kw):
        seen.append(kw)
        return real(device="cpu")  # the small net whatever the arch: a plumbing test

    monkeypatch.setattr(tnn, "create_model", spy)
    out = tmp_path / "out"
    for flags in ([], ["--arch", "dpt_large"],
                  ["--arch", "midas_v21_small", "--checkpoint", str(tmp_path / "hub.pt")]):
        assert mono_ai.main(["--images", str(frames), "--out", str(out), "--device", "cpu",
                             *flags]) == 0
    assert seen == [
        {"arch": "small", "torch_state_dict": None, "device": "cpu"},
        {"arch": "dpt_large", "torch_state_dict": None, "device": "cpu"},
        {"arch": "midas_v21_small", "torch_state_dict": str(tmp_path / "hub.pt"),
         "device": "cpu"}]
    assert len(list(out.glob("depth_*.png"))) == 1
    with pytest.raises(SystemExit):
        mono_ai.main(["--images", str(frames), "--arch", "tiny"])


def test_mono_motion_matches_reference(tmp_path, monkeypatch, capsys):
    from stereovision_tpu.apps import mono_motion as jmono_motion
    from stereovision_tpu_torch.apps import mono_motion

    rng = np.random.default_rng(1)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (96, 140)).astype(np.float32), (7, 7), 1.5)
    frames = _jpgs(tmp_path / "frames", [
        cv2.warpAffine(base, np.float32([[1, 0, 2.0 * i], [0, 1, 0]]), (128, 96))
        for i in range(4)])
    monkeypatch.setattr(ego, "draw_hypotheses", ReferenceDraws())
    assert jmono_motion.main(["--images", str(frames), "--out", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert mono_motion.main(["--images", str(frames), "--out", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == 4 and "MOVING" in got
    n = len(list((tmp_path / "ref").glob("motion_*.png")))
    assert n >= 1
    _same_pngs(tmp_path / "port", tmp_path / "ref", "motion_*.png", n)
    with pytest.raises(SystemExit, match="no frames"):
        mono_motion.main(["--images", str(frames), "--glob", "*.png", "--device", "cpu"])


@pytest.mark.parametrize("app", ["mono_ai", "mono_motion"])
def test_apps_name_what_is_missing_and_need_a_card(tmp_path, monkeypatch, app):
    import importlib
    import importlib.util

    module = importlib.import_module(f"stereovision_tpu_torch.apps.{app}")
    frames = _jpgs(tmp_path / "frames", [np.full((64, 96), 100)])
    real = importlib.util.find_spec
    with monkeypatch.context() as m:
        m.setattr(importlib.util, "find_spec",
                  lambda name, *a: None if name == "matplotlib" else real(name, *a))
        with pytest.raises(ImportError, match="matplotlib"):
            module.main(["--images", str(frames)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(["--images", str(frames), "--out", str(tmp_path / "out")])
