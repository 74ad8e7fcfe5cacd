"""The port's quality evaluations (``stereovision_tpu_torch/scripts/
eval_quality.py``, ``eval_speckle.py``, ``eval_mono.py``) against the
reference's scripts of the same names, loaded by path (the files are not
edited; their search range ``D_SEARCH`` is shrunk with ``monkeypatch``):

- the four scenes at 96x192, D=32: ``gt`` and ``gt_valid`` bit for bit,
  the images within ``BLUR_TOL`` (the port blurs with numpy where the
  reference calls ``cv2.GaussianBlur``: float32 rounding only), and the
  numpy blur against cv2 itself;
- every mode string the reference parses → the same ``SGMParams``, the
  reference's captured by replacing its ``compute_disparity`` with a stub
  (no JAX program is compiled);
- one engine-and-score parity (``full`` at D=32 on the reference's own
  boxes arrays): the port's scores within 1e-6 of the reference's;
- ``eval_speckle``'s rows at a small ``hier2`` preset against the
  reference's ``main`` on the same arrays;
- ``ssi_metrics`` on seeded arrays, exactly;
- the three ``main`` functions on the CPU at small sizes.

Torch keeps two threads (``_fused_rig.few_threads``): with a thread a core
in each of six xdist workers the port's engine ran ~80x slower here.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu_torch.scripts import eval_mono as em
from stereovision_tpu_torch.scripts import eval_quality as eq
from stereovision_tpu_torch.scripts import eval_speckle as es
from stereovision_tpu_torch.stereo.eval import evaluate_disparity

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = Path(__file__).resolve().parents[1]
H, W, D = 96, 192, 32
# the numpy blur against cv2's float32 one, on values of 40-230 (measured
# 3.1e-5 to 6.1e-5, a few float32 ulps at 128-256)
BLUR_TOL = 1e-4
# every mode string the reference's run_ours parses, each branch taken
MODES = ("prod", "prod_cp4", "prod_cs2", "prod_cs4", "prod_bfull", "hier", "hier2", "full",
         "hier_r32", "hier_r16p2", "hier2_r16", "full_r64p2")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_eq():
    return _load("eval_quality")


def _small(preset, d):
    """A preset factory like ``preset`` whose search is ``d`` wide."""
    return lambda mode="hier": dataclasses.replace(preset(mode=mode), num_disparities=d)


@pytest.mark.parametrize("shape", [(97, 203), (5, 7), (720, 64)])
def test_blur_matches_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    x = np.random.default_rng(shape[0]).uniform(40, 230, shape).astype(np.float32)
    got = eq.gaussian_blur_5(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.GaussianBlur(x, (5, 5), 1.2), rtol=0, atol=BLUR_TOL)


@pytest.mark.parametrize("name", list(eq.SCENES))
def test_scene_matches_reference(ref_eq, monkeypatch, name):
    monkeypatch.setattr(ref_eq, "D_SEARCH", D)
    want = getattr(ref_eq, f"scene_{name}")(np.random.default_rng(42), H, W)
    got = eq.SCENES[name](np.random.default_rng(42), H, W, D)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=BLUR_TOL)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3].any() and not got[3].all()


def test_mode_params_match_reference(ref_eq, monkeypatch):
    import stereovision_tpu.stereo as ref_stereo

    seen = []

    def stub(left, right, p):
        seen.append(p)
        return np.zeros(left.shape, np.float32), np.zeros(left.shape, bool)

    monkeypatch.setattr(ref_stereo, "compute_disparity", stub)
    img = np.zeros((4, 8), np.float32)
    for mode in MODES:
        ref_eq.run_ours(img, img, mode)
        assert dataclasses.asdict(eq.params_for(mode)) == dataclasses.asdict(seen[-1]), mode
    assert len(seen) == len(MODES)


def test_engine_and_scores_match_reference(ref_eq, monkeypatch):
    import stereovision_tpu.stereo as ref_stereo

    monkeypatch.setattr(ref_eq, "D_SEARCH", D)
    monkeypatch.setattr(ref_stereo, "reference_preset", _small(ref_stereo.reference_preset, D))
    monkeypatch.setattr(eq, "reference_preset", _small(eq.reference_preset, D))
    left, right, gt, gt_valid = ref_eq.scene_boxes(np.random.default_rng(42), H, W)
    from stereovision_tpu.stereo.eval import evaluate_disparity as ref_score

    disp_r, valid_r, _ = ref_eq.run_ours(left, right, "full")
    disp, valid, t = eq.run_ours(left, right, "full", device="cpu")
    assert t is None and disp.dtype == np.float32 and valid.dtype == bool
    want = ref_score(disp_r, gt, valid=valid_r, gt_valid=gt_valid)
    got = evaluate_disparity(disp, gt, valid=valid, gt_valid=gt_valid)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.5 < got["coverage"] <= 1.0 and got["bad2"] < 0.2


def test_speckle_rows_match_reference(ref_eq, monkeypatch, capsys):
    """The reference's ``main`` with its scenes cut to the slant scene at
    96x192 (the same arrays for all four rows: one compile pair; the boxes
    scene has no speckle at this size) and ``reference_preset`` at D=64,
    against :func:`eval_speckle.speckle_row` on those arrays."""
    import stereovision_tpu.stereo as ref_stereo
    from stereovision_tpu.ops import native as ref_native

    if not ref_native.available():
        pytest.skip("the reference's native library is unavailable")
    monkeypatch.setattr(ref_eq, "D_SEARCH", D)
    slant = ref_eq.scene_slant(np.random.default_rng(42), H, W)
    for name in eq.SCENES:
        monkeypatch.setattr(ref_eq, f"scene_{name}", lambda rng, h, w: slant)
    monkeypatch.setitem(sys.modules, "eval_quality", ref_eq)
    monkeypatch.setattr(ref_stereo, "reference_preset", _small(ref_stereo.reference_preset, 64))
    monkeypatch.setattr(sys, "argv", ["eval_speckle.py", "--mode", "hier2", "--quick"])
    assert _load("eval_speckle").main() == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(want) == 4
    p_win = dataclasses.replace(es.reference_preset(mode="hier2"), num_disparities=64)
    got = es.speckle_row("boxes", *slant, p_win, device="cpu")
    assert got == want[0]
    assert got["exact_removed"] > 0 and got["windowed_removed"] > 0 and got["disagree_frac"] > 0


def test_ssi_metrics_match_reference():
    ref = _load("eval_mono")
    rng = np.random.default_rng(11)
    for valid in (None, rng.uniform(size=(40, 50)) > 0.3):
        pred = rng.uniform(0, 255, (40, 50)).astype(np.float32)
        target = (0.02 * pred + rng.normal(0, 0.5, pred.shape) + 1).astype(np.float32)
        assert em.ssi_metrics(pred, target, valid) == ref.ssi_metrics(pred, target, valid)
    raw = em.ssi_metrics(pred, target, valid, digits=None)
    assert {k: round(v, 4) for k, v in raw.items()} == ref.ssi_metrics(pred, target, valid)
    # no positive pair: delta is nan in both
    neg = -np.ones((4, 4), np.float32)
    assert np.isnan(em.ssi_metrics(neg, neg)["delta_1.25"])
    assert np.isnan(ref.ssi_metrics(neg, neg)["delta_1.25"])


def test_eval_quality_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(eq, "reference_preset", _small(eq.reference_preset, D))
    scene = eq.SCENES["boxes"]
    monkeypatch.setitem(eq.SCENES, "boxes", lambda rng, h, w, d: scene(rng, H, W, d))
    assert eq.main(["--device", "cpu", "--quick", "--modes", "full", "--scenes", "boxes"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["engine"] for r in rows] == ["cv2_sgbm_3way", "ours_full"]
    assert rows[1]["coverage"] > 0.5 and set(rows[1]) >= {"epe", "bad2", "d1_all"}
    # where cv2 is not installed its rows say so and score nothing
    monkeypatch.setattr(eq, "cv2_or_none", lambda: None)
    assert eq.main(["--device", "cpu", "--quick", "--modes", "full", "--scenes", "boxes"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert rows[0] == {"scene": "boxes", "engine": "cv2_sgbm_3way",
                       "skipped": "cv2 is not installed"}


def test_eval_speckle_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(es, "reference_preset", _small(es.reference_preset, 64))
    scenes = {k: (lambda rng, h, w, d, fn=fn: fn(rng, H, W, D)) for k, fn in eq.SCENES.items()}
    monkeypatch.setattr(es, "SCENES", scenes)
    assert es.main(["--device", "cpu", "--quick"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["scene"] for r in rows] == list(eq.SCENES)
    from stereovision_tpu_torch.ops import native

    monkeypatch.setattr(native, "available", lambda name="speckle": False)
    assert es.main(["--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"error": "native library unavailable"}


def test_estimate_depth_takes_a_reversed_view():
    """The scripts hand ``img[..., ::-1]`` (negative strides) to
    ``estimate_depth``, as the reference's do."""
    from stereovision_tpu_torch.mono.nn import create_model, estimate_depth

    model = create_model(device="cpu")
    img = np.random.default_rng(2).uniform(0, 255, (48, 64, 3)).astype(np.float32)
    got = estimate_depth(model, img[..., ::-1], device="cpu")
    want = estimate_depth(model, img[..., ::-1].copy(), device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (48, 64) and bool((g == w).all())


def test_eval_mono_main_on_cpu(capsys):
    assert em.main(["--n", "1", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["dataset"] for r in rows] == ["procedural_heldout", "stereo_scene_boxes",
                                            "stereo_scene_steps"]
    for r in rows:
        assert 0 <= r["ssi_rmse_rel"] < 1.5 and 0 <= r["delta_1.25"] <= 1
