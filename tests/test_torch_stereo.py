"""The rest of the port's ``stereo`` package against the JAX package:
segmented horizontal scans (``agg_wseg``), the session autotune and the
evaluation module.

``agg_wseg`` runs through both of the port's impls (``"xla"``, the plain
scans; ``"auto"``, the kernel path's plain versions here) against the
reference's ``impl="xla"``: ``valid`` exact, disparity within 1e-4 (as
``tests/test_sgm.py``'s own segmented test). At pack=1 and pack=4, at a
width the segments divide (W % (128·agg_wseg) == 0) and one they do not,
and through ``production_preset()``, whose stacked refine takes the
segments while its coarse search does not. The port applies the segments
under every impl; the reference's pack=1 Pallas branch ignores them
(ROADMAP.md §3), so its ``impl="xla"`` is the yardstick.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu import stereo as jstereo
from stereovision_tpu.stereo import autotune as jautotune
from stereovision_tpu.stereo import eval as jeval
from stereovision_tpu.stereo import sgm as jsgm
from stereovision_tpu_torch import convert, stereo
from stereovision_tpu_torch.stereo import autotune, sgm
from stereovision_tpu_torch.stereo import eval as teval

RNG = np.random.default_rng(17)


def _pair(h, w, shift=10):
    base = RNG.uniform(0, 255, (h, w + shift)).astype(np.float32)
    return base[:, :w].copy(), base[:, shift:shift + w].copy()


def _ported(jp, impl):
    return dataclasses.replace(convert.sgm_params_from_dict(dataclasses.asdict(jp)), impl=impl)


# ---------------------------------------------------------------------------
# agg_wseg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,pack,segmented", [
    (40, 256, 1, True), (40, 200, 1, False),  # 200 % 256 != 0: no segments
    (64, 256, 4, True), (64, 384, 4, False),
])
def test_agg_wseg_matches_reference_xla(h, w, pack, segmented):
    left, right = _pair(h, w)
    jp = jstereo.SGMParams(num_disparities=32, pack=pack, paths=2, agg_wseg=2, impl="xla")
    dr, vr = (np.asarray(a) for a in jstereo.compute_disparity(jnp.asarray(left),
                                                               jnp.asarray(right), jp))
    p = _ported(jp, "xla")
    assert sgm._effective_wseg(p, w, h // pack) == (2 if segmented else 1)
    assert jsgm._effective_wseg(jp, w, h // pack) == sgm._effective_wseg(p, w, h // pack)
    unseg = stereo.compute_disparity(left, right, dataclasses.replace(p, agg_wseg=1),
                                     device="cpu")[0].numpy()
    for impl in ("xla", "auto"):
        d, v = stereo.compute_disparity(left, right, _ported(jp, impl), device="cpu")
        np.testing.assert_array_equal(v.numpy(), vr)
        np.testing.assert_allclose(d.numpy(), dr, atol=1e-4, rtol=0)
        # the restarts change the scan where they apply, and only there
        assert (d.numpy() != unseg).any() == segmented
    good = dr[6:-6, 40:-6][vr[6:-6, 40:-6]]
    assert abs(np.median(good) - 10) < 0.3


def test_agg_wseg_production_preset_matches_reference_xla():
    """``production_preset()`` at 64 disparities with ``agg_wseg=2`` on
    48×256: the stacked refine (64 rows, 16 a strip) restarts every 128
    columns, the 85-wide coarse search does not take segments."""
    left, right = _pair(48, 256, shift=30)
    jp = dataclasses.replace(jstereo.production_preset(), num_disparities=64, agg_wseg=2,
                             impl="xla")
    dr, vr = (np.asarray(a) for a in jstereo.compute_disparity(jnp.asarray(left),
                                                               jnp.asarray(right), jp))
    refine = sgm._refine_params(_ported(jp, "xla"), pack=4)
    assert refine.agg_wseg == 2 and sgm._effective_wseg(refine, 256, 16) == 2
    for impl in ("xla", "auto"):
        d, v = stereo.compute_disparity(left, right, _ported(jp, impl), device="cpu")
        np.testing.assert_array_equal(v.numpy(), vr)
        np.testing.assert_allclose(d.numpy(), dr, atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_aggregate_segments_match_reference(impl):
    """``sgm.aggregate`` with segments, float32 sums bit for bit: the
    kernel impl's ``aggregate_dir`` launches run on the segmented view."""
    cost = RNG.integers(0, 24, (16, 256, 12)).astype(np.float32)
    jp = jstereo.SGMParams(paths=2, agg_wseg=2, impl="xla")
    ref = np.asarray(jsgm.aggregate(jnp.asarray(cost), jp))
    got = sgm.aggregate(torch.from_numpy(cost), _ported(jp, impl))
    np.testing.assert_array_equal(got.numpy(), ref)
    unseg = sgm.aggregate(torch.from_numpy(cost), _ported(dataclasses.replace(jp, agg_wseg=1),
                                                          impl))
    assert not torch.equal(got, unseg)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,want", [
    ({"stats_impl": "auto"}, "pallas"),
    ({"stats_impl": "auto", "paths": 4}, "pallas"),
    ({"stats_impl": "xla"}, "xla"),
    ({"stats_impl": "pallas"}, "pallas"),
])
def test_tune_stats_impl_matches_reference_off_the_tpu(change, want):
    jp = dataclasses.replace(jstereo.production_preset(), **change)
    p = convert.sgm_params_from_dict(dataclasses.asdict(jp))
    got = autotune.tune_stats_impl(p)
    assert got.stats_impl == want == jautotune.tune_stats_impl(jp).stats_impl
    assert dataclasses.replace(got, stats_impl=p.stats_impl) == p
    assert stereo.tune_stats_impl is autotune.tune_stats_impl


def test_both_statistics_forms_give_the_same_frame():
    """What makes the choice free: ``stats_impl`` "pallas" and "xla" give
    the same disparity through the kernel path (on the card too:
    chip_smoke.py's autotune phase)."""
    left, right = _pair(32, 128)
    p = stereo.SGMParams(num_disparities=16, paths=2)
    a = stereo.compute_disparity(left, right, p, device="cpu")
    b = stereo.compute_disparity(left, right, dataclasses.replace(p, stats_impl="xla"),
                                 device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_timed_best_picks_the_faster_form():
    import time

    calls = {"slow": 0, "fast": 0}

    def slow(x):
        calls["slow"] += 1
        time.sleep(0.01)
        return (x + 1,)

    def fast(x):
        calls["fast"] += 1
        return {"out": [x * 2]}

    best, times = autotune.timed_best({"slow": slow, "fast": fast}, (torch.ones(3),),
                                      rounds=2, inner=3)
    assert best == "fast" and set(times) == {"slow", "fast"}
    assert times["slow"] >= 0.01 > times["fast"]
    assert calls == {"slow": 1 + 2 * 3, "fast": 1 + 2 * 3}


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


def test_pfm_round_trip_matches_reference(tmp_path):
    img = RNG.uniform(-5, 90, (13, 17)).astype(np.float32)
    img[0, 0], img[3, 4] = np.inf, np.nan
    teval.write_pfm(str(tmp_path / "a.pfm"), img)
    jeval.write_pfm(str(tmp_path / "b.pfm"), img)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    back = teval.read_pfm(str(tmp_path / "a.pfm"))
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(back, jeval.read_pfm(str(tmp_path / "a.pfm")))
    with pytest.raises(ValueError, match="expects"):
        teval.write_pfm(str(tmp_path / "c.pfm"), img[None])


@pytest.mark.parametrize("count_invalid", [True, False])
def test_evaluate_disparity_matches_reference(count_invalid):
    gt = RNG.uniform(1, 60, (20, 30)).astype(np.float32)
    gt[:3] = np.inf
    gt[5, :4] = 0.0
    disp = gt + RNG.normal(0, 1.5, gt.shape).astype(np.float32)
    valid = RNG.uniform(size=gt.shape) > 0.1
    got = teval.evaluate_disparity(disp, gt, valid=valid, count_invalid_as_error=count_invalid)
    want = jeval.evaluate_disparity(disp, gt, valid=valid,
                                    count_invalid_as_error=count_invalid)
    assert got == want and set(got) >= {"coverage", "epe", "bad2", "d1_all"}
