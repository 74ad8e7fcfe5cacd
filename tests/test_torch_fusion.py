"""The port's ``fusion`` package against the JAX package's.

The cases of ``tests/test_fusion.py`` as parity probes: the same numpy
inputs go through the reference (jitted, on the CPU) and the port (on the
CPU). Occlusion codes, the hysteresis carry over a 14-frame sequence and
the fusion's mode are exact; scores within rtol 1e-5; calibrated, fused
and normalized maps within 1e-3 on the 0-255 scale (percentiles and
reductions round in another order); meters within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereovision_tpu.fusion as jf
from stereovision_tpu_torch import fusion as tf

RNG = np.random.default_rng(23)
MAP_TOL = dict(rtol=0, atol=1e-3)


def textured(h=240, w=320, lo=0, hi=255):
    return RNG.uniform(lo, hi, size=(h, w)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


PAIRS = {
    "clear": lambda: (textured(), textured()),
    "covered_left": lambda: (np.full((240, 320), 20.0, np.float32), textured()),
    "covered_right": lambda: (textured(), np.full((240, 320), 25.0, np.float32)),
    "both": lambda: (np.full((240, 320), 30.0, np.float32),
                     np.full((240, 320), 35.0, np.float32)),
    "dim_left": lambda: (textured(lo=0, hi=60), textured()),
}
EXPECT = {"clear": "none", "covered_left": "left", "covered_right": "right", "both": "both"}


@pytest.mark.parametrize("case", list(PAIRS))
def test_occlusion_scores_and_codes_match(case):
    left, right = PAIRS[case]()
    ref = [float(v) for v in jf.occlusion_scores(jnp.asarray(left), jnp.asarray(right))]
    got = tf.occlusion_scores(_t(left), _t(right), device="cpu")
    assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    np.testing.assert_allclose([float(g) for g in got], ref, rtol=1e-5)
    label = tf.classify_occlusion(*(float(g) for g in got))
    assert label == jf.classify_occlusion(*ref)
    if case in EXPECT:
        assert label == EXPECT[case]
    code = tf.classify_occlusion_code(*got, device="cpu")
    assert code.dtype == torch.int32
    assert int(code) == int(jax.jit(jf.classify_occlusion_code)(*ref))
    assert tf.OCCLUSION_CODES[int(code)] == label


def test_classify_code_at_the_thresholds():
    """Scores on and around the 0.45 threshold and its 0.6 share decide as
    the reference's float32 arithmetic does."""
    t = np.float32(0.45)
    vals = [0.0, float(t * np.float32(0.6)), float(np.nextafter(t * np.float32(0.6), 1)),
            float(t), float(np.nextafter(t, np.float32(1))), 0.6, 0.95]
    code = jax.jit(jf.classify_occlusion_code)
    for ls in vals:
        for rs in vals:
            got = tf.classify_occlusion_code(torch.tensor(ls), torch.tensor(rs), device="cpu")
            assert int(got) == int(code(jnp.float32(ls), jnp.float32(rs))), (ls, rs)


def test_hysteresis_carry_matches_over_14_frames():
    seq = ["left"] * 4 + ["none"] + ["left"] * 6 + ["right", "none", "none"]
    host, ref_host = tf.OcclusionHysteresis(), jf.OcclusionHysteresis()
    carry = tf.hysteresis_init(device="cpu")
    ref_carry = jf.hysteresis_init()
    update = jax.jit(jf.hysteresis_update)
    for det in seq:
        code = tf.OCCLUSION_CODES.index(det)
        assert host.update(det) == ref_host.update(det)
        carry = tf.hysteresis_update(carry, torch.tensor(code, dtype=torch.int32))
        ref_carry = update(ref_carry, jnp.int32(code))
        assert [int(v) for v in carry] == [int(v) for v in ref_carry]
        assert tf.OCCLUSION_CODES[int(carry[0])] == host.state
        assert (host._pending, host._count) == (ref_host._pending, ref_host._count)
    assert host.state == "left" and not host.stereo_enabled
    assert all(v.dtype == torch.int32 for v in carry)


def test_hysteresis_needs_5_frames():
    h = tf.OcclusionHysteresis()
    for _ in range(4):
        assert h.update("left") == "none"
    assert h.update("left") == "left"
    for _ in range(4):
        assert h.update("none") == "left"
    assert h.update("none") == "none" and h.stereo_enabled


@pytest.mark.parametrize("anchors", ["all", "none", "some"])
def test_calibrate_midas_to_stereo_matches(anchors):
    stereo = textured(120, 160, 10, 100)
    midas = stereo * 2.0 + 30.0 + RNG.normal(0, 0.5, stereo.shape).astype(np.float32)
    conf = {"all": np.ones_like(stereo), "none": np.zeros_like(stereo),
            # 99 then 100 anchors: either side of the robust fit's gate
            "some": np.zeros_like(stereo)}[anchors]
    cases = [conf]
    if anchors == "some":
        c99 = conf.copy()
        c99.reshape(-1)[:99] = 1.0
        c100 = conf.copy()
        c100.reshape(-1)[:100] = 1.0
        cases = [c99, c100]
    for c in cases:
        ref = np.asarray(jf.calibrate_midas_to_stereo(jnp.asarray(midas), jnp.asarray(stereo),
                                                      jnp.asarray(c)))
        got = tf.calibrate_midas_to_stereo(_t(midas), _t(stereo), _t(c), device="cpu")
        np.testing.assert_allclose(got.numpy(), ref, **MAP_TOL)
    if anchors == "all":
        assert np.median(np.abs(got.numpy() - stereo)) < 2.0


def test_calibrate_flat_midas_matches():
    stereo = textured(60, 80, 10, 100)
    flat = np.full_like(stereo, 3.0)
    for conf in (np.ones_like(stereo), np.zeros_like(stereo)):
        ref = np.asarray(jf.calibrate_midas_to_stereo(jnp.asarray(flat), jnp.asarray(stereo),
                                                      jnp.asarray(conf)))
        got = tf.calibrate_midas_to_stereo(_t(flat), _t(stereo), _t(conf), device="cpu")
        np.testing.assert_allclose(got.numpy(), ref, **MAP_TOL)


@pytest.mark.parametrize("invert", [True, False])
def test_normalize_to_stereo_range_matches(invert):
    stereo = textured(60, 80, 20, 120)
    depth = np.tile(np.linspace(0, 1, 80, dtype=np.float32), (60, 1))
    ref = np.asarray(jf.normalize_to_stereo_range(jnp.asarray(depth), jnp.asarray(stereo), invert))
    got = tf.normalize_to_stereo_range(_t(depth), _t(stereo), invert, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, **MAP_TOL)
    assert (got[0, 0] > got[0, -1]) == invert


def _fusion_case(name):
    n = 64
    ones = np.ones((n, n), np.float32)
    if name == "stereo_base":
        s = np.full((n, n), 100.0, np.float32)
        return (s, ones, s, ones, s, False), {}
    if name == "midas_fill":
        s = np.full((n, n), 200.0, np.float32)
        conf = ones.copy()
        conf[20:44, 20:44] = 0.0
        return (s, conf, np.full((n, n), 120.0, np.float32), ones, None, False), {
            "have_flow": False}
    if name in ("flow_fill_moving", "flow_fill_static"):
        s = np.full((n, n), 100.0, np.float32)
        s[10:20, 10:20] = 0.0
        return (s, ones, None, None, np.full((n, n), 90.0, np.float32),
                name.endswith("moving")), {"have_midas": False}
    if name == "all_three":
        s = textured(n, n, 0, 200)
        conf = (RNG.uniform(size=(n, n)) > 0.3).astype(np.float32)
        return (s, conf, textured(n, n, 50, 150), RNG.uniform(size=(n, n)).astype(np.float32),
                textured(n, n, 0, 255), True), {}
    if name == "midas_base":
        return (None, None, textured(n, n, 0, 80), None, textured(n, n, 50, 200), True), {
            "have_stereo": False}
    if name in ("flow_only", "flow_only_static"):
        return (None, None, None, None, textured(48, 48, 50, 200), name == "flow_only"), {
            "have_stereo": False, "have_midas": False}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["stereo_base", "midas_fill", "flow_fill_moving",
                                  "flow_fill_static", "all_three", "midas_base", "flow_only",
                                  "flow_only_static"])
def test_fuse_depth_maps_matches(name):
    (s, sc, m, mc, f, moving), kw = _fusion_case(name)
    ref = jf.fuse_depth_maps(*(None if x is None else jnp.asarray(x) for x in (s, sc, m, mc, f)),
                             jnp.asarray(moving), **kw)
    got = tf.fuse_depth_maps(_t(s), _t(sc), _t(m), _t(mc), _t(f), torch.tensor(moving),
                             device="cpu", **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **MAP_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
    assert got[2].dtype == torch.int32 and int(got[2]) == int(ref[2])
    assert got[0].dtype == torch.float32


def test_fuse_params_and_mode_text():
    p = tf.FusionParams(use_midas_fill=False, flow_fill_weight=0.3)
    assert dataclasses_fields(tf.FusionParams()) == dataclasses_fields(jf.FusionParams())
    from stereovision_tpu.fusion.fuse import mode_text as jmode_text
    from stereovision_tpu_torch.fusion.fuse import mode_text

    jp = jf.FusionParams(use_midas_fill=False, flow_fill_weight=0.3)
    for code in range(4):
        for mf, ff in ((True, True), (False, True), (True, False)):
            assert mode_text(code, p, mf, ff) == jmode_text(code, jp, mf, ff)
    (s, sc, m, mc, f, moving), kw = _fusion_case("all_three")
    ref = jf.fuse_depth_maps(*(jnp.asarray(x) for x in (s, sc, m, mc, f)), jnp.asarray(moving),
                             params=jp)
    got = tf.fuse_depth_maps(_t(s), _t(sc), _t(m), _t(mc), _t(f), torch.tensor(moving),
                             params=p, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **MAP_TOL)
    with pytest.raises(ValueError, match="at least one"):
        tf.fuse_depth_maps(None, None, None, None, None, False, have_stereo=False,
                           have_midas=False, have_flow=False, device="cpu")


def dataclasses_fields(obj):
    import dataclasses

    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def test_fused_to_meters_matches():
    v = np.array([[0.0, 1.0, 64.5, 255.0]], np.float32)
    for kw in ({}, {"num_disparities": 96.0, "compat_scale": 3.75, "min_disparity": 2.0}):
        ref = np.asarray(jf.fused_to_meters(jnp.asarray(v), 700.0, 8.0, **kw))
        got = tf.fused_to_meters(_t(v), 700.0, 8.0, device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(tf.fused_to_meters(_t(v), 700.0, 8.0, num_disparities=128.0,
                                                  device="cpu")[0, 3].item(), 0.4375, rtol=1e-3)
    assert tf.fused_to_meters(_t(v), 700.0, 8.0, device="cpu")[0, 0].item() == 30.0


def test_fusion_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    left, right = PAIRS["clear"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.occlusion_scores(left, right)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.fused_to_meters(left, 700.0, 8.0)
