"""The port's disparity engine (stereovision_tpu_torch.stereo) against the
JAX package.

``SGMParams`` and its presets must equal the reference's field for field.
``compute_disparity`` runs on the CPU through both of the port's paths
(``impl="xla"``, the plain scan; ``impl="auto"``, the kernel path's plain
versions) and is held against the reference's ``impl="xla"`` and
``impl="pallas_interpret"``: ``valid`` exact, disparity within 1e-4 (the
reference's own xla-versus-Pallas tolerance) — the full search with and
without the LR check, ``paths=2``, lane packing, ``fill_invalid`` and the
coarse-to-fine modes (``agg_wseg``: ``tests/test_torch_stereo.py``). The
interpret impl, which has no counterpart, must raise
``NotImplementedError``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu import stereo as jstereo
from stereovision_tpu_torch import convert, stereo
from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.stereo import sgm

RNG = np.random.default_rng(11)


def small_pair(h=40, w=72, shift=5):
    base = RNG.uniform(0, 255, size=(h, w + shift)).astype(np.float32)
    return base[:, :w], base[:, shift:shift + w]


def _ported(jp, impl):
    return dataclasses.replace(convert.sgm_params_from_dict(dataclasses.asdict(jp)), impl=impl)


def _port_disparity(left, right, jp, impl):
    d, v = stereo.compute_disparity(left, right, _ported(jp, impl), device="cpu")
    assert d.dtype == torch.float32 and v.dtype == torch.bool
    return d.numpy(), v.numpy()


def _assert_matches(port, ref):
    (d, v), (dr, vr) = port, ref
    np.testing.assert_array_equal(v, vr)
    np.testing.assert_allclose(d, dr, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _fields(params):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(params)]


def test_sgm_params_fields_and_defaults_equal_the_reference():
    assert _fields(stereo.SGMParams) == _fields(jstereo.SGMParams)
    assert dataclasses.asdict(stereo.SGMParams()) == dataclasses.asdict(jstereo.SGMParams())


@pytest.mark.parametrize("preset", ["reference_preset", "production_preset"])
def test_presets_equal_the_reference(preset):
    assert (dataclasses.asdict(getattr(stereo, preset)())
            == dataclasses.asdict(getattr(jstereo, preset)()))


def test_post_init_check_matches_the_reference():
    for mod in (stereo, jstereo):
        with pytest.raises(ValueError, match="b_decimate"):
            mod.SGMParams(b_decimate=2)


def test_params_carry_across_from_the_reference():
    jp = jstereo.SGMParams(num_disparities=48, min_disparity=2, p1=6.5, lr_max_diff=-1)
    assert dataclasses.asdict(convert.sgm_params_from_dict(dataclasses.asdict(jp))) == \
        dataclasses.asdict(jp)
    with pytest.raises(TypeError):
        convert.sgm_params_from_dict({"no_such_field": 1})


# ---------------------------------------------------------------------------
# compute_disparity against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,min_d", [(40, 72, 0), (40, 72, 3), (37, 64, 0)])
def test_compute_disparity_matches_reference_xla(h, w, min_d):
    left, right = small_pair(h, w)
    jp = jstereo.SGMParams(num_disparities=16, min_disparity=min_d, lr_max_diff=-1, impl="xla")
    dx, vx = jstereo.compute_disparity(jnp.asarray(left), jnp.asarray(right), jp)
    ref = (np.asarray(dx), np.asarray(vx))
    assert ref[1].mean() > 0.5  # the comparison covers mostly matched pixels
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_compute_disparity_matches_reference_pallas_interpret():
    """The one interpret-mode run of this file (~12 s on the CPU)."""
    left, right = small_pair()
    jp = jstereo.SGMParams(num_disparities=16, lr_max_diff=-1, impl="pallas_interpret")
    dp, vp = jstereo.compute_disparity(jnp.asarray(left), jnp.asarray(right), jp)
    ref = (np.asarray(dp), np.asarray(vp))
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_disparity_with_confidence_matches_reference():
    left, right = small_pair(shift=7)
    jp = jstereo.SGMParams(num_disparities=16, min_disparity=2, lr_max_diff=-1, impl="xla")
    dr, cr = jstereo.disparity_with_confidence(jnp.asarray(left), jnp.asarray(right), jp)
    d, c = stereo.disparity_with_confidence(left, right, _ported(jp, "auto"), device="cpu")
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), atol=1e-4, rtol=0)


def test_compute_disparity_batch_is_the_per_frame_result():
    pairs = [small_pair(24, 48) for _ in range(2)]
    p = stereo.SGMParams(num_disparities=16, lr_max_diff=-1)
    lefts = np.stack([pr[0] for pr in pairs])
    rights = np.stack([pr[1] for pr in pairs])
    d, v = stereo.compute_disparity_batch(lefts, rights, p, device="cpu")
    assert d.shape == (2, 24, 48) and v.shape == (2, 24, 48)
    for i, (left, right) in enumerate(pairs):
        di, vi = stereo.compute_disparity(left, right, p, device="cpu")
        assert torch.equal(d[i], di) and torch.equal(v[i], vi)


def test_int16_path_volumes_match_reference_xla():
    """n_bits + P2 > 127 sends the kernel path's per-direction volumes to
    int16 (the reference's rule, sgm.py:552)."""
    left, right = small_pair(24, 48)
    jp = jstereo.SGMParams(num_disparities=16, lr_max_diff=-1, p1=7.0, p2=110.0, impl="xla")
    dx, vx = jstereo.compute_disparity(jnp.asarray(left), jnp.asarray(right), jp)
    ref = (np.asarray(dx), np.asarray(vx))
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_int16_duals_take_the_statistics_kernel(monkeypatch):
    """With paths=2 the int16 horizontal pair goes to wta_stats_from_duals,
    as the reference's goes to its kernel (sgm.py:558-563), and the result,
    LR check included, is the reference's."""
    left, right = small_pair(24, 48)
    jp = jstereo.SGMParams(num_disparities=16, paths=2, p1=7.0, p2=110.0, impl="xla")
    ref = _reference(left, right, jp)
    seen = []
    wta = sgm_cuda.wta_stats_from_duals

    def spy(hf, hb, *a):
        seen.append(hf.dtype)
        return wta(hf, hb, *a)

    monkeypatch.setattr(sgm_cuda, "wta_stats_from_duals", spy)
    _assert_matches(_port_disparity(left, right, jp, "auto"), ref)
    assert seen == [torch.int16]


@pytest.mark.parametrize("shape,shift,kw,dtype,emit", [
    ((40, 72), 5, dict(lr_max_diff=-1), torch.int8, "none"),
    ((40, 72), 7, dict(min_disparity=3, lr_max_diff=1, paths=4), torch.int8, "hwd"),
    ((24, 48), 5, dict(lr_max_diff=-1, p1=7.0, p2=110.0), torch.int16, "none"),
])
def test_full_search_takes_the_fused_sum_wta(monkeypatch, shape, shift, kw, dtype, emit):
    """paths=4 (LR off, LR on, int16 path volumes) sends the four path
    volumes to ``sgm_cuda.sum_wta_fused`` once, with the summed volume only
    for the LR check, and never to the plain ``sgm_cuda.sum_wta``; the
    result is the reference's ``impl="xla"``. The shapes and parameters
    are those of the tests above: no new JAX program."""
    left, right = small_pair(*shape, shift=shift)
    jp = jstereo.SGMParams(num_disparities=16, impl="xla", **kw)
    ref = _reference(left, right, jp)
    seen = []
    fused = sgm_cuda.sum_wta_fused

    def spy(*vols, **kwargs):
        seen.append((len(vols), vols[0].dtype, kwargs.get("emit")))
        return fused(*vols, **kwargs)

    def plain(*a, **kwargs):
        raise AssertionError("the plain sum_wta ran on the full search")

    monkeypatch.setattr(sgm_cuda, "sum_wta_fused", spy)
    monkeypatch.setattr(sgm_cuda, "sum_wta", plain)
    _assert_matches(_port_disparity(left, right, jp, "auto"), ref)
    assert seen == [(4, dtype, emit)]


# ---------------------------------------------------------------------------
# The configurations the first slice refused, now against the reference
# ---------------------------------------------------------------------------


def _reference(left, right, jp):
    d, v = jstereo.compute_disparity(jnp.asarray(left), jnp.asarray(right), jp)
    return np.asarray(d), np.asarray(v)


@pytest.mark.parametrize("change", [
    {"mode": "hier", "num_disparities": 64},
    {"mode": "hier2", "num_disparities": 64},
    {"pack": 2},
    {"paths": 2},
    {"lr_max_diff": 1},
    {"lr_max_diff": 0},
    {"fill_invalid": True},
])
def test_out_of_slice_configurations_now_match_reference_xla(change):
    """Each configuration the first slice raised for, against the
    reference's ``impl="xla"`` with the same change."""
    hier = "mode" in change
    left, right = small_pair(48, 160, shift=21) if hier else small_pair()
    jp = dataclasses.replace(jstereo.SGMParams(num_disparities=16, lr_max_diff=-1, impl="xla"),
                             **change)
    ref = _reference(left, right, jp)
    # disp12MaxDiff 0 keeps only pixels whose subpixel offset rounds away
    assert ref[1].mean() > (0.01 if change.get("lr_max_diff") == 0 else 0.5)
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


@pytest.mark.parametrize("change", [{"impl": "pallas_interpret"}])
def test_out_of_slice_configurations_raise(change):
    p = dataclasses.replace(stereo.SGMParams(num_disparities=16, lr_max_diff=-1), **change)
    left, right = small_pair(16, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        stereo.compute_disparity(left, right, p, device="cpu")


@pytest.mark.parametrize("lr_max_diff,min_d,paths", [(1, 3, 4), (0, 3, 4), (1, 3, 2)])
def test_left_right_check_matches_reference_xla(lr_max_diff, min_d, paths):
    """The LR check with a nonzero min_disparity (the right view's index
    offset) and both path families."""
    left, right = small_pair(shift=7)
    jp = jstereo.SGMParams(num_disparities=16, min_disparity=min_d, lr_max_diff=lr_max_diff,
                           paths=paths, impl="xla")
    ref = _reference(left, right, jp)
    assert 0.01 < ref[1].mean() < 1.0  # the check invalidated some pixels
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_lr_check_and_paths2_match_reference_pallas_interpret():
    """The kernel path's LR check (right_disparity, shift_gather) and
    statistics (wta_stats_from_duals, st_from_duals) against the
    reference's Pallas kernels in interpret mode: the second interpret run
    of this file."""
    left, right = small_pair()
    jp = jstereo.SGMParams(num_disparities=16, paths=2, impl="pallas_interpret")
    ref = _reference(left, right, jp)
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


@pytest.mark.parametrize("change", [
    {"mode": "hier", "num_disparities": 64, "paths": 4, "pack": 4},
    {"mode": "hier2", "num_disparities": 64, "coarse_paths": 2, "b_decimate": 3},
])
def test_coarse_to_fine_matches_reference_xla(change):
    """``hier`` with the 4-path family, where the refine's vertical paths
    restart at the pack strips' seams; ``hier2`` with the decimated window
    B at a height that is not a multiple of 24 (the full-height stack)."""
    left, right = small_pair(64, 160, shift=23)
    jp = dataclasses.replace(jstereo.SGMParams(impl="xla"), **change)
    ref = _reference(left, right, jp)
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_fill_invalid_full_mode_matches_reference_xla():
    """The fill contract (all pixels valid) in full mode, with the LR check
    leaving holes to fill."""
    left, right = small_pair(shift=7)
    left[10:20, 30:45] = 128.0  # a flat patch the census cannot match
    jp = jstereo.SGMParams(num_disparities=16, min_disparity=2, fill_invalid=True, impl="xla")
    ref = _reference(left, right, jp)
    assert ref[1].all()
    for impl in ("xla", "auto"):
        _assert_matches(_port_disparity(left, right, jp, impl), ref)


def test_hier_within_refine_range_is_a_full_search():
    """As in the reference: hier with no more disparities than refine_range
    runs the full search."""
    left, right = small_pair(24, 48)
    p = stereo.SGMParams(num_disparities=16, lr_max_diff=-1)
    d, v = stereo.compute_disparity(left, right, p, device="cpu")
    dh, vh = stereo.compute_disparity(left, right, dataclasses.replace(p, mode="hier"),
                                      device="cpu")
    assert torch.equal(d, dh) and torch.equal(v, vh)


def test_aggregate_with_a_kernel_impl_raises():
    """The kernel impls run (tests/test_torch_parallel.py); the interpret
    impl, which has no counterpart, raises."""
    cost = torch.zeros((4, 6, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sgm.aggregate(cost, stereo.SGMParams(lr_max_diff=-1, impl="pallas_interpret"))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        stereo.compute_disparity(np.zeros((8, 8)), np.zeros((8, 8)),
                                 stereo.SGMParams(lr_max_diff=-1, impl="triton"), device="cpu")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    left, right = small_pair(16, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stereo.compute_disparity(left, right, stereo.SGMParams(lr_max_diff=-1))
