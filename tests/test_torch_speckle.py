"""The port's exact speckle filter against the JAX package and the native
flood fill.

``stereo.speckle_ccl`` (labels, component sizes, the filter and its
removed count) is held exactly against the reference's functions and
against ``native/speckle.cpp`` through the port's own binding
(``ops.native``): random quantised maps, the spiral that needs many
rounds, the ramp that chains into one component, a hand-built map.
``sgm.exact_speckle_postpass`` under both impls is held against the
reference's, and ``DepthPipeline(exact_speckle=True)`` against the
reference's pipeline with ``impl="xla"``: ``valid`` exact, disparity within
1e-4, depth rtol 1e-6. The binding builds into the gitignored ``build/``,
never in place of ``native/libsvnative.so``, and raises where it cannot
build.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stereovision_tpu.ops import native as jnative
from stereovision_tpu.stereo import speckle_ccl as jccl
from stereovision_tpu_torch.ops import native
from stereovision_tpu_torch.stereo import speckle_ccl as ccl

_jfilter = jccl.filter_speckles_exact
_jlabel = jax.jit(jccl.label_components)


def _spiral(n=31, gap=0):
    """A 0-valued square spiral path in a 100-valued square; ``gap`` cells
    of 100 between its arms (gap 0, the reference test's, fills the square
    solid; gap 1 is one thin component whose rows and columns alternate all
    along it)."""
    d = np.full((n, n), 100.0, np.float32)
    y = x = n // 2
    pts = [(y, x)]
    step, di = 1, 0
    moves = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    while True:
        for _ in range(2):
            dy, dx = moves[di % 4]
            for _ in range(step):
                y, x = y + dy, x + dx
                if not (0 <= y < n and 0 <= x < n):
                    break
                pts.append((y, x))
            di += 1
        step += 1 + gap
        if not (0 <= y + 1 < n and 0 <= x + 1 < n):
            break
    for yy, xx in pts:
        d[yy, xx] = 0.0
    return d, len(pts)


def _check_filter(d, new_val, max_size, max_diff):
    """The port's filter against the reference's and the native flood fill
    (the port's build of native/speckle.cpp): map and count, exact."""
    got, removed = ccl.filter_speckles_exact(torch.from_numpy(d), new_val, max_size, max_diff)
    want, removed_n = native.filter_speckles(d, new_val, max_size, max_diff)
    ref, removed_r = _jfilter(d, new_val, max_size, max_diff)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert removed.dtype == torch.int32
    assert int(removed) == removed_n == int(removed_r)
    return got.numpy(), int(removed)


def test_labels_and_sizes_of_a_hand_built_map():
    d = np.zeros((6, 8), np.float32)
    d[:, 4:] = 100.0
    d[2, 2] = 50.0
    lab = ccl.label_components(torch.from_numpy(d), 1.0)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(_jlabel(d, 1.0)))
    assert lab.dtype == torch.float32
    assert lab[0, 0] == 0 and lab[5, 3] == 0 and lab[2, 2] == 2 * 8 + 2 and lab[5, 7] == 4
    sizes = ccl.component_sizes(lab)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jccl.component_sizes(lab.numpy())))
    assert sizes.dtype == torch.int32
    assert sizes[2, 2] == 1 and sizes[0, 0] == 6 * 4 - 1 and sizes[0, 4] == 6 * 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_maps_match_reference_and_native(seed):
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 6, (48, 64)) * 3.0).astype(np.float32)
    lab = ccl.label_components(torch.from_numpy(d), 2.5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(_jlabel(d, 2.5)))
    removed = [_check_filter(d, -1.0, max_size, max_diff)[1]
               for max_size, max_diff in ((8, 2.5), (25, 3.0), (3, 0.5))]
    assert min(removed) > 0


@pytest.mark.parametrize("gap,min_rounds", [(0, 2), (1, 10)])
def test_spiral_converges_and_stays_exact(gap, min_rounds):
    d, n = _spiral(gap=gap)
    lab, rounds = ccl.label_components_counted(torch.from_numpy(d), 1.0)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(_jlabel(d, 1.0)))
    assert rounds >= min_rounds  # a round a turn or so: no iteration budget
    assert torch.unique(lab[torch.from_numpy(d) == 0.0]).numel() == 1
    got, removed = _check_filter(d, -5.0, n + 1, 1.0)
    assert removed >= n and (got[d == 0.0] == -5.0).all()


def test_ramp_chains_into_one_component():
    d = np.tile(np.arange(40, dtype=np.float32), (4, 1))
    got, removed = _check_filter(d, -1.0, 100, 1.0)
    assert removed == 0
    np.testing.assert_array_equal(got, d)
    got, removed = _check_filter(d, -1.0, 160, 1.0)
    assert removed == 160 and got.max() == -1.0
    lab, rounds = ccl.label_components_counted(torch.from_numpy(d), 1.0)
    assert (lab == 0).all() and rounds == 2


def test_labels_refuse_maps_past_float32_exactness():
    with pytest.raises(ValueError, match="2\\^24"):
        ccl.label_components(torch.zeros((4097, 4096)), 1.0)


@pytest.mark.parametrize("impl", ["device", "native"])
def test_postpass_matches_reference(impl):
    from stereovision_tpu.stereo import SGMParams as JSGMParams
    from stereovision_tpu.stereo.sgm import exact_speckle_postpass as jpost
    from stereovision_tpu_torch.stereo import SGMParams
    from stereovision_tpu_torch.stereo.sgm import exact_speckle_postpass

    rng = np.random.default_rng(7)
    d = (rng.integers(0, 5, (40, 52)) * 8.0).astype(np.float32)
    d[d < 8.0] = 1.0  # the sentinel (min_disparity − 1) forms components too
    jp = JSGMParams(min_disparity=2, speckle_window_size=20, speckle_range=4.0)
    p = SGMParams(min_disparity=2, speckle_window_size=20, speckle_range=4.0)
    dr, vr = jpost(d, jp, impl=impl)
    got, valid = exact_speckle_postpass(torch.from_numpy(d), p, impl=impl)
    assert got.dtype == torch.float32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vr))
    assert (got.numpy() == 1.0).sum() > (d == 1.0).sum()  # components were removed
    # a window of 0 only marks the sentinel
    off, v_off = exact_speckle_postpass(d, dataclasses.replace(p, speckle_window_size=0),
                                        impl=impl)
    np.testing.assert_array_equal(off.numpy(), d)
    np.testing.assert_array_equal(v_off.numpy(), d > 1.0)
    with pytest.raises(ValueError, match="impl"):
        exact_speckle_postpass(d, p, impl="approx")


def test_native_binding_builds_its_own_libraries():
    for name in ("speckle", "loader"):
        path = native.library_path(name)
        assert native.available(name), native.why_unavailable(name)
        assert path.exists() and path.parent == native.ROOT / "build" / "native"
        assert path.name.startswith(f"libsv{name}-")
    assert jnative.available()
    d = (np.random.default_rng(5).integers(0, 4, (30, 33)) * 2.0).astype(np.float32)
    np.testing.assert_array_equal(native.filter_speckles(d, -1.0, 6, 1.5)[0],
                                  jnative.filter_speckles(d, -1.0, 6, 1.5)[0])


def test_native_binding_raises_without_a_compiler(monkeypatch, tmp_path):
    """Where the reference's post-pass returns the map unfiltered, the port
    says why it cannot run."""
    from stereovision_tpu_torch.stereo import SGMParams
    from stereovision_tpu_torch.stereo.sgm import exact_speckle_postpass

    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_failed", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_cxx_version", lambda cxx: "")
    assert not native.available()
    assert "native speckle library unavailable" in native.why_unavailable()
    with pytest.raises(RuntimeError, match="native speckle library unavailable"):
        exact_speckle_postpass(np.zeros((4, 4), np.float32),
                               SGMParams(speckle_window_size=4), impl="native")


def test_pipeline_exact_speckle_matches_reference():
    """``DepthPipeline(exact_speckle=True)`` against the reference's with
    ``impl="xla"`` on a rig whose flat patch leaves speckles; the engine
    runs without its windowed stage."""
    from stereovision_tpu.pipeline import DepthPipeline as JDepthPipeline
    from stereovision_tpu.stereo import SGMParams as JSGMParams
    from stereovision_tpu_torch import convert
    from stereovision_tpu_torch.pipeline import DepthPipeline

    H, W, shift = 48, 96, 6
    K = np.array([[100.0, 0, (W - 1) / 2], [0, 100.0, (H - 1) / 2], [0, 0, 1]])
    P2 = np.hstack([K, np.zeros((3, 1))])
    P2[0, 3] = -5.0 * 100.0
    cal = {"mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5), "dist_right": np.zeros(5),
           "R": np.eye(3), "T": np.array([[-5.0], [0.0], [0.0]]), "R1": np.eye(3),
           "R2": np.eye(3), "P1": np.hstack([K, np.zeros((3, 1))]), "P2": P2,
           "Q": np.eye(4), "img_size": np.array([W, H])}
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (H, W + shift)).astype(np.float32)
    left, right = base[:, :W].copy(), base[:, shift:shift + W].copy()
    left[10:30, 40:70] = rng.integers(0, 2, (20, 30)) * 200.0  # ambiguous texture
    jp = JSGMParams(num_disparities=16, speckle_window_size=30, speckle_range=2.0, impl="xla")
    ref = JDepthPipeline(cal, jp, min_depth=0.1, max_depth=50.0, exact_speckle=True)(left, right)
    pipe = DepthPipeline(convert.calibration_from_numpy(cal, "cpu"),
                         convert.sgm_params_from_dict(dataclasses.asdict(jp)),
                         min_depth=0.1, max_depth=50.0, exact_speckle=True, device="cpu")
    assert pipe.params.speckle_window_size == 0
    res = pipe(left, right)
    np.testing.assert_array_equal(res.confidence.numpy(), np.asarray(ref.confidence))
    np.testing.assert_allclose(res.disparity.numpy(), np.asarray(ref.disparity), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(res.depth_m.numpy(), np.asarray(ref.depth_m), rtol=1e-6)
    # the filter removed something the engine had kept
    plain = DepthPipeline(convert.calibration_from_numpy(cal, "cpu"),
                          dataclasses.replace(pipe.params, speckle_window_size=0),
                          min_depth=0.1, max_depth=50.0, device="cpu")(left, right)
    assert (plain.disparity > -1).sum() > (res.disparity > -1).sum()
    # batch applies it frame by frame
    both = pipe.batch(np.stack([left, left]), np.stack([right, right]))
    assert torch.equal(both.disparity[1], res.disparity)
