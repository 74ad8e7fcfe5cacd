"""The port's rectification geometry, separable remap, colormaps and
``DepthPipeline(proc_scale=…)`` against the JAX package.

In float64 (the conftest turns x64 on, so the reference computes in float64
too): ``rodrigues``/``inverse_rodrigues`` (θ near 0 and near π),
``undistort_points``, ``get_optimal_new_camera_matrix`` and
``stereo_rectify`` on the probes of the verify notes (identity R, zero
baseline: an infinite ``Q[3, 2]`` and no crash, alpha outside [0, 1]: it
clamps), within rtol 1e-12. ``remap_separable`` and ``warp_axis_shift`` (#7
``shift_gather``'s plain version here) equal the reference's jitted Pallas
form in interpret mode bit for bit, and hold the reference test's
tolerances against the exact ``remap``. ``apply_colormap`` is exact.
``DepthPipeline(proc_scale=0.5)`` against the reference's with
``impl="xla"``: the processing size, ``valid`` exact, disparity within 1e-4,
depth rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.core import image as jim
from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.core import image as im

K1 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
K2 = np.array([[305.0, 0, 158], [0, 304.0, 122], [0, 0, 1]])
D1 = np.array([-0.1, 0.01, 0.001, -0.002, 0.0])
D2 = np.array([0.05, -0.01, 0.0, 0.001, 0.001])
R_REL = np.asarray(jgeom.rodrigues(jnp.asarray([0.005, 0.02, -0.003])))
T_REL = np.array([-5.0, 0.02, 0.05])
SIZE = (320, 240)


def _close(got, want, rtol=1e-12):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("rvec", [[0.3, -0.2, 0.1], [0.0, 0.0, 0.0], [1e-8, 0.0, 0.0],
                                  [np.pi - 1e-9, 0.0, 0.0], [0.0, -np.pi, 0.0],
                                  [2.0, 1.0, -1.5]])
def test_rodrigues_round_trip_matches_reference(rvec):
    rvec = np.asarray(rvec)
    R = geom.rodrigues(torch.from_numpy(rvec))
    _close(R, jgeom.rodrigues(jnp.asarray(rvec)))
    _close(geom.inverse_rodrigues(R), jgeom.inverse_rodrigues(jnp.asarray(R.numpy())))
    batch = np.stack([rvec, 0.5 * rvec])
    _close(geom.rodrigues(torch.from_numpy(batch)), jgeom.rodrigues(jnp.asarray(batch)))


def test_undistort_points_matches_reference():
    pts = np.random.default_rng(0).uniform(0, 300, (20, 2))
    for R, P in ((None, None), (R_REL.copy(), K2)):
        got = geom.undistort_points(torch.from_numpy(pts), torch.from_numpy(K1),
                                    torch.from_numpy(D1),
                                    R=None if R is None else torch.from_numpy(R),
                                    P=None if P is None else torch.from_numpy(P))
        _close(got, jgeom.undistort_points(jnp.asarray(pts), jnp.asarray(K1), jnp.asarray(D1),
                                           R=None if R is None else jnp.asarray(R),
                                           P=None if P is None else jnp.asarray(P)))


@pytest.mark.parametrize("alpha", [0.0, 0.4, 1.0])
def test_optimal_new_camera_matrix_matches_reference(alpha):
    newK, roi = geom.get_optimal_new_camera_matrix(torch.from_numpy(K1), torch.from_numpy(D1),
                                                   SIZE, alpha)
    jK, jroi = jgeom.get_optimal_new_camera_matrix(jnp.asarray(K1), jnp.asarray(D1), SIZE, alpha)
    _close(newK, jK)
    _close(roi, jroi)


@pytest.mark.parametrize("R,T,alpha", [
    (R_REL, T_REL, -1.0), (R_REL, T_REL, 0.0), (R_REL, T_REL, 0.5), (R_REL, T_REL, 1.0),
    (R_REL, T_REL, 1.7), (R_REL, T_REL, -0.3),  # alpha outside [0, 1]
    (np.eye(3), T_REL, 0.0),                     # identity R
    (np.eye(3), np.zeros(3), 0.0),               # zero baseline
])
def test_stereo_rectify_matches_reference(R, T, alpha):
    got = geom.stereo_rectify(K1, D1, K2, D2, SIZE, R, T, alpha=alpha)
    want = jgeom.stereo_rectify(jnp.asarray(K1), jnp.asarray(D1), jnp.asarray(K2),
                                jnp.asarray(D2), SIZE, jnp.asarray(R), jnp.asarray(T),
                                alpha=alpha)
    for g, w in zip(got, want):
        _close(g, w)
    Q = got[4]
    if not T.any():
        assert Q[3, 2] == -np.inf
    if alpha > 1.0:  # clamps to 1
        _close(got[2], np.asarray(geom.stereo_rectify(K1, D1, K2, D2, SIZE, R, T,
                                                      alpha=1.0)[2]))


def _maps_case(case, H=64, W=200):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if case == "row_constant":
        mx, my = xx + 2.25, yy + 3.5 * np.sin(yy / 11.0)[:, :1] * np.ones((1, W))
    else:  # large horizontal displacement, zoom, a 2-D vertical component
        mx, my = 1.12 * xx + 4.0 * np.sin(yy / 23.0) - 11.0, yy + 3.0 * np.cos(xx / 37.0) - 0.7
    return mx.astype(np.float32), my.astype(np.float32)


@pytest.mark.parametrize("case", ["row_constant", "two_d"])
def test_remap_separable_matches_reference_and_exact_remap(case):
    """The reference test's maps (tests/test_image.py:147-188): bit for bit
    against the reference's jitted Pallas form in interpret mode, and its
    tolerances against the exact remap."""
    rng = np.random.default_rng(31)
    img = np.cumsum(rng.uniform(-3, 3, (64, 200)), axis=1).astype(np.float32)
    mx, my = _maps_case(case)
    prep = im.prepare_separable_remap(torch.from_numpy(mx), torch.from_numpy(my))
    jprep = jim.prepare_separable_remap(mx, my)
    for a, b in zip(prep, jprep):
        np.testing.assert_array_equal(a, b)
    my_adj, valid, rx, ry = prep
    got = im.remap_separable(torch.from_numpy(img), torch.from_numpy(mx),
                             torch.from_numpy(my_adj), torch.from_numpy(valid), rx, ry).numpy()
    ref = jax.jit(lambda a, b, c, d: jim.remap_separable(a, b, c, d, rx, ry, interpret=True))(
        img, mx, my_adj, valid)
    np.testing.assert_array_equal(got, np.asarray(ref))
    exact = im.remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
    np.testing.assert_array_equal(got == 0.0, exact == 0.0)
    if case == "row_constant":
        np.testing.assert_allclose(got, exact, atol=1e-3)
    else:
        assert np.median(np.abs(got - exact)[exact != 0.0]) < 0.2


def test_warp_axis_shift_matches_reference():
    rng = np.random.default_rng(3)
    src = np.cumsum(rng.uniform(-3, 3, (40, 150)), axis=1).astype(np.float32)
    off = rng.uniform(-9, 9, (40, 150)).astype(np.float32)  # some past R: clipped
    ref = jax.jit(lambda a, b: jim.warp_axis_shift(a, b, 8, interpret=True))(src, off)
    got = im.warp_axis_shift(torch.from_numpy(src), torch.from_numpy(off), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_prepare_separable_remap_refuses_what_it_cannot_take():
    mx, my = _maps_case("row_constant")
    # decreasing along x, nothing in the image, a displacement past 96
    for bad in (mx[:, ::-1].copy(), mx + 200.0, mx * 2.5):
        assert im.prepare_separable_remap(bad, my) is None
        assert jim.prepare_separable_remap(bad, my) is None


@pytest.mark.parametrize("cmap", ["turbo", "jet"])
@pytest.mark.parametrize("bgr", [True, False])
def test_apply_colormap_matches_reference(cmap, bgr):
    u8 = np.random.default_rng(2).integers(0, 256, (7, 9)).astype(np.uint8)
    u8[0, :3] = (0, 128, 255)
    got = im.apply_colormap(torch.from_numpy(u8), cmap, bgr)
    assert got.shape == (7, 9, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jim.apply_colormap(jnp.asarray(u8), cmap, bgr)))


def test_pipeline_proc_scale_matches_reference():
    """A 192×128 rig with distortion and a small relative rotation,
    processed at half size (96×64): the calibration is rescaled and
    rectified anew, as in the reference."""
    from stereovision_tpu.pipeline import DepthPipeline as JDepthPipeline
    from stereovision_tpu.pipeline import _rescale_calibration as jrescale
    from stereovision_tpu.stereo import SGMParams as JSGMParams
    from stereovision_tpu_torch import convert
    from stereovision_tpu_torch.pipeline import DepthPipeline, _rescale_calibration

    W, H = 192, 128
    K = np.array([[180.0, 0, 95.0], [0, 181.0, 64.5], [0, 0, 1]])
    d0 = np.array([-0.05, 0.01, 0.0, 0.0, 0.0])
    T = np.array([-6.0, 0.01, 0.02])
    R1, R2, P1, P2, Q = jgeom.stereo_rectify(jnp.asarray(K), jnp.asarray(d0), jnp.asarray(K),
                                             jnp.asarray(d0), (W, H), jnp.asarray(R_REL),
                                             jnp.asarray(T), alpha=0.0)
    cal = {"mtx_left": K, "mtx_right": K, "dist_left": d0, "dist_right": d0, "R": R_REL,
           "T": T.reshape(3, 1), "R1": np.asarray(R1), "R2": np.asarray(R2),
           "P1": np.asarray(P1), "P2": np.asarray(P2), "Q": np.asarray(Q),
           "img_size": np.array([W, H])}
    proc, rescaled = _rescale_calibration(cal, 0.5)
    jproc, jrescaled = jrescale(cal, 0.5)
    assert proc == jproc == (96, 64)
    for key in ("mtx_left", "mtx_right", "R1", "R2", "P1", "P2", "Q", "img_size"):
        np.testing.assert_allclose(rescaled[key], np.asarray(jrescaled[key]), rtol=1e-12,
                                   atol=1e-12)
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 255, (H, W + 16)).astype(np.float32)
    left, right = base[:, :W].copy(), base[:, 16:16 + W].copy()
    jp = JSGMParams(num_disparities=16, impl="xla")
    ref = JDepthPipeline(cal, jp, min_depth=0.1, max_depth=50.0, proc_scale=0.5)(left, right)
    pipe = DepthPipeline(convert.calibration_from_numpy(cal, "cpu"),
                         convert.sgm_params_from_dict(dataclasses.asdict(jp)),
                         min_depth=0.1, max_depth=50.0, proc_scale=0.5, device="cpu")
    assert pipe.size == (W, H) and pipe.proc_size == (96, 64)
    assert pipe.focal == pytest.approx(float(np.asarray(jrescaled["P1"])[0, 0]), rel=1e-12)
    res = pipe(left, right)
    assert res.disparity.shape == (64, 96)
    np.testing.assert_array_equal(res.confidence.numpy(), np.asarray(ref.confidence))
    np.testing.assert_allclose(res.disparity.numpy(), np.asarray(ref.disparity), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(res.depth_m.numpy(), np.asarray(ref.depth_m), rtol=1e-6)
    assert res.confidence.mean() > 0.5
