"""The port's core/image and core/geometry pieces against the JAX package.

The same numpy inputs go through each reference function (jitted, on the
CPU) and its port (on the CPU). Census words, Hamming distances, window
sums and the median are exact; remap to 1e-4 (0-255 scale); the
rectification maps to 1e-5 px; depth and the point cloud to rtol 1e-6.

The fused path's pieces: ``histogram256`` counts exact; luma, the Gaussian,
bilateral and box filters, block std and the min-max normalization within
rtol 1e-5 and atol 1e-4 on a 0-255 scale (the reductions and fused
multiply-adds round in another order); ``homography_dlt`` and
``apply_homography`` within 1e-4 relative, on well-conditioned point sets
(a degenerate sample's null space has more than one dimension, and the two
``eigh`` may pick different vectors of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.core import image as jim
from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.core import image as im

RNG = np.random.default_rng(5)


def _image(h=23, w=31, lo=0.0, hi=255.0):
    return RNG.uniform(lo, hi, size=(h, w)).astype(np.float32)


@pytest.mark.parametrize("k,w", [(5, 5), (7, 5), (3, 3)])
def test_census_transform_exact(k, w):
    img = _image()
    # quantised values make ties, which the strict '<' must treat alike
    img = np.floor(img / 16).astype(np.float32)
    ref = jax.jit(jim.census_transform, static_argnums=(1, 2))(jnp.asarray(img), k, w)
    out = im.census_transform(torch.from_numpy(img), k, w)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_popcount_and_hamming_exact():
    a = RNG.integers(-(2**31), 2**31, size=(50, 3), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-(2**31), 2**31, size=(50, 3), dtype=np.int64).astype(np.int32)
    a[0] = -1
    b[0] = 0
    ref_pc = jax.jit(jim.popcount32)(jnp.asarray(a))
    ref_h = jax.jit(jim.hamming_words)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(im.popcount32(torch.from_numpy(a)).numpy(), np.asarray(ref_pc))
    np.testing.assert_array_equal(
        im.hamming_words(torch.from_numpy(a), torch.from_numpy(b)).numpy(), np.asarray(ref_h))
    assert int(im.popcount32(torch.tensor([-1], dtype=torch.int32))) == 32


def test_window_sum_exact():
    ind = (RNG.uniform(size=(29, 41)) > 0.6).astype(np.float32)
    ref = jax.jit(jim.window_sum, static_argnums=1)(jnp.asarray(ind), 15)
    np.testing.assert_array_equal(im.window_sum(torch.from_numpy(ind), 15).numpy(),
                                  np.asarray(ref))


def test_median_blur_exact():
    img = np.floor(_image() / 8).astype(np.float32)  # ties
    ref = jax.jit(jim.median_blur, static_argnums=1)(jnp.asarray(img), 5)
    np.testing.assert_array_equal(im.median_blur(torch.from_numpy(img), 5).numpy(),
                                  np.asarray(ref))
    assert im._median_pairs(25) == jim._median_pairs(25)
    assert len(im._median_pairs(25)) == 113


def test_remap_matches():
    img = _image(20, 30)
    h, w = 18, 27
    mx = RNG.uniform(-3, 32, size=(h, w)).astype(np.float32)
    my = RNG.uniform(-3, 22, size=(h, w)).astype(np.float32)
    mx[0, :3] = [-1.0, 29.0, 0.0]  # edges and out-of-image samples
    ref = jax.jit(jim.remap)(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
    out = im.remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert out[0, 0] == 0.0


def _rig():
    K = np.array([[410.0, 0, 161.3], [0, 405.0, 118.9], [0, 0, 1]])
    dist = np.array([-0.21, 0.05, 1e-3, -5e-4, 0.01])
    ang = 0.03
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    P = np.array([[400.0, 0, 158.0, -2000.0], [0, 400.0, 120.0, 0], [0, 0, 1, 0]])
    return K, dist, R, P


def test_init_undistort_rectify_map_matches():
    K, dist, R, P = _rig()
    size = (320, 240)
    rx, ry = jax.jit(jgeom.init_undistort_rectify_map, static_argnums=4)(
        jnp.asarray(K), jnp.asarray(dist), jnp.asarray(R), jnp.asarray(P), size)
    t = {k: torch.from_numpy(v) for k, v in zip("KdRP", (K, dist, R, P))}
    mx, my = geom.init_undistort_rectify_map(t["K"], t["d"], t["R"], t["P"], size)
    assert mx.dtype == torch.float32 and mx.shape == (240, 320)
    np.testing.assert_allclose(mx.numpy(), np.asarray(rx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(my.numpy(), np.asarray(ry), atol=1e-5, rtol=0)


def test_distort_and_pad_dist_match():
    xy = RNG.uniform(-0.8, 0.8, size=(40, 2))
    dist = np.array([-0.21, 0.05, 1e-3, -5e-4])
    ref = jax.jit(jgeom.distort)(jnp.asarray(xy), jnp.asarray(dist))
    out = geom.distort(torch.from_numpy(xy), torch.from_numpy(dist))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-15)
    assert geom.pad_dist(torch.from_numpy(dist)).tolist() == list(dist) + [0.0] * 4


def test_disparity_to_depth_matches():
    disp = RNG.uniform(0.5, 300, size=(12, 17)).astype(np.float32)
    ref = jax.jit(jgeom.disparity_to_depth, static_argnums=(1, 2))(jnp.asarray(disp), 700.0, 0.06)
    out = geom.disparity_to_depth(torch.from_numpy(disp), 700.0, 0.06)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_reproject_image_to_3d_matches():
    disp = RNG.uniform(1, 64, size=(12, 17)).astype(np.float32)
    Q = np.array([[1, 0, 0, -8.5], [0, 1, 0, -6.0], [0, 0, 0, 250.0], [0, 0, 0.2, 0]])
    ref = jax.jit(jgeom.reproject_image_to_3d)(jnp.asarray(disp), jnp.asarray(Q))
    out = geom.reproject_image_to_3d(torch.from_numpy(disp), torch.from_numpy(Q))
    assert out.shape == (12, 17, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# The fused path's pieces
# ---------------------------------------------------------------------------

FRNG = np.random.default_rng(11)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_grayscale_and_minmax_match():
    bgr = FRNG.uniform(0, 255, (21, 33, 3)).astype(np.float32)
    _close(im.grayscale_bgr(torch.from_numpy(bgr)), jax.jit(jim.grayscale_bgr)(jnp.asarray(bgr)))
    img = _image(19, 27)
    ref = jax.jit(jim.minmax_normalize, static_argnums=(1, 2))(jnp.asarray(img), 0.0, 255.0)
    _close(im.minmax_normalize(torch.from_numpy(img), 0.0, 255.0), ref)
    flat = np.full((5, 6), 7.0, np.float32)  # max == min: the guarded division
    ref = jax.jit(jim.minmax_normalize, static_argnums=(1, 2))(jnp.asarray(flat), 0.0, 1.0)
    _close(im.minmax_normalize(torch.from_numpy(flat), 0.0, 1.0), ref)


@pytest.mark.parametrize("ksize,sigma", [(5, 0.0), (15, 0.0), (3, 1.2), (7, 0.0)])
def test_gaussian_blur_matches(ksize, sigma):
    img = _image(24, 37)
    np.testing.assert_array_equal(im._gaussian_kernel1d(ksize, sigma),
                                  jim._gaussian_kernel1d(ksize, sigma))
    ref = jax.jit(jim.gaussian_blur, static_argnums=(1, 2))(jnp.asarray(img), ksize, sigma)
    _close(im.gaussian_blur(torch.from_numpy(img), ksize, sigma), ref)


@pytest.mark.parametrize("d", [9, 8, 5])
def test_bilateral_filter_matches(d):
    img = _image(26, 35)
    img[5:15, 10:20] += 120.0  # an edge for the range weights
    ref = jax.jit(jim.bilateral_filter, static_argnums=(1, 2, 3))(jnp.asarray(img), d, 75.0, 75.0)
    _close(im.bilateral_filter(torch.from_numpy(img), d, 75.0, 75.0), ref)


def test_box_filter_and_block_std_match():
    img = _image(101, 150)
    ref = jax.jit(jim.box_filter, static_argnums=1)(jnp.asarray(img), 15)
    _close(im.box_filter(torch.from_numpy(img), 15), ref)
    ref = jax.jit(jim.block_std, static_argnums=1)(jnp.asarray(img), 48)
    out = im.block_std(torch.from_numpy(img), 48)
    assert out.shape == (2, 3)
    _close(out, ref)


def test_histogram256_exact():
    img = FRNG.uniform(-20, 280, (37, 53)).astype(np.float32)
    img[0, :4] = [0.0, 254.999, 255.0, -0.5]  # the edges of the first and last bins
    ref = jax.jit(jim.histogram256)(jnp.asarray(img))
    out = im.histogram256(torch.from_numpy(img))
    assert out.dtype == torch.float32 and out.shape == (256,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.sum() == img.size


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_homography_dlt_and_apply_match(dtype):
    """float64: H within 1e-4 of its largest entry. float32 (the fused
    path's type): the two ``eigh`` of AᵀA differ there by up to ~1e-4 of
    the largest entry, so the points each H maps are compared (rtol 1e-4)."""
    rng = np.random.default_rng(12)
    # well-conditioned sets: four points near the corners of a 400x300
    # image (no three near a line), a mild homography, half-pixel noise
    H_true = np.array([[1.02, 0.03, 5.0], [-0.01, 0.98, -3.0], [2e-5, -1e-5, 1.0]])
    corners = np.array([[0, 0], [400, 0], [0, 300], [400, 300]], np.float64)
    src = corners[None] + rng.uniform(-40, 40, (16, 4, 2))
    dst = np.asarray(jgeom.apply_homography(jnp.asarray(H_true), jnp.asarray(src)))
    dst = dst + rng.normal(0, 0.5, dst.shape)
    pts = rng.uniform(-50, 450, (30, 2)).astype(dtype)
    for s, d in ((src, dst), (src.reshape(-1, 2)[:20], dst.reshape(-1, 2)[:20])):
        s, d = s.astype(dtype), d.astype(dtype)
        ref = np.asarray(jax.jit(jgeom.homography_dlt)(jnp.asarray(s), jnp.asarray(d)))
        out = geom.homography_dlt(torch.from_numpy(s), torch.from_numpy(d)).numpy()
        assert out.dtype == dtype
        if dtype == np.float64:
            scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
            np.testing.assert_allclose(out / scale, ref / scale, rtol=0, atol=1e-4)
        want = np.asarray(jax.jit(jgeom.apply_homography)(jnp.asarray(ref), jnp.asarray(pts)))
        got = geom.apply_homography(torch.from_numpy(ref.copy()), torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        mapped = np.asarray(jax.jit(jgeom.apply_homography)(jnp.asarray(out), jnp.asarray(pts)))
        np.testing.assert_allclose(mapped, want, rtol=1e-4, atol=1e-4)
