"""The core geometry and image pieces that calibration and SfM add,
against the JAX package on the CPU.

Geometry in float64 within 1e-12 relative (``triangulate`` compares
points: the eigenvector's sign cancels in the division). The image pieces
against the reference's functions run eagerly: exact, but the entropy
(summed in another order) within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.core import image as jim
from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.core import image as im

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RNG = np.random.default_rng(13)
GEOM_RTOL = 1e-12


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_se3_compose_and_inverse():
    r1, t1, r2, t2 = (RNG.normal(0, s, (5, 3)) for s in (0.6, 10.0, 0.6, 10.0))
    want = jgeom.se3_compose(*map(jnp.asarray, (r1, t1, r2, t2)))
    got = geom.se3_compose(*map(torch.from_numpy, (r1, t1, r2, t2)))
    for g, w in zip(got, want):
        assert _rel(g, w) < GEOM_RTOL
    want = jgeom.se3_inverse(jnp.asarray(r1), jnp.asarray(t1))
    got = geom.se3_inverse(torch.from_numpy(r1), torch.from_numpy(t1))
    for g, w in zip(got, want):
        assert _rel(g, w) < GEOM_RTOL


def test_project_points():
    obj = RNG.uniform([-10, -10, 30], [10, 10, 60], (4, 20, 3))
    rv, tv = RNG.normal(0, 0.3, (4, 3)), RNG.normal(0, 2.0, (4, 3))
    K = np.array([[800.0, 0, 640], [0, 790.0, 360], [0, 0, 1]])
    dist = np.array([0.08, -0.15, 0.001, -0.0005, 0.05])
    want = jgeom.project_points(jnp.asarray(obj), jnp.asarray(rv), jnp.asarray(tv),
                                jnp.asarray(K)[None], jnp.asarray(dist))
    got = geom.project_points(torch.from_numpy(obj), torch.from_numpy(rv), torch.from_numpy(tv),
                              torch.from_numpy(K)[None], torch.from_numpy(dist))
    assert got.shape == (4, 20, 2)
    assert _rel(got, want) < GEOM_RTOL


def test_two_view_geometry():
    R = np.asarray(jgeom.rodrigues(jnp.asarray([0.01, 0.04, -0.005])))
    T = np.array([-6.2, 0.05, 0.1])
    K1 = np.array([[790.0, 0, 645], [0, 792.0, 355], [0, 0, 1]])
    K2 = np.array([[810.0, 0, 635], [0, 808.0, 365], [0, 0, 1]])
    assert _rel(geom.skew(torch.from_numpy(T)), jgeom.skew(jnp.asarray(T))) == 0.0
    assert _rel(geom.essential_from_rt(torch.from_numpy(R), torch.from_numpy(T)),
                jgeom.essential_from_rt(jnp.asarray(R), jnp.asarray(T))) < GEOM_RTOL
    assert _rel(geom.fundamental_from_krt(*map(torch.from_numpy, (K1, K2, R, T))),
                jgeom.fundamental_from_krt(*map(jnp.asarray, (K1, K2, R, T)))) < GEOM_RTOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_triangulate(dtype):
    X = RNG.uniform([-2, -1.5, 4], [2, 1.5, 10], (64, 3))
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    R = np.asarray(jgeom.rodrigues(jnp.asarray([0.03, -0.05, 0.01])))
    P2 = np.concatenate([R, np.array([[0.6], [0.1], [0.2]])], 1)
    x1 = X[:, :2] / X[:, 2:]
    c2 = X @ R.T + P2[:, 3]
    x2 = c2[:, :2] / c2[:, 2:]
    args = [a.astype(dtype) for a in (P1, P2, x1, x2)]
    want = np.asarray(jgeom.triangulate(*map(jnp.asarray, args)))
    got = geom.triangulate(*map(torch.from_numpy, args)).numpy()
    # float32: the smallest eigenvector of a 4x4 AᵀA, to rounding
    assert _rel(got, want) < (GEOM_RTOL if dtype == np.float64 else 1e-4)
    if dtype == np.float64:
        assert _rel(got, X) < 1e-9
    # batched projections (the SfM app's landmark initialisation)
    Ps = np.stack([P2, P2])
    got_b = geom.triangulate(torch.from_numpy(np.stack([P1, P1])), torch.from_numpy(Ps),
                             torch.from_numpy(x1[:2]), torch.from_numpy(x2[:2]))
    assert _rel(got_b, X[:2]) < 1e-9


# ---------------------------------------------------------------------------
# image
# ---------------------------------------------------------------------------


def test_grayscale_rgb_and_hamming32():
    img = RNG.uniform(0, 255, (9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(im.grayscale_rgb(torch.from_numpy(img)).numpy(),
                                  np.asarray(jim.grayscale_rgb(jnp.asarray(img))))
    a = RNG.integers(-(2**31), 2**31, (40,), dtype=np.int64).astype(np.int32)
    b = RNG.integers(-(2**31), 2**31, (40,), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(im.hamming32(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jim.hamming32(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("shape", [(2, 17, 23), (33, 40)])
def test_sobel_exact(shape):
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    for g, w in zip(im.sobel(torch.from_numpy(img)), jim.sobel(jnp.asarray(img))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_local_normalize_and_entropy():
    img = (RNG.uniform(0, 40, (70, 90)) + np.linspace(0, 120, 90)[None]).astype(np.float32)
    np.testing.assert_array_equal(im.local_normalize(torch.from_numpy(img)).numpy(),
                                  np.asarray(jim.local_normalize(jnp.asarray(img))))
    got = float(im.shannon_entropy(torch.from_numpy(img)))
    want = float(jim.shannon_entropy(jnp.asarray(img)))
    assert abs(got - want) <= 1e-6 * abs(want)
