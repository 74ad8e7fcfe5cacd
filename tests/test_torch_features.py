"""The port's sparse features and two-view geometry against the JAX
package on the CPU.

- Harris: points and scores exact against the reference run eagerly
  (``jax.disable_jit``), live and dead slots alike. Compiled, XLA fuses the
  response's products into adds, which moves scores by ulps and breaks the
  exact ties of a plateau otherwise (ROADMAP.md §3).
- HOG: within 1e-5 on a smooth texture. On the checker rig, whose
  axis-aligned blobs put gradients at exactly 135°, a bin edge, the last
  ulp of the angle decides the bin (XLA's ``atan2`` and torch's differ in
  it, and so do the reference's compiled and eager forms): the
  descriptors whose patches hold no pixel binned apart are within 1e-5,
  and those that do differ (pinned, ROADMAP.md §3).
- Matches exact on a texture; the 8-point hypotheses, RANSAC and the pose in float64
  with the reference's ``jax.random.choice`` draws handed to the port
  through ``mono.features.draw_samples``: E equal up to sign (1e-9), the
  inlier mask equal, R and t within 1e-5, points within 1e-4 relative.
  In float32 the minimal 8-point systems are too ill-conditioned for two
  libraries to agree (their ``eigh`` differ by 1e-2 on a hypothesis); the
  reference's own tests and apps run them in float64 (x64), and the SfM
  app's coordinates are float64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.mono import features as jf
from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.mono import features as pf

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RNG = np.random.default_rng(52)


class ReferenceChoice:
    """Replaces ``mono.features.draw_samples``: the reference's
    ``jax.random.choice`` draws from ``key``, one key a call, in order."""

    def __init__(self, *keys):
        self.keys = list(keys)

    def __call__(self, generator, probs, n_hyp):
        key = self.keys.pop(0)
        idx = jax.random.choice(key, probs.shape[0], shape=(n_hyp, 8),
                                p=jnp.asarray(probs.cpu().numpy()))
        return torch.from_numpy(np.array(idx, np.int64))


def _checker_scene(seed, h=240, w=320, n_blobs=120):
    """``tests/test_features.py``'s checker scene (axis-aligned blobs, a 3x3
    blur) from its own seed."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.full((h, w), 80.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(10, h - 14), rng.integers(10, w - 14)
        sz = rng.integers(3, 9)
        img[y:y + sz, x:x + sz] = rng.uniform(0, 255)
    return cv2.GaussianBlur(img, (3, 3), 0.8)


def _texture(h, w, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    return {"checker": _checker_scene(51), "texture": _texture(200, 260, 3)}


@pytest.mark.parametrize("name", ["checker", "texture"])
def test_harris_exact_against_the_eager_reference(scenes, name):
    img = scenes[name]
    with jax.disable_jit():
        pts_ref, s_ref = jf.harris_corners(jnp.asarray(img), 256)
    pts, s = pf.harris_corners(torch.from_numpy(img), 256)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(pts_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert (s.numpy() > 0).sum() > 50


def test_harris_batches_and_keeps_the_top_k_order(scenes):
    stack = torch.from_numpy(np.stack([scenes["checker"], scenes["checker"][::-1].copy()]))
    pts, s = pf.harris_corners(stack, 128)
    for i in range(2):
        p1, s1 = pf.harris_corners(stack[i], 128)
        assert torch.equal(pts[i], p1) and torch.equal(s[i], s1)
    # jax.lax.top_k's order: by value, ties (and the -inf tail) by the lower index
    x = np.random.default_rng(0).integers(0, 4, 300).astype(np.float32)
    x[::5] = -np.inf
    v, i = jax.lax.top_k(jnp.asarray(x), 200)
    v2, i2 = pf._top_k(torch.from_numpy(x), 200)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v))


def test_hog_on_a_smooth_texture(scenes):
    img = scenes["texture"]
    pts, _ = pf.harris_corners(torch.from_numpy(img), 128)
    want = np.asarray(jf.hog_descriptors(jnp.asarray(img), jnp.asarray(pts.numpy())))
    got = pf.hog_descriptors(torch.from_numpy(img), pts).numpy()
    assert got.shape == (128, 128)
    assert np.abs(got - want).max() < 1e-5


def test_hog_on_the_checker_rig_differs_only_at_bin_edges(scenes):
    img = scenes["checker"]
    pts, _ = pf.harris_corners(torch.from_numpy(img), 128)
    want = np.asarray(jf.hog_descriptors(jnp.asarray(img), jnp.asarray(pts.numpy())))
    got = pf.hog_descriptors(torch.from_numpy(img), pts).numpy()
    # the pixels whose orientation bin differs: the reference's compiled
    # expression against the port's (the reference's own eager bins differ
    # from its compiled ones there too)
    gx, gy = im.sobel(torch.from_numpy(img))
    ref_bins = jax.jit(lambda x, y: jnp.floor((jnp.arctan2(y, x) + jnp.pi) / (2 * jnp.pi) * 8)
                       .astype(jnp.int32) % 8)(jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy()))
    two_pi = torch.full((), 2 * math.pi, dtype=torch.float32)
    bins = torch.floor((torch.atan2(gy, gx) + math.pi) / two_pi * 8).to(torch.int64) % 8
    flip = (np.asarray(ref_bins) != bins.numpy()) & (im.hypot(gx, gy).numpy() > 0)
    p = pts.numpy().astype(np.int64)
    touched = np.array([flip[max(y - 8, 0):y + 8, max(x - 8, 0):x + 8].any() for x, y in p])
    err = np.abs(got - want).max(axis=1)
    assert touched.sum() > 0 and (~touched).sum() > 0
    assert err[~touched].max() < 1e-5
    assert err[touched].max() > 1e-3  # a bin moved: pinned (ROADMAP.md §3)


def test_match_descriptors_exact():
    """On a texture moved by (7, 4) px. (On the checker rig, whose blobs
    repeat, equal descriptors tie; the reference's float32 product and the
    port's float64 one rounded to float32 break such ties apart.)"""
    big = _texture(250, 340, 8)
    img, img2 = big[:240, :320].copy(), big[4:244, 7:327].copy()
    stack = torch.from_numpy(np.stack([img2, img]))
    pts, s = pf.harris_corners(stack, 256)
    d = pf.hog_descriptors(stack, pts)
    idx, valid = pf.match_descriptors(d[0], d[1], s[0], s[1])
    idx_ref, valid_ref = jf.match_descriptors(*(jnp.asarray(t.numpy()) for t in (d[0], d[1], s[0],
                                                                                  s[1])))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    dxy = (pts[1].numpy()[idx.numpy()] - pts[0].numpy())[valid.numpy()]
    assert valid.sum() > 40 and abs(np.median(dxy[:, 0]) - 7) < 0.6


def _two_view(seed=51, n=256, noise=5e-4):
    """``tests/test_features.py``'s two-view rig from its own seed, float64."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jgeom.rodrigues(jnp.asarray([0.03, -0.05, 0.01])))
    t = np.array([0.6, 0.1, 0.2]) / np.linalg.norm([0.6, 0.1, 0.2])
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 10], (n, 3))
    c2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    x2 = c2[:, :2] / c2[:, 2:] + rng.normal(0, noise, (n, 2))
    return R, t, X, x1, x2


def test_essential_8pt_hypotheses():
    _, _, _, x1, x2 = _two_view()
    # eight distinct points a hypothesis (a repeated one leaves a null space
    # of more than one dimension, where two eigh may pick different vectors)
    idx = np.stack([RNG.permutation(len(x1))[:8] for _ in range(64)])
    want = np.asarray(jf._essential_from_8pt(jnp.asarray(x1)[idx], jnp.asarray(x2)[idx]))
    got = pf._essential_from_8pt(torch.from_numpy(x1)[idx], torch.from_numpy(x2)[idx]).numpy()
    sign = np.sign((want * got).sum(axis=(1, 2)))[:, None, None]
    assert np.abs(got * sign - want).max() < 1e-6


def test_ransac_and_pose_with_the_reference_draws(monkeypatch):
    R, t, X, x1, x2 = _two_view()
    valid = np.ones(len(x1), bool)
    valid[::11] = False
    key = jax.random.PRNGKey(0)
    E_ref, inl_ref = jf.ransac_essential(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    monkeypatch.setattr(pf, "draw_samples", ReferenceChoice(key))
    E, inl = pf.ransac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                                 torch.from_numpy(valid), torch.Generator())
    E, E_ref = E.numpy(), np.asarray(E_ref)
    assert np.abs(E * np.sign((E * E_ref).sum()) - E_ref).max() < 1e-9
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
    assert inl.sum() > 200
    want = jf.recover_pose_and_triangulate(jnp.asarray(E_ref), jnp.asarray(x1), jnp.asarray(x2),
                                           inl_ref)
    got = pf.recover_pose_and_triangulate(torch.from_numpy(E_ref), torch.from_numpy(x1),
                                          torch.from_numpy(x2), inl)
    (Rg, tg, Xg, gg), (Rw, tw, Xw, gw) = [[np.asarray(v) for v in o] for o in (got, want)]
    assert np.abs(Rg - Rw).max() < 1e-5 and np.abs(tg - tw).max() < 1e-5
    assert np.abs(Xg - Xw).max() < 1e-4 * np.abs(Xw).max()
    np.testing.assert_array_equal(gg, gw)
    np.testing.assert_allclose(Rg, R, atol=5e-3)


def test_sparse_motion_depth_with_the_reference_draws(monkeypatch):
    """The whole pipeline on a two-plane texture (float64 through K):
    every output against the reference's, then the reference test's checks
    of the truth."""
    far, near = _texture(240, 340, 5), _texture(80, 100, 6)
    img, img2 = far[:, :320].copy(), far[:, 4:324].copy()
    img[80:160, 110:210] = near
    img2[80:160, 98:198] = near
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    key = jax.random.PRNGKey(1)
    ref = jf.sparse_motion_depth(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(K), key)
    monkeypatch.setattr(pf, "draw_samples", ReferenceChoice(key))
    got = pf.sparse_motion_depth(img, img2, torch.from_numpy(K), torch.Generator(), device="cpu")
    for k in ("pts_prev", "pts_curr", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("R", "t_unit"):
        g, w = got[k].numpy(), np.asarray(ref[k])
        assert np.abs(g - w).max() < 1e-5, k
    v = got["valid"].numpy()
    g, w = got["points3d"].numpy()[v], np.asarray(ref["points3d"])[v]
    assert np.abs(g - w).max() < 1e-4 * np.abs(w).max()
    assert v.sum() > 20 and abs(got["t_unit"][0]) > 0.9


def test_draw_samples():
    probs = torch.zeros(50)
    probs[[3, 17, 40]] = 1 / 3
    idx = pf.draw_samples(torch.Generator().manual_seed(0), probs, 64)
    assert idx.shape == (64, 8) and idx.dtype == torch.int64
    assert set(idx.unique().tolist()) <= {3, 17, 40}
    again = pf.draw_samples(torch.Generator().manual_seed(0), probs, 64)
    assert torch.equal(idx, again)
    none = pf.draw_samples(torch.Generator().manual_seed(0), torch.zeros(50), 16)
    assert none.shape == (16, 8) and int(none.max()) < 50


def test_features_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    img = np.zeros((40, 40), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pf.sparse_motion_depth(img, img, np.eye(3), torch.Generator())
