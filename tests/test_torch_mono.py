"""The port's ``mono`` flow, ego-motion and motion-depth against the JAX
package's.

``dense_flow`` with the gather warp within 1e-3 px (the expected ego-flow
too, and the points a RANSAC homography maps). ``ransac_homography``,
``estimate_ego_motion`` and three ``flow_depth_step`` frames run with the
reference's own hypotheses: ``jax.random.split``/``randint`` from the same
seed, in the reference's order, handed to the port by replacing its one
draw function (``mono.ego.draw_hypotheses``). ``has_depth`` and
``camera_moving`` exact; depth within rtol 1e-4 and atol 1e-4 (it is at
most 2); inlier masks equal except at points whose error
lies within 1e-4 of the threshold. The separable ``"shift"`` warp (two #7
launches a pass; their plain version here) is held against the gather as
the reference's own tests hold it (``tests/test_mono.py``).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereovision_tpu.mono as jm
from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu_torch import mono as tm
from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.mono import ego, flow

RNG = np.random.default_rng(17)


def textured(h=120, w=160):
    img = RNG.uniform(0, 255, size=(h, w)).astype(np.float32)
    return cv2.GaussianBlur(img, (7, 7), 1.5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def reference_draws(monkeypatch):
    """Feed the port the reference's hypotheses: ``feed(draws)`` queues
    (n_hyp, 4) index arrays, taken one a call of ``draw_hypotheses``."""
    queue = []

    def draw(generator, n_hyp, n):
        idx = queue.pop(0)
        assert idx.shape == (n_hyp, 4) and idx.max() < n
        return torch.from_numpy(np.array(idx, np.int64))

    monkeypatch.setattr(ego, "draw_hypotheses", draw)
    yield queue.append
    assert not queue, "draws left over"


def _jax_draws(key, n, n_hyp=512):
    return np.asarray(jax.random.randint(key, (n_hyp, 4), 0, n))


def _flow_pair(kind):
    if kind == "zero":
        img = textured()
        return img, img
    # a (3, -2) px translation cut from a wider texture: curr[p + (3, -2)]
    # = prev[p], with texture everywhere (cv2.warpAffine, as the reference
    # test makes it, fills bands with zeros, where LK is near singular and
    # the two libraries' last-ulp roundings grow past 1e-3 px)
    big = textured(124, 166)
    prev, curr = big[0:120, 3:163], big[2:122, 0:160]
    return prev, curr


@pytest.mark.parametrize("kind", ["translation", "zero"])
def test_dense_flow_gather_matches(kind):
    prev, curr = _flow_pair(kind)
    ref = np.asarray(jm.dense_flow(jnp.asarray(prev), jnp.asarray(curr), warp_impl="gather"))
    got = tm.dense_flow(_t(prev), _t(curr), warp_impl="gather", device="cpu").numpy()
    assert got.shape == prev.shape + (2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    auto = tm.dense_flow(_t(prev), _t(curr), device="cpu").numpy()
    np.testing.assert_array_equal(auto, got)  # "auto" is the gather
    inner = np.s_[20:-20, 20:-20]
    if kind != "zero":
        assert abs(np.median(got[inner][..., 0]) - 3.0) < 0.3
        assert abs(np.median(got[inner][..., 1]) + 2.0) < 0.3
    else:
        assert np.abs(got).max() < 0.1


def test_warp_impl_shift_interpret_raises():
    img = textured(32, 48)
    with pytest.raises(NotImplementedError, match="no counterpart"):
        tm.dense_flow(_t(img), _t(img), warp_impl="shift_interpret", device="cpu")
    with pytest.raises(ValueError, match="warp_impl"):
        tm.FlowDepthParams(warp_impl="nearest")


def _correspondences(kind):
    if kind == "outliers":
        H_true = np.array([[1.01, 0.02, 4.0], [-0.015, 0.99, -2.0], [1e-5, -1e-5, 1.0]])
        src = RNG.uniform(0, 300, size=(200, 2))
        dst = np.array(jgeom.apply_homography(jnp.asarray(H_true), jnp.asarray(src)))
        dst += RNG.normal(0, 0.3, dst.shape)
        out_idx = RNG.choice(200, 60, replace=False)
        dst[out_idx] += RNG.uniform(-80, 80, (60, 2))
    else:  # the cv2 comparison's set: few, far outliers
        H_true = np.array([[1.0, 0.01, 2.0], [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]])
        src = RNG.uniform(0, 300, size=(150, 2))
        dst = np.array(jgeom.apply_homography(jnp.asarray(H_true), jnp.asarray(src)))
        out_idx = RNG.choice(150, 30, replace=False)
        dst[out_idx] += RNG.uniform(30, 60, (30, 2))
    return src.astype(np.float32), dst.astype(np.float32)


def _masks_agree(got_mask, ref_mask, H, src, dst, threshold=3.0):
    differ = got_mask != ref_mask
    if differ.any():  # only where the error sits on the threshold
        proj = np.asarray(jgeom.apply_homography(jnp.asarray(H), jnp.asarray(src)))
        err = np.sqrt(((proj - dst) ** 2).sum(-1))
        assert np.all(np.abs(err[differ] - threshold) < 1e-4), err[differ]


@pytest.mark.parametrize("kind,seed", [("outliers", 0), ("few_outliers", 1)])
def test_ransac_homography_matches(reference_draws, kind, seed):
    src, dst = _correspondences(kind)
    key = jax.random.PRNGKey(seed)
    reference_draws(_jax_draws(key, src.shape[0]))
    H_r, m_r, n_r = jm.ransac_homography(jnp.asarray(src), jnp.asarray(dst), key)
    H, mask, n = tm.ransac_homography(_t(src), _t(dst), torch.Generator(), device="cpu")
    H_r = np.asarray(H_r)
    # the refits solve float32 AᵀA of ~100 points, whose two eigh agree to
    # ~1e-4 of H's largest entry: the points each H maps, within 1e-3 px
    mapped = [np.asarray(jgeom.apply_homography(jnp.asarray(h), jnp.asarray(src)))
              for h in (H.numpy(), H_r)]
    np.testing.assert_allclose(mapped[0], mapped[1], rtol=0, atol=1e-3)
    _masks_agree(mask.numpy(), np.asarray(m_r), H_r, src, dst)
    assert abs(int(n) - int(n_r)) <= int((mask.numpy() != np.asarray(m_r)).sum())
    assert int(n) > 100


@pytest.mark.parametrize("kind", ["pan", "object"])
def test_estimate_ego_motion_matches(reference_draws, kind):
    h, w = 128, 160
    fl = np.zeros((h, w, 2), np.float32)
    fl[..., 0] = 2.5 if kind == "pan" else 1.0
    if kind == "object":
        fl[40:70, 50:90, 0] = 6.0
    key = jax.random.PRNGKey(0)
    reference_draws(_jax_draws(key, (h // 16) * (w // 16)))
    v_r, e_r = jm.estimate_ego_motion(jnp.asarray(fl), key)
    v, e = tm.estimate_ego_motion(_t(fl), torch.Generator(), device="cpu")
    assert v.dtype == torch.bool and bool(v) == bool(v_r)
    # the refits' float32 eigh: H to ~1e-4 of its largest entry, the
    # expected flow within 1e-3 px (the flow's own tolerance)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=0, atol=1e-3)
    if kind == "pan":
        np.testing.assert_allclose(e.numpy()[..., 0], 2.5, atol=0.05)
    else:
        resid = np.abs(fl[..., 0] - e.numpy()[..., 0])
        assert resid[50:60, 60:80].mean() > 3.0 and resid[:30, :30].mean() < 0.5


def _sequence(n=4, h=96, w=128):
    """A camera pan of 2 px a frame (cut from a wider texture) with a near
    object moving 4 px a frame against it."""
    big = textured(h, w + 2 * n)
    s0 = 2 * n
    frames = []
    for i in range(n):
        frame = big[:, s0 - 2 * i:s0 - 2 * i + w].copy()
        frame[30:60, 40:80] = np.roll(frame[30:60, 40:80], 4 * i, axis=1)
        frames.append(frame)
    return frames


@pytest.mark.parametrize("scene", ["moving", "static"])
def test_flow_depth_steps_match(reference_draws, scene):
    """Frame 0 primes the state; then three frames (a camera pan with a
    near object moving apart, or the same frame again)."""
    frames = _sequence() if scene == "moving" else [textured(96, 128)] * 4
    img = frames[0]
    n = (96 // 16) * (128 // 16)
    rng = jax.random.PRNGKey(0)
    for _ in frames:
        rng, sub = jax.random.split(rng)
        reference_draws(_jax_draws(sub, n))
    params, jparams = tm.FlowDepthParams(warp_impl="gather"), jm.FlowDepthParams(warp_impl="gather")
    st, jst = tm.flow_depth_init(img.shape, device="cpu"), jm.flow_depth_init(img.shape)
    for k, frame in enumerate(frames):
        t = 0.1 * k
        jst, jd, jhas, jmv = jm.flow_depth_step(jst, jnp.asarray(frame), jnp.float32(t), jparams)
        st, d, has, mv = tm.flow_depth_step(st, _t(frame), t, params, device="cpu")
        assert bool(has) == bool(jhas) and bool(mv) == bool(jmv), k
        assert has.dtype == torch.bool and mv.dtype == torch.bool
        # depth = 1/(residual + 0.5) ≤ 2: rtol 1e-4 and atol 1e-4 (the
        # float32 ego-motion moves a residual by ~1e-4 px)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(st.stable_depth.numpy(), np.asarray(jst.stable_depth),
                                   rtol=1e-4, atol=1e-4)
        assert float(st.last_move_time) == float(jst.last_move_time)
        assert bool(st.has_stable) == bool(jst.has_stable)
    assert bool(has)
    if scene == "moving":
        assert bool(mv) and d.numpy()[40:55, 50:75].mean() < d.numpy()[5:20, 5:30].mean()


def test_flow_depth_generator_draws_on_its_own():
    """Without the reference's draws the port draws from the state's
    generator: the same seed gives the same frame, and it still finds the
    pan."""
    frames = _sequence(3)
    img = frames[0]
    outs = []
    for _ in range(2):
        st = tm.flow_depth_init(img.shape, seed=5, device="cpu")
        for k, frame in enumerate(frames):
            st, d, has, mv = tm.flow_depth_step(st, _t(frame), 0.1 * k, device="cpu")
        outs.append(d)
    assert bool(has) and bool(mv)
    assert torch.equal(outs[0], outs[1])


# -- the separable warp (#7), as the reference's own tests hold it -------------

def test_axis_constant_shift_exact():
    img = np.random.default_rng(3).uniform(0, 255, (8, 200)).astype(np.float32)
    for shift in (0.0, 1.0, -1.0, 2.5, -2.5, -31.0, 30.5):
        out = im.warp_axis_shift(_t(img), torch.full((8, 200), shift), 32).numpy()
        xs = np.clip(np.arange(200) + shift, 0, 199)
        x0 = np.floor(xs).astype(int)
        f = (xs - x0).astype(np.float32)
        x1 = np.minimum(x0 + 1, 199)
        np.testing.assert_allclose(out, img[:, x0] * (1 - f) + img[:, x1] * f, atol=1e-3)


def test_warp_separable_matches_reference_and_bilinear():
    from stereovision_tpu.mono.flow import warp_separable as jwarp

    rng = np.random.default_rng(4)
    H, W = 48, 160
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    v = np.tile(rng.uniform(-4, 4, (H, 1)).astype(np.float32), (1, W))
    u = rng.uniform(-4, 4, (H, W)).astype(np.float32)
    fl = np.stack([u, v], -1)
    sep = flow.warp_separable(_t(img), _t(fl)).numpy()
    ref = np.asarray(jax.jit(jwarp, static_argnames=("R", "interpret"))(
        jnp.asarray(img), jnp.asarray(fl), interpret=True))
    np.testing.assert_allclose(sep, ref, rtol=0, atol=1e-4)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    exact = im._bilinear_gather(_t(img), _t(xs + u), _t(ys + v)).numpy()
    assert np.abs(sep - exact)[6:-6, 6:-6].max() < 1e-2


def test_dense_flow_shift_recovers_translation():
    img = textured(128, 192)
    prev, curr = _t(img[:, :160]), _t(img[:, 3:163])
    f = tm.dense_flow(prev, curr, warp_impl="shift", device="cpu")
    med = float(f[10:-10, 10:-10, 0].median())
    assert abs(med - (-3.0)) < 0.25, med
    fg = tm.dense_flow(prev, curr, warp_impl="gather", device="cpu")
    assert float((f - fg).abs()[10:-10, 10:-10].median()) < 0.2


def test_mono_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.flow_depth_init((8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.dense_flow(np.zeros((8, 8)), np.zeros((8, 8)))
