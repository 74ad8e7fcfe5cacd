"""The port's ``parallel/`` package and the three kernels it brings in
(``aggregate_dual``'s chain mode, ``aggregate_dir``, ``wta``), against the
JAX package on the CPU.

The reference runs on the conftest's eight virtual CPU devices; the port's
mesh is ``["cpu"] * 8`` (or a part of it), so every wrapper runs its plain
version. The same numpy inputs go to both:

- ``sharded_disparity``, ``sharded_disparity_exact`` and
  ``sharded_disparity_exact_pipelined`` with ``impl="xla"`` and with the
  kernel impl, held at atol=0 (``valid`` equal) against the JAX function
  with ``impl="xla"`` at the reference tests' shapes (and
  ``production_preset()``, whose census fill reaches across tile seams, at
  atol=1e-4), and against the port's single-device ``compute_disparity``:
  exactly for the exact engine and frame parallelism, to the reference's
  seam tolerance for row tiles of the approximate engine;
- chain-mode ``aggregate_dual``, ``aggregate_dir`` and ``wta`` against the
  reference's Pallas kernels in interpret mode, exactly (small integers in
  float32);
- ``sgm.aggregate`` and ``sgm._wta`` with a kernel impl against the
  reference's ``impl="pallas_interpret"`` and ``impl="xla"``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu import parallel as jparallel
from stereovision_tpu.ops import sgm_pallas
from stereovision_tpu.stereo import SGMParams as JParams
from stereovision_tpu.stereo import sgm as jsgm
from stereovision_tpu_torch import parallel
from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.parallel import mesh as pmesh
from stereovision_tpu_torch.stereo import SGMParams, compute_disparity, production_preset, sgm


def pair_batch(seed, b, h, w, shift=5):
    base = np.random.default_rng(seed).uniform(0, 255, size=(b, h, w + shift)).astype(np.float32)
    return base[:, :, :w].copy(), base[:, :, shift:shift + w].copy()


_SMALL = dict(lr_max_diff=-1, speckle_window_size=0, median_ksize=3)
# production_preset() at 64 disparities, as changes of the defaults
_PRODUCTION = dataclasses.asdict(dataclasses.replace(production_preset(), num_disparities=64))
del _PRODUCTION["impl"]
# name: (function, batch, height, width, shift, frame, tile, SGMParams changes);
# the shapes and meshes of tests/test_parallel.py, and the production
# preset on 2×2 (48-row frames: 70-row haloed slabs, the sequential refine)
CASES = {
    "approx_frames": ("sharded_disparity", 8, 48, 96, 5, 8, 1, {}),
    "approx_tiles": ("sharded_disparity", 2, 96, 96, 5, 2, 4, dict(speckle_window_size=0)),
    "approx_hier": ("sharded_disparity", 2, 128, 96, 5, 2, 2,
                    dict(num_disparities=40, mode="hier", coarse_scale=2, refine_range=16,
                         speckle_window_size=0)),
    "approx_production": ("sharded_disparity", 2, 48, 192, 5, 2, 2, _PRODUCTION),
    "exact": ("sharded_disparity_exact", 2, 96, 96, 5, 2, 4, {}),
    "exact_small": ("sharded_disparity_exact", 2, 64, 80, 4, 2, 2, _SMALL),
    "pipelined": ("sharded_disparity_exact_pipelined", 6, 96, 96, 5, 2, 4, {}),
    "pipelined_one_frame": ("sharded_disparity_exact_pipelined", 1, 64, 80, 4, 1, 4, _SMALL),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The case's inputs and the JAX function's (disp, valid) with
    impl="xla" on the virtual mesh (computed once per case)."""
    fn, b, h, w, shift, frame, tile, change = CASES[case]
    left, right = pair_batch(sorted(CASES).index(case), b, h, w, shift)
    jp = dataclasses.replace(JParams(num_disparities=16, impl="xla"), **change)
    mesh = jparallel.make_mesh(frame=frame, tile=tile,
                               devices=jax.devices()[:frame * tile])
    if fn == "sharded_disparity":
        d, v = jparallel.sharded_disparity(jnp.asarray(left), jnp.asarray(right), jp, mesh)
    else:
        d, v = getattr(jparallel, fn)(left, right, jp, mesh)
    return left, right, np.asarray(d), np.asarray(v)


def _port_params(case, impl):
    change = CASES[case][7]
    return dataclasses.replace(SGMParams(num_disparities=16, impl=impl), **change)


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_reference_and_single_device(case, impl):
    fn, b, h, w, _, frame, tile, _ = CASES[case]
    left, right, d_ref, v_ref = _reference(case)
    p = _port_params(case, impl)
    mesh = parallel.make_mesh(frame=frame, tile=tile, devices=["cpu"] * (frame * tile))
    disp, valid = getattr(parallel, fn)(left, right, p, mesh)
    assert disp.shape == valid.shape == (b, h, w)
    assert disp.dtype == torch.float32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), v_ref)
    # the coarse-to-fine modes' subpixel sums differ from XLA's in the last
    # ulp (ROADMAP.md §3); everything else is exact
    atol = 1e-4 if CASES[case][7].get("mode", "full") != "full" else 0
    np.testing.assert_allclose(disp.numpy(), d_ref, atol=atol, rtol=0)
    assert v_ref.mean() > 0.3
    exact = fn != "sharded_disparity" or tile == 1
    for i in range(b if exact else 1):
        d1, v1 = compute_disparity(left[i], right[i], p, device="cpu")
        if exact:
            assert torch.equal(valid[i], v1) and torch.equal(disp[i], d1)
        elif "mode" not in CASES[case][7]:
            # row tiles of the approximate engine: the reference's seam tolerance
            both = valid[i] & v1
            assert ((disp[i] - d1).abs()[both] < 1.0).float().mean() > 0.95
        elif case == "approx_production":
            # the fill makes every pixel valid; the tiles' frame departs from
            # the single device's as the reference's does (held above)
            assert v1.all() and valid[i].all()
            assert ((disp[i] - d1).abs() < 1.0).float().mean() > 0.9


def test_sharded_hier_recovers_the_shift():
    """The reference's hier-through-sharding check, on the port's result."""
    left, right, _, _ = _reference("approx_hier")
    mesh = parallel.make_mesh(frame=2, tile=2, devices=["cpu"] * 4)
    disp, valid = parallel.sharded_disparity(left, right, _port_params("approx_hier", "auto"),
                                             mesh)
    d, v = disp[0].numpy(), valid[0].numpy()
    good = d[20:-20, 30:-10][v[20:-20, 30:-10]]
    assert good.size > 500 and abs(np.median(good) - 5) < 1.0


@pytest.mark.parametrize("fn,calls", [("sharded_disparity_exact", lambda b, t: b * t * t),
                                      ("sharded_disparity_exact_pipelined",
                                       lambda b, t: (b + t - 1) * t)])
def test_exact_engine_runs_the_chain_mode(monkeypatch, fn, calls):
    """The kernel impl's vertical chains go through aggregate_dual's chain
    mode: ntiles sweeps × ntiles tiles per frame, or (B + T − 1) steps × T
    tiles per frame group; the horizontal duals are one call per tile and
    frame."""
    seen = []
    dual = sgm_cuda.aggregate_dual

    def spy(cost, *a, **kw):
        seen.append("chain" if kw.get("boundary") is not None else "axis 1")
        return dual(cost, *a, **kw)

    monkeypatch.setattr(sgm_cuda, "aggregate_dual", spy)
    left, right = pair_batch(9, 3, 48, 64)
    mesh = parallel.make_mesh(frame=1, tile=3, devices=["cpu"] * 3)
    getattr(parallel, fn)(left, right, SGMParams(num_disparities=16, **_SMALL), mesh)
    assert seen.count("chain") == calls(3, 3)
    assert seen.count("axis 1") == 3 * 3


def test_exact_engine_refuses_what_it_does_not_run():
    mesh = parallel.make_mesh(frame=1, tile=2, devices=["cpu"] * 2)
    left, right = pair_batch(1, 1, 32, 48)
    for change in ({"mode": "hier"}, {"pack": 2}, {"paths": 2}, {"fill_invalid": True}):
        p = dataclasses.replace(SGMParams(num_disparities=16), **change)
        with pytest.raises(ValueError, match="exact tile-parallel"):
            parallel.sharded_disparity_exact(left, right, p, mesh)
    with pytest.raises(ValueError, match="split"):
        parallel.sharded_disparity_exact(left[:, :31], right[:, :31],
                                         SGMParams(num_disparities=16), mesh)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_make_mesh_builds_the_grid():
    mesh = parallel.make_mesh(frame=2, tile=4, devices=["cpu"] * 8)
    assert mesh.shape == {"frame": 2, "tile": 4}
    assert mesh.first == torch.device("cpu")
    assert parallel.make_mesh(tile=2, devices=["cpu"] * 8).shape == {"frame": 4, "tile": 2}
    with pytest.raises(ValueError):
        parallel.make_mesh(frame=3, tile=2, devices=["cpu"] * 8)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.make_mesh(devices=["cuda:0"] * 4)


@pytest.mark.parametrize("tiles,halo", [(4, 8), (3, 2), (1, 5)])
def test_halo_exchange_is_the_replicate_padded_image(tiles, halo):
    img = torch.from_numpy(np.random.default_rng(2).uniform(size=(tiles * 10, 7))).float()
    slabs = list(img.chunk(tiles))
    padded = np.pad(img.numpy(), ((halo, halo), (0, 0)), mode="edge")
    for k, got in enumerate(pmesh.halo_exchange(slabs, halo)):
        np.testing.assert_array_equal(got.numpy(), padded[k * 10:k * 10 + 10 + 2 * halo])


def test_ppermute_gives_zeros_where_nothing_arrives():
    rows = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    out = pmesh.ppermute(rows, [(0, 1), (1, 2), (2, 3)])
    assert torch.equal(out[0], torch.zeros(2, 3))
    for k in range(1, 4):
        assert torch.equal(out[k], rows[k - 1])


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _carry_rows(rng, x, d):
    """Random min-normalised (X, D) carry rows."""
    raw = rng.integers(0, 150, size=(x, d)).astype(np.float32)
    return raw - raw.min(axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_chain_mode_plain_matches_pallas(dtype):
    """The reference's S=25 (asymmetric block padding there), X=96, D=128;
    costs up to 60 with P2=96 reach the int8 store's clamp. A zero
    boundary is the unseeded scan; two seeded calls, the second seeded by
    the first's final carries, are the full scan; random seeds with a
    separate backward volume give the reference's four outputs."""
    rng = np.random.default_rng(3)
    S, X, D = 25, 96, 128
    cost = rng.integers(0, 61, (S, X, D)).astype(np.int8)
    cost_b = rng.integers(0, 61, (S, X, D)).astype(np.int8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lf_ref, lb_ref = (np.asarray(a) for a in sgm_pallas.aggregate_dual(
        jnp.asarray(cost, jnp.float32), 8.0, 96.0, axis=0, out_dtype=jdt, interpret=True))
    c = torch.from_numpy(cost)
    z = torch.zeros((X, D))
    lf, lb, ff, fb = sgm_cuda.aggregate_dual(c, 8.0, 96.0, axis=0, out_dtype=tdt,
                                             boundary=(z, z), return_final=True)
    assert lf.dtype == tdt and ff.dtype == torch.float32 and ff.shape == (X, D)
    np.testing.assert_array_equal(lf.numpy(), lf_ref)
    np.testing.assert_array_equal(lb.numpy(), lb_ref)
    s0 = 10
    _, _, ff0, _ = sgm_cuda.aggregate_dual(c[:s0], 8.0, 96.0, out_dtype=tdt, boundary=(z, z),
                                           return_final=True)
    lf1, lb1, _, fb1 = sgm_cuda.aggregate_dual(c[s0:], 8.0, 96.0, out_dtype=tdt,
                                               boundary=(ff0, z), return_final=True)
    lf0, lb0, _, _ = sgm_cuda.aggregate_dual(c[:s0], 8.0, 96.0, out_dtype=tdt,
                                             boundary=(z, fb1), return_final=True)
    np.testing.assert_array_equal(torch.cat([lf0, lf1]).numpy(), lf_ref)
    np.testing.assert_array_equal(torch.cat([lb0, lb1]).numpy(), lb_ref)
    if dtype == "int8":
        assert lf_ref.max() == 127  # the clamp was reached
    bf, bb = _carry_rows(rng, X, D), _carry_rows(rng, X, D)
    ref = sgm_pallas.aggregate_dual(
        jnp.asarray(cost, jnp.float32), 8.0, 96.0, axis=0, out_dtype=jdt,
        boundary=(jnp.asarray(bf), jnp.asarray(bb)), return_final=True,
        cost_b=jnp.asarray(cost_b, jnp.float32), interpret=True)
    out = sgm_cuda.aggregate_dual(c, 8.0, 96.0, axis=0, out_dtype=tdt,
                                  boundary=(torch.from_numpy(bf), torch.from_numpy(bb)),
                                  return_final=True, cost_b=torch.from_numpy(cost_b))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("axis,reverse,with_acc", [(0, False, False), (0, True, True),
                                                   (1, False, True), (1, True, False)])
def test_aggregate_dir_plain_matches_pallas(axis, reverse, with_acc):
    """13 rows and 20 columns (neither a multiple of the reference's block of
    8), D = 128; with ``acc`` the port adds onto it in place."""
    rng = np.random.default_rng(4)
    cost = rng.integers(0, 40, (13, 20, 128)).astype(np.float32)
    acc = rng.integers(0, 300, (13, 20, 128)).astype(np.float32) if with_acc else None
    ref = sgm_pallas.aggregate_dir(jnp.asarray(cost), 8.0, 32.0, axis=axis, reverse=reverse,
                                   acc=None if acc is None else jnp.asarray(acc), interpret=True)
    acc_t = None if acc is None else torch.from_numpy(acc.copy())
    out = sgm_cuda.aggregate_dir(torch.from_numpy(cost), 8.0, 32.0, axis=axis, reverse=reverse,
                                 acc=acc_t)
    assert out.dtype == torch.float32
    if with_acc:
        assert out is acc_t
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("D", [40, 3])
def test_wta_plain_matches_pallas(D):
    """Values 0..6 make ties everywhere (they go to the smallest d); with
    D = 3 a winner at d = 1 has no competitor (BIG)."""
    agg = np.random.default_rng(6).integers(0, 7, (9, 130, D)).astype(np.float32)
    ref = sgm_pallas.wta(jnp.asarray(agg), interpret=True)
    out = sgm_cuda.wta(torch.from_numpy(agg))
    for o, r in zip(out, ref):
        assert o.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if D == 3:
        assert (out[4].numpy() == 1e9).any()


# ---------------------------------------------------------------------------
# sgm.aggregate and sgm._wta with a kernel impl
# ---------------------------------------------------------------------------


def _volume():
    return np.random.default_rng(8).integers(0, 25, (10, 24, 16)).astype(np.float32)


def test_aggregate_kernel_impl_matches_reference(monkeypatch):
    """paths=4: four aggregate_dir calls, against the reference's Pallas
    branch (interpret mode) and its XLA branch."""
    cost = _volume()
    calls = []
    agg_dir = sgm_cuda.aggregate_dir
    monkeypatch.setattr(sgm_cuda, "aggregate_dir",
                        lambda *a, **kw: calls.append(kw.get("axis")) or agg_dir(*a, **kw))
    out = sgm.aggregate(torch.from_numpy(cost), SGMParams(num_disparities=16)).numpy()
    assert calls == [1, 1, 0, 0]
    for impl in ("pallas_interpret", "xla"):
        ref = jsgm.aggregate(jnp.asarray(cost), JParams(num_disparities=16, impl=impl))
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_aggregate_kernel_impl_follows_paths():
    """paths=2 under the kernel impl sums the horizontal pair, as the
    reference's XLA branch does; the reference's Pallas branch sums four
    directions whatever ``paths`` says (ROADMAP.md §3)."""
    cost = _volume()
    out = sgm.aggregate(torch.from_numpy(cost), SGMParams(num_disparities=16, paths=2)).numpy()
    ref = jsgm.aggregate(jnp.asarray(cost), JParams(num_disparities=16, paths=2, impl="xla"))
    np.testing.assert_array_equal(out, np.asarray(ref))
    four = jsgm.aggregate(jnp.asarray(cost), JParams(num_disparities=16, impl="pallas_interpret"))
    mismatch = jsgm.aggregate(jnp.asarray(cost),
                              JParams(num_disparities=16, paths=2, impl="pallas_interpret"))
    np.testing.assert_array_equal(np.asarray(mismatch), np.asarray(four))


def test_wta_of_a_volume_takes_the_kernel_under_a_kernel_impl(monkeypatch):
    agg = np.random.default_rng(10).integers(0, 400, (10, 24, 16)).astype(np.float32)
    seen = []
    wta = sgm_cuda.wta
    monkeypatch.setattr(sgm_cuda, "wta", lambda a: seen.append(a.shape) or wta(a))
    p = SGMParams(num_disparities=16, min_disparity=2)
    out = sgm._wta(torch.from_numpy(agg), p)
    assert seen == [(10, 24, 16)]
    plain = sgm._wta(torch.from_numpy(agg), dataclasses.replace(p, impl="xla"))
    ref = jsgm._wta(jnp.asarray(agg), JParams(num_disparities=16, min_disparity=2,
                                             impl="pallas_interpret"))
    for o, q, r in zip(out, plain, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert torch.equal(o, q)
