"""The port's ten kernels (stereovision_tpu_torch.ops.sgm_cuda).

On the CPU: each plain version is held exactly against the JAX package's
Pallas kernel run in interpret mode on the same numpy inputs (real lanes
only; the port's volumes carry exactly D disparities, in (H, W, D) where the
TPU kernels read (W, H, D) or (D, H, W) transposes), and the summed-volume
ops against the reference's XLA ones (``aggregate_dual``'s chain mode,
``aggregate_dir`` and ``wta`` are held against the reference in
``tests/test_torch_parallel.py``). On a card (marked ``cuda``, skipped
elsewhere): each CUDA kernel is held exactly against its plain version.
"""

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.ops import _build, sgm_cuda

RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def pallas():
    """The reference kernels; the card's test run has no JAX, and there only
    the ``cuda`` tests run."""
    return pytest.importorskip("stereovision_tpu.ops.sgm_pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _image(h, w):
    return RNG.uniform(0, 255, size=(h, w)).astype(np.float32)


def _dv(h, w, r=32.0):
    dv = RNG.uniform(-64, 160, size=(h, w)).astype(np.float32)
    dv[dv < -50] = -2.0 * r
    return dv


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,w", [(5, 5), (7, 5), (3, 3)])
def test_census_words_plain_matches_pallas(pallas, k, w):
    import jax.numpy as jnp

    img = _image(37, 150)
    ref = np.asarray(pallas.census_words(jnp.asarray(img), k, w, interpret=True))[:, :, :150]
    out = sgm_cuda.census_words(torch.from_numpy(img), k, w)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("min_d", [0, 4])
def test_cost_volume_plain_matches_pallas(pallas, min_d):
    import jax.numpy as jnp

    h, w, D = 24, 140, 40
    left, right = _image(h, w), _image(h, w)
    cl = pallas.census_words(jnp.asarray(left), 5, 5, interpret=True)
    crr = pallas.census_words(jnp.asarray(right[:, ::-1].copy()), 5, 5, mirror=True,
                              interpret=True)
    cost, cost_t = pallas.cost_volume_planes(
        cl, crr, w, 128, d_valid=D, min_d=min_d, max_cost=24.0, transposed=1, interpret=True)
    out = sgm_cuda.cost_volume(
        sgm_cuda.census_words(torch.from_numpy(left)),
        sgm_cuda.census_words(torch.from_numpy(right)), D, min_d, 24)
    assert out.dtype == torch.int8 and out.shape == (h, w, D)
    np.testing.assert_array_equal(out.numpy(), np.asarray(cost)[..., :D])
    np.testing.assert_array_equal(out.numpy(), np.asarray(cost_t)[..., :D].transpose(1, 0, 2))


@pytest.mark.parametrize("dtype,axis", [("int8", 0), ("int16", 0), ("int8", 1)])
def test_aggregate_dual_plain_matches_pallas(pallas, dtype, axis):
    """Costs up to 60 with P2=96 reach path costs above 127, so the int8
    store's clamp is exercised; int16 keeps them exact."""
    import jax.numpy as jnp

    cost = RNG.integers(0, 61, size=(19, 24, 128)).astype(np.int8)
    lf, lb = pallas.aggregate_dual(jnp.asarray(cost), 8.0, 96.0, axis=axis,
                                   out_dtype=getattr(jnp, dtype), interpret=True)
    of, ob = sgm_cuda.aggregate_dual(torch.from_numpy(cost), 8.0, 96.0, axis=axis,
                                     out_dtype=getattr(torch, dtype))
    assert of.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(of.numpy(), np.asarray(lf))
    np.testing.assert_array_equal(ob.numpy(), np.asarray(lb))
    if dtype == "int8":
        assert of.numpy().max() == 127  # the clamp was reached


def test_speckle_counts_plain_matches_pallas(pallas):
    import jax.numpy as jnp

    k, r, nbins = 15, 32.0, 6
    dv = _dv(37, 150, r)
    ref = pallas.speckle_counts(jnp.asarray(dv), k, r, nbins, interpret=True)
    out = sgm_cuda.speckle_counts(torch.from_numpy(dv), k, r, nbins)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _offsets(h, w, max_offset, clipped):
    """Offsets that are negative, ≥ max_offset and > x, or (``clipped``)
    the reference's clipped form min(max(off, 0), x)."""
    off = RNG.integers(-6, max_offset + 25, size=(h, w)).astype(np.int32)
    if clipped:
        off = np.minimum(np.maximum(off, 0), np.arange(w)[None, :]).astype(np.int32)
    return off


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_shift_gather_plain_matches_pallas(pallas, dtype, clipped):
    """W = 150 is not a multiple of 128. max_offset 40 is one roll block of
    the Pallas kernel, so it zeroes every offset ≥ 40, as the port does.
    The port has one form for both of the reference's (``assume_clipped``
    only lets the reference skip the off > x test)."""
    import jax.numpy as jnp

    src = RNG.uniform(-300, 300, size=(19, 150)).astype(dtype)
    off = _offsets(19, 150, 40, clipped)
    ref = pallas.shift_gather(jnp.asarray(src), jnp.asarray(off), 40,
                              assume_clipped=clipped, interpret=True)
    out = sgm_cuda.shift_gather(torch.from_numpy(src), torch.from_numpy(off), 40)
    assert out.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() == 0).mean() > 0.2  # out-of-range offsets were present


def test_shift_gather_batch_is_per_map(pallas):
    """A (B, H, W) source shares the offsets: each map as its own call."""
    import jax.numpy as jnp

    src = RNG.integers(-2**31, 2**31 - 1, size=(2, 13, 150), dtype=np.int64).astype(np.int32)
    off = _offsets(13, 150, 33, clipped=True)
    out = sgm_cuda.shift_gather(torch.from_numpy(src), torch.from_numpy(off), 33)
    for b in range(2):
        ref = pallas.shift_gather(jnp.asarray(src[b]), jnp.asarray(off), 33, interpret=True)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype,d_valid", [("int16", 40), ("int16", 23), ("int8", 40)])
def test_right_disparity_plain_matches_pallas(pallas, dtype, d_valid):
    """Against the reference on the (D, H, W) transpose it reads
    (``pre_transposed``), including d_valid < D; W = 140."""
    import jax.numpy as jnp

    lo, hi = (-128, 127) if dtype == "int8" else (0, 400)
    s = RNG.integers(lo, hi, size=(16, 140, 40)).astype(dtype)
    ref = pallas.right_disparity(jnp.asarray(s.transpose(2, 0, 1)), d_valid,
                                 pre_transposed=True, interpret=True)
    out = sgm_cuda.right_disparity(torch.from_numpy(s), d_valid)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_right_disparity_groups_are_per_slice(pallas):
    """The reference's batched groups (groups=2, group_stride=64,
    d_valid=64: two d-blocks per group) equal the port run on each group's
    plane slice, stacked by rows [g·H, (g+1)·H)."""
    import jax.numpy as jnp

    s = RNG.integers(-128, 127, size=(16, 140, 128)).astype(np.int8)
    ref = pallas.right_disparity(jnp.asarray(s.transpose(2, 0, 1)), 64, pre_transposed=True,
                                 groups=2, group_stride=64, interpret=True)
    out = torch.cat([sgm_cuda.right_disparity(torch.from_numpy(s[..., g * 64:(g + 1) * 64].copy()))
                     for g in range(2)])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("D,d_valid", [(40, 40), (40, 29), (32, 32)])
def test_wta_stats_from_duals_plain_matches_pallas(pallas, D, d_valid):
    """Against the reference on the (W, H, D) transposes it reads; planes
    ≥ d_valid carry the reference's 2²¹ sentinel into cp and comp."""
    import jax.numpy as jnp

    hf = RNG.integers(0, 128, size=(16, 150, D)).astype(np.int8)
    hb = RNG.integers(0, 128, size=(16, 150, D)).astype(np.int8)
    ref = pallas.wta_stats_from_duals(jnp.asarray(hf.transpose(1, 0, 2)),
                                      jnp.asarray(hb.transpose(1, 0, 2)), d_valid=d_valid,
                                      interpret=True)
    out = sgm_cuda.wta_stats_from_duals(torch.from_numpy(hf), torch.from_numpy(hb), d_valid)
    for r, o in zip(ref, out):
        assert o.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_wta_stats_from_duals_plain_matches_pallas_int16(pallas):
    """int16 dual volumes (per-direction costs above 127, e.g. a 7×7 census
    with P2 = 96), which the reference's kernel takes as they are."""
    import jax.numpy as jnp

    hf = RNG.integers(0, 145, size=(16, 150, 40)).astype(np.int16)
    hb = RNG.integers(0, 145, size=(16, 150, 40)).astype(np.int16)
    ref = pallas.wta_stats_from_duals(jnp.asarray(hf.transpose(1, 0, 2)),
                                      jnp.asarray(hb.transpose(1, 0, 2)), d_valid=33,
                                      interpret=True)
    out = sgm_cuda.wta_stats_from_duals(torch.from_numpy(hf), torch.from_numpy(hb), 33)
    for r, o in zip(ref, out):
        assert o.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("axis", [1, 0])
def test_nearest_valid_lohi_plain_matches_pallas(pallas, axis):
    """Rows (and, through the transpose the reference takes, columns) with
    no valid pixel get d_up on both sides; W = 150."""
    import jax.numpy as jnp

    d = RNG.uniform(0, 64, size=(37, 150)).astype(np.float32)
    v = RNG.uniform(size=(37, 150)) < 0.1
    v[3] = False
    v[:, 7] = False
    up = RNG.uniform(0, 64, size=(37, 150)).astype(np.float32)
    if axis == 1:
        lo, hi = pallas.nearest_valid_lohi(jnp.asarray(d), jnp.asarray(v), jnp.asarray(up),
                                           interpret=True)
    else:
        lo, hi = (np.asarray(a).T for a in pallas.nearest_valid_lohi(
            jnp.asarray(d.T), jnp.asarray(v.T), jnp.asarray(up.T), interpret=True))
    out = sgm_cuda.nearest_valid_lohi(torch.from_numpy(d), torch.from_numpy(v),
                                      torch.from_numpy(up), axis=axis)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(lo))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(hi))


@pytest.mark.parametrize("n_vols,dtype", [(2, "int8"), (2, "int16"), (4, "int8")])
def test_sum_wta_matches_reference(pallas, n_vols, dtype):
    """The port's sum_wta against the reference's XLA sum_wta with
    emit_transposed: the same statistics, and the summed volume equal to the
    reference's s_t in (H, W, D) — int8 offset by −128 for two int8
    volumes, int16 otherwise; st_from_duals gives the same volume."""
    import jax.numpy as jnp

    H_, W_, D_ = 9, 20, 16
    vols = [RNG.integers(0, 128, size=(H_, W_, D_)).astype(dtype) for _ in range(n_vols)]
    jv = [jnp.asarray(v.transpose(1, 0, 2)) for v in vols[:2]] + [jnp.asarray(v) for v in vols[2:]]
    ref = pallas.sum_wta(tuple(jv), d_valid=D_, emit_transposed=True)
    out = sgm_cuda.sum_wta([torch.from_numpy(v) for v in vols], emit_sum=True)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]).transpose(1, 2, 0))
    assert out[0].numpy().dtype == np.asarray(ref[0]).dtype
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if n_vols == 2:
        st = pallas.st_from_duals(jv[0], jv[1], D_)
        mine = sgm_cuda.st_from_duals(*(torch.from_numpy(v) for v in vols))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(st).transpose(1, 2, 0))


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    sgm_cuda.reset_launch_counts()
    img = torch.from_numpy(_image(16, 40))
    cl = sgm_cuda.census_words(img)
    cost = sgm_cuda.cost_volume(cl, cl, 8, 0, 24)
    hf, hb = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=1, out_dtype=torch.int8)
    sgm_cuda.wta_stats_from_duals(hf, hb)
    sgm_cuda.right_disparity(sgm_cuda.st_from_duals(hf, hb))
    sgm_cuda.shift_gather(img, torch.zeros((16, 40), dtype=torch.int32), 8)
    dv = torch.from_numpy(_dv(16, 40))
    sgm_cuda.speckle_counts(dv, 5, 32.0, 6)
    sgm_cuda.nearest_valid_lohi(dv, dv > 0, dv)
    z = torch.zeros((40, 8))
    sgm_cuda.aggregate_dual(cost, 8.0, 96.0, boundary=(z, z), return_final=True, cost_b=cost)
    s = sgm_cuda.aggregate_dir(cost.float(), 8.0, 96.0, axis=1)
    sgm_cuda.wta(sgm_cuda.aggregate_dir(cost.float(), 8.0, 96.0, axis=0, acc=s))
    assert sgm_cuda.launch_counts() == {name: 0 for name in sgm_cuda.COUNTS}
    assert len(sgm_cuda.KERNEL_WRAPPERS) == 10
    assert set(sgm_cuda.COUNTS) == {f.__name__ for f in sgm_cuda.KERNEL_WRAPPERS} | {
        "aggregate_dual_chain"}


def test_aggregate_dual_rejects_bad_arguments():
    cost = torch.zeros((4, 5, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dual(cost, 8.0, 96.0, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=2)


def _chain_refusals(cost):
    """Chain-mode argument sets the reference refuses
    (``sgm_pallas.py:914-920``): not axis 0, a boundary without the final
    carries or the reverse, ``cost_b`` alone; and rows of the wrong shape."""
    H, W, D = cost.shape
    z = torch.zeros((W, D), device=cost.device)
    return [dict(axis=1, boundary=(z, z), return_final=True),
            dict(boundary=(z, z)), dict(return_final=True), dict(cost_b=cost),
            dict(boundary=(z[:-1], z[:-1]), return_final=True),
            dict(boundary=(z, z), return_final=True, cost_b=cost[:-1])]


@pytest.mark.parametrize("case", range(6))
def test_aggregate_dual_chain_mode_refuses_what_the_reference_refuses(case):
    cost = torch.zeros((4, 5, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        sgm_cuda.aggregate_dual(cost, 8.0, 96.0, **_chain_refusals(cost)[case])


def test_aggregate_dir_rejects_bad_arguments():
    cost = torch.zeros((4, 5, 8))
    with pytest.raises(ValueError):
        sgm_cuda.aggregate_dir(cost, 8.0, 96.0, axis=2)
    with pytest.raises(ValueError):
        sgm_cuda.aggregate_dir(cost, 8.0, 96.0, acc=torch.zeros((4, 5, 7)))


def test_sum_wta_matches_stats_of_the_float_sum():
    """The int32 sum's statistics equal those of the float32 sum that the
    plain path's WTA reads (integer path costs)."""
    vols = [torch.from_numpy(RNG.integers(0, 120, size=(6, 7, 16)).astype(np.int8))
            for _ in range(4)]
    s, best, idx, cm, cp, comp = sgm_cuda.sum_wta(vols)
    assert s is None and idx.dtype == torch.int32
    fbest, fidx, fcm, fcp, fcomp = sgm_cuda._wta_stats(sum(v.float() for v in vols))
    assert torch.equal(best, fbest) and torch.equal(idx.long(), fidx)
    inner = (idx > 0) & (idx < 15)
    assert torch.equal(cm[inner], fcm[inner]) and torch.equal(cp[inner], fcp[inner])
    assert torch.equal(comp, fcomp)


def test_library_path_names_the_source_hash():
    p = _build.library_path("aggregate")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("aggregate-")
    assert p == _build.library_path("aggregate")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(5, 5), (7, 5), (3, 3)])
def test_census_words_kernel(cuda, k, w):
    img = torch.from_numpy(_image(37, 150)).to(cuda)
    before = sgm_cuda.launch_counts()["census_words"]
    out = sgm_cuda.census_words(img, k, w)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["census_words"] == before + 1
    assert torch.equal(out, sgm_cuda.census_words_plain(img, k, w))


@pytest.mark.cuda
@pytest.mark.parametrize("min_d,D,k", [(0, 40, 5), (4, 64, 5), (-3, 45, 5), (0, 33, 7)])
def test_cost_volume_kernel(cuda, min_d, D, k):
    cl = sgm_cuda.census_words(torch.from_numpy(_image(24, 140)).to(cuda), k, 5)
    cr = sgm_cuda.census_words(torch.from_numpy(_image(24, 140)).to(cuda), k, 5)
    n_bits = k * 5 - 1
    out = sgm_cuda.cost_volume(cl, cr, D, min_d, n_bits)
    torch.cuda.synchronize()
    assert torch.equal(out, sgm_cuda.cost_volume_plain(cl, cr, D, min_d, n_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 45, 320])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("axis", [0, 1])
def test_aggregate_dual_kernel(cuda, D, dtype, axis):
    cost = torch.from_numpy(RNG.integers(0, 61, size=(21, 30, D)).astype(np.int8)).to(cuda)
    got = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=axis, out_dtype=dtype)
    torch.cuda.synchronize()
    want = sgm_cuda.aggregate_dual_plain(cost, 8.0, 96.0, axis=axis, out_dtype=dtype)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_speckle_counts_kernel(cuda):
    dv = torch.from_numpy(_dv(37, 150)).to(cuda)
    out = sgm_cuda.speckle_counts(dv, 15, 32.0, 6)
    torch.cuda.synchronize()
    assert torch.equal(out, sgm_cuda.speckle_counts_plain(dv, 15, 32.0, 6))


@pytest.mark.cuda
def test_kernels_reject_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        sgm_cuda.census_words(torch.zeros((4, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dual(torch.zeros((4, 4, 8), dtype=torch.int16, device=cuda), 8.0, 96.0)


@pytest.mark.cuda
def test_aggregate_dual_kernel_raises_past_512_disparities(cuda):
    before = sgm_cuda.launch_counts()["aggregate_dual"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sgm_cuda.aggregate_dual(torch.zeros((2, 3, 513), dtype=torch.int8, device=cuda), 8.0, 96.0)
    assert sgm_cuda.launch_counts()["aggregate_dual"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("D,d_valid", [(32, 32), (107, 107), (45, 30), (320, 320)])
def test_wta_stats_from_duals_kernel(cuda, D, d_valid):
    hf = torch.from_numpy(RNG.integers(0, 128, size=(13, 70, D)).astype(np.int8)).to(cuda)
    hb = torch.from_numpy(RNG.integers(0, 128, size=(13, 70, D)).astype(np.int8)).to(cuda)
    got = sgm_cuda.wta_stats_from_duals(hf, hb, d_valid)
    torch.cuda.synchronize()
    want = sgm_cuda.wta_stats_from_duals_plain(hf, hb, d_valid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D,d_valid", [(32, 32), (107, 107), (320, 300)])
def test_wta_stats_from_duals_kernel_int16(cuda, D, d_valid):
    hf = torch.from_numpy(RNG.integers(0, 600, size=(13, 70, D)).astype(np.int16)).to(cuda)
    hb = torch.from_numpy(RNG.integers(0, 600, size=(13, 70, D)).astype(np.int16)).to(cuda)
    got = sgm_cuda.wta_stats_from_duals(hf, hb, d_valid)
    torch.cuda.synchronize()
    want = sgm_cuda.wta_stats_from_duals_plain(hf, hb, d_valid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,d_valid", [(torch.int8, 32, 32), (torch.int16, 107, 107),
                                             (torch.int16, 40, 23), (torch.int8, 320, 320)])
def test_right_disparity_kernel(cuda, dtype, D, d_valid):
    lo, hi = (-128, 127) if dtype == torch.int8 else (0, 600)
    s = torch.randint(lo, hi, (11, 140, D), dtype=dtype).to(cuda)
    got = sgm_cuda.right_disparity(s, d_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_cuda.right_disparity_plain(s, d_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(19, 150), (2, 19, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_shift_gather_kernel(cuda, shape, dtype):
    src = torch.from_numpy(RNG.uniform(-300, 300, size=shape)).to(dtype).to(cuda)
    off = torch.from_numpy(_offsets(19, 150, 40, clipped=False)).to(cuda)
    got = sgm_cuda.shift_gather(src, off, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_cuda.shift_gather_plain(src, off, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_nearest_valid_lohi_kernel(cuda, axis):
    d = torch.from_numpy(RNG.uniform(0, 64, size=(37, 1500)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(RNG.uniform(size=(37, 1500)) < 0.02).to(cuda)
    v[3] = False
    v[:, 7] = False
    up = torch.from_numpy(RNG.uniform(0, 64, size=(37, 1500)).astype(np.float32)).to(cuda)
    got = sgm_cuda.nearest_valid_lohi(d, v, up, axis)
    torch.cuda.synchronize()
    want = sgm_cuda.nearest_valid_lohi_plain(d, v, up, axis)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_new_kernels_reject_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        sgm_cuda.right_disparity(torch.zeros((4, 5, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        sgm_cuda.shift_gather(torch.zeros((4, 5), dtype=torch.float64, device=cuda),
                              torch.zeros((4, 5), dtype=torch.int32, device=cuda), 3)
    with pytest.raises(TypeError):
        sgm_cuda.wta_stats_from_duals(torch.zeros((4, 5, 8), dtype=torch.int32, device=cuda),
                                      torch.zeros((4, 5, 8), dtype=torch.int32, device=cuda))


def _seeds(shape, device):
    """Random nonzero min-normalised (W, D) carry rows."""
    raw = torch.from_numpy(RNG.integers(0, 150, size=shape).astype(np.float32)).to(device)
    return raw - raw.amin(dim=-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 107, 320])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_aggregate_dual_chain_kernel(cuda, D, dtype):
    """Random nonzero boundaries, a backward volume other than the forward
    one; costs up to 60 with P2=96 reach the int8 clamp."""
    cost, cost_b = (torch.from_numpy(RNG.integers(0, 61, size=(23, 30, D), dtype=np.int8)).to(cuda)
                    for _ in range(2))
    bf, bb = _seeds((30, D), cuda), _seeds((30, D), cuda)
    before = sgm_cuda.launch_counts()
    got = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, out_dtype=dtype, boundary=(bf, bb),
                                  return_final=True, cost_b=cost_b)
    torch.cuda.synchronize()
    after = sgm_cuda.launch_counts()
    assert after["aggregate_dual_chain"] == before["aggregate_dual_chain"] + 1
    assert after["aggregate_dual"] == before["aggregate_dual"]
    want = sgm_cuda.aggregate_dual_plain(cost, 8.0, 96.0, out_dtype=dtype, boundary=(bf, bb),
                                         return_final=True, cost_b=cost_b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 107, 320])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reverse,with_acc", [(False, False), (True, True)])
def test_aggregate_dir_kernel(cuda, D, axis, reverse, with_acc):
    cost = torch.from_numpy(RNG.integers(0, 40, size=(21, 30, D)).astype(np.float32)).to(cuda)
    acc = (torch.from_numpy(RNG.integers(0, 500, size=(21, 30, D)).astype(np.float32)).to(cuda)
           if with_acc else None)
    got = sgm_cuda.aggregate_dir(cost, 8.0, 96.0, axis, reverse,
                                 None if acc is None else acc.clone())
    torch.cuda.synchronize()
    want = sgm_cuda.aggregate_dir_plain(cost, 8.0, 96.0, axis, reverse,
                                        None if acc is None else acc.clone())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 16, 107, 320])
def test_wta_kernel(cuda, D):
    """Values 0..6: ties everywhere (to the smallest d)."""
    agg = torch.from_numpy(RNG.integers(0, 7, size=(13, 70, D)).astype(np.float32)).to(cuda)
    got = sgm_cuda.wta(agg)
    torch.cuda.synchronize()
    want = sgm_cuda.wta_plain(agg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_chain_dir_and_wta_kernels_reject_bad_dtypes_and_modes(cuda):
    before = sgm_cuda.launch_counts()
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dir(torch.zeros((4, 5, 8), dtype=torch.int8, device=cuda), 8.0, 96.0)
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dir(torch.zeros((4, 5, 8), device=cuda), 8.0, 96.0,
                               acc=torch.zeros((4, 5, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        sgm_cuda.wta(torch.zeros((4, 5, 8), dtype=torch.int16, device=cuda))
    cost = torch.zeros((4, 5, 8), dtype=torch.int8, device=cuda)
    z64 = torch.zeros((5, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dual(cost, 8.0, 96.0, boundary=(z64, z64), return_final=True)
    for kw in _chain_refusals(cost):
        with pytest.raises(ValueError):
            sgm_cuda.aggregate_dual(cost, 8.0, 96.0, **kw)
    for fn in (sgm_cuda.aggregate_dir, sgm_cuda.wta):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(torch.zeros((2, 3, 513), device=cuda), *((8.0, 96.0) if fn is not sgm_cuda.wta
                                                         else ()))
    assert sgm_cuda.launch_counts() == before
