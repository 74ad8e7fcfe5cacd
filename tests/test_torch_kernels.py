"""The port's twelve kernels (stereovision_tpu_torch.ops.sgm_cuda).

On the CPU: each plain version is held exactly against the JAX package's
Pallas kernel run in interpret mode on the same numpy inputs (real lanes
only; the port's volumes carry exactly D disparities, in (H, W, D) where the
TPU kernels read (W, H, D) or (D, H, W) transposes), and the summed-volume
ops against the reference's XLA ones (``aggregate_dual``'s chain mode,
``aggregate_dir`` and ``wta`` are held against the reference in
``tests/test_torch_parallel.py``, the measurement kernels of ``bench_cuda``
in ``tests/test_torch_scripts.py``). On a card (marked ``cuda``, skipped
elsewhere): each CUDA kernel is held exactly against its plain version, the
measurement variants too, at ragged shapes.
"""

import re

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.ops import _build, bench_cuda, sgm_cuda

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


@pytest.mark.parametrize("k,nbins,shape", [(15, 6, (37, 150)), (15, 13, (37, 150)),
                                           (3, 6, (37, 150)), (15, 6, (9, 12))])
def test_speckle_counts_plain_matches_pallas(pallas, k, nbins, shape):
    """The production frame's full-resolution binning (nbins = 13) and the
    coarse search's (6), the smallest window, and a field smaller than its
    window (the replicate padding reaches past the far border)."""
    import jax.numpy as jnp

    r = 32.0
    dv = _dv(*shape, r)
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


@pytest.mark.parametrize("D,d_valid", [(40, 40), (40, 29), (32, 32), (107, 107)])
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
    sgm_cuda.sum_wta_fused(hf, hb, hf, hb)
    sgm_cuda.median_blur(dv, 5)
    # the measurement kernels of bench_cuda count in the same dict
    assert sgm_cuda.launch_counts() == {name: 0 for name in (*sgm_cuda.COUNTS,
                                                             *bench_cuda.COUNTS)}
    assert len(sgm_cuda.KERNEL_WRAPPERS) == 12
    # sum_wta_fused and median_blur count under their kernels' names
    assert set(sgm_cuda.COUNTS) == {f.__name__ for f in sgm_cuda.KERNEL_WRAPPERS[:-2]} | {
        "sum_wta", "median", "aggregate_dual_chain"}


def test_census_design_templates_the_engine_windows():
    forms = {size: sgm_cuda.census_design(*size) for size in sgm_cuda.CENSUS_FORMS}
    assert sorted(forms) == [(3, 3), (5, 5), (7, 5), (7, 7), (9, 7)]
    assert sorted(forms.values()) == [1, 2, 3, 4, 5]
    # any other window (the transpose of a templated one too) runs the
    # runtime-size instance
    assert {sgm_cuda.census_design(k, w) for k, w in [(5, 7), (9, 9), (4, 3), (11, 3)]} == {0}


@pytest.mark.parametrize("D", [1, 16, 32, 33, 45, 107, 320, 1000, 1024])
@pytest.mark.parametrize("nw", [1, 2, 3])
def test_cost_design(D, nw):
    """The instance follows nw; TX is the widest tile (32-256) whose output
    span stays within 48 KB; the staged span's pad keeps the lanes' stores
    and the copy-out's loads within a few accesses a bank."""
    form, tx, sh = sgm_cuda.cost_design(D, nw)
    assert form == (nw if nw < 3 else 0)
    assert tx in (32, 64, 128, 256) and (tx * D <= 49152 or tx == 32)
    assert tx == 256 or 2 * tx * D > 49152
    assert 2 <= sh <= 7
    ways = sgm_cuda._bank_ways
    store = max(ways([(lane * D) // 4 + k for lane in range(32)], sh) for k in range(4))
    copy = max(ways([4 * c + k for c in range(c0, c0 + 32)], sh)
               for k in range(4) for c0 in (0, 7))
    assert store <= 3 and copy <= 4 and store + copy <= 6
    if D == 32:  # the refine stack's stores meet no conflict
        assert store == 1
    # unpadded (a shift past any index), the lanes' stores D bytes apart meet
    # 8 a bank at D = 32 and 16 at D = 320; a pad word every 4 spreads 32
    # consecutive chunks over all banks
    assert ways([8 * lane for lane in range(32)], 40) == 8
    assert ways([80 * lane for lane in range(32)], 40) == 16
    assert ways([4 * c for c in range(32)], 2) == 1


@pytest.mark.parametrize("k,w", [(5, 5), (7, 5), (3, 3)])
def test_census_words_first_on_the_cpu_is_the_plain_version(k, w):
    img = torch.from_numpy(_image(37, 150))
    before = sgm_cuda.launch_counts()
    out = bench_cuda.census_words_first(img, k, w)
    assert torch.equal(out, sgm_cuda.census_words_plain(img, k, w))
    assert sgm_cuda.launch_counts() == before


@pytest.mark.parametrize("min_d", [0, 4])
def test_cost_volume_first_on_the_cpu_is_the_plain_version(min_d):
    cl, cr = (sgm_cuda.census_words(torch.from_numpy(_image(24, 140))) for _ in range(2))
    before = sgm_cuda.launch_counts()
    out = bench_cuda.cost_volume_first(cl, cr, 40, min_d, 24)
    assert torch.equal(out, sgm_cuda.cost_volume_plain(cl, cr, 40, min_d, 24))
    assert sgm_cuda.launch_counts() == before


@pytest.mark.parametrize("axis", [0, 1])
def test_earlier_rdisp_and_lohi_designs_on_the_cpu_are_the_plain_versions(axis):
    """``right_disparity``'s ``in_place`` variant and
    ``nearest_valid_lohi_chunks`` on CPU tensors are the plain versions and
    launch nothing."""
    s = torch.from_numpy(RNG.integers(-128, 127, size=(9, 70, 40)).astype(np.int8))
    d = torch.from_numpy(RNG.uniform(0, 64, size=(37, 150)).astype(np.float32))
    v = torch.from_numpy(RNG.uniform(size=(37, 150)) < 0.05)
    up = torch.from_numpy(RNG.uniform(0, 64, size=(37, 150)).astype(np.float32))
    before = sgm_cuda.launch_counts()
    assert torch.equal(bench_cuda.right_disparity_variants(s, "in_place", 40 - 7 * axis),
                       sgm_cuda.right_disparity_plain(s, 40 - 7 * axis))
    got = bench_cuda.nearest_valid_lohi_chunks(d, v, up, axis)
    want = sgm_cuda.nearest_valid_lohi_plain(d, v, up, axis)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sgm_cuda.launch_counts() == before
    with pytest.raises(ValueError):
        bench_cuda.nearest_valid_lohi_chunks(d, v, up, 2)


@pytest.mark.parametrize("H,W,D,itemsize,d_valid,design", [
    (720, 1280, 32, 1, 32, "tiles"),      # the refine's LR check
    (240, 426, 107, 1, 107, "span"),      # the coarse search's
    (720, 1280, 320, 2, 320, "tiles"),    # the full search's, int16
    (75, 426, 107, 1, 107, "span"),       # a sharded slab's coarse search
    (11, 140, 107, 2, 107, "span"),
    (11, 140, 40, 2, 23, "tiles"),
    (13, 426, 107, 2, 107, "tiles"),      # 234 columns of 214 bytes: past 48 KB
    (5, 140, 1024, 2, 1000, "tiles"),
])
def test_right_disparity_design(H, W, D, itemsize, d_valid, design):
    """Blocks of 128 right pixels; the whole span staged where it fits 48 KB
    of shared memory (the bytes ``csrc/right_disparity.cu`` takes for it)
    and its pitch of D elements puts at most 2 of a warp's 32 reads on one
    bank, tiles of 32 planes elsewhere. The C entries take the shape, the
    item size and the choice, once a shape."""
    staging = sgm_cuda.right_disparity_design(W, D, itemsize, d_valid)
    assert staging == design
    span = (min(W, 128 + min(d_valid, W) - 1) * D * itemsize + 31) // 16 * 16
    ways = sgm_cuda._span_ways(D, itemsize)
    assert (staging == "span") == (span <= 48 * 1024 and ways <= 2)
    args = sgm_cuda._rdisp_args(H, W, D, d_valid, itemsize)
    assert args == (H, W, D, d_valid, itemsize, staging == "tiles")
    assert sgm_cuda._rdisp_args(H, W, D, d_valid, itemsize) is args


@pytest.mark.parametrize("D,itemsize,ways", [(107, 1, 2), (107, 2, 2), (33, 1, 2), (1, 1, 1),
                                             (32, 1, 8), (40, 2, 4), (320, 2, 32)])
def test_right_disparity_span_ways(D, itemsize, ways):
    """32 threads on consecutive right pixels read cells D elements apart:
    odd pitches spread them, a pitch of 32 bytes puts 8 on a bank."""
    assert sgm_cuda._span_ways(D, itemsize) == ways


@pytest.mark.parametrize("H,W,axis,design", [
    (720, 1280, 1, 320), (720, 1280, 0, 256),  # the production fill
    (240, 426, 1, 128), (37, 1283, 1, 352),
    (4, 10000, 1, 512), (9000, 6, 0, 256),     # lines past one tile
    (37, 1, 1, 32), (1, 37, 0, 32), (20, 41, 0, 96),
])
def test_nearest_lohi_design(H, W, axis, design):
    """Axis 1: a block a row, 4 positions a thread, its tile the whole row
    up to 2048 positions (at most 512 threads, less than a warp's positions
    past the row). Axis 0: a block of 32 columns and tiles of 8 rows a
    warp, at most 8 warps (64 rows), fewer where the map has fewer rows.
    The C entry takes the shape, the axis and the threads, once a shape."""
    threads = sgm_cuda.nearest_lohi_design(H, W, axis)
    assert threads == design
    assert threads % 32 == 0 and 32 <= threads <= 512
    if axis == 1:
        tile = threads * 4
        assert (tile >= W) == (W <= 2048)
        assert tile - W < 32 * 4 or tile < W
    else:
        assert threads // 32 * 8 == min(64, -(-H // 8) * 8)
    assert sgm_cuda._lohi_args(H, W, axis) == (H, W, axis, threads)


def test_right_disparity_ablations_plain_and_arguments():
    """The ablations define no output (None on the CPU, no launch) and
    refuse an unknown form or d_valid."""
    s = torch.zeros((3, 20, 8), dtype=torch.int8)
    before = sgm_cuda.launch_counts()
    assert all(bench_cuda.right_disparity_ablations(s, form) is None
               for form in bench_cuda.RDISP_ABLATIONS)
    assert sgm_cuda.launch_counts() == before
    with pytest.raises(ValueError):
        bench_cuda.right_disparity_ablations(s, "no_redux")
    with pytest.raises(ValueError):
        bench_cuda.right_disparity_ablations(s, "stage_only", 9)


def test_census_and_cost_ablations_plain_and_arguments():
    img = torch.from_numpy(_image(9, 21))
    assert torch.equal(bench_cuda.census_words_ablations(img, "stage_only"),
                       torch.zeros((1, 9, 21), dtype=torch.int32))
    assert bench_cuda.census_words_ablations(img, "no_store") is None
    cl, cr = (sgm_cuda.census_words(torch.from_numpy(_image(9, 21))) for _ in range(2))
    # no_popc: the xor's low 6 bits where the column is inside, max_cost outside
    vol = bench_cuda.cost_volume_ablations(cl, cr, 7, 2, 24, "no_popc")
    assert vol.shape == (9, 21, 7) and vol.dtype == torch.int8
    assert torch.equal(vol[:, 10, 3], ((cl[0, :, 10] ^ cr[0, :, 5]) & 0x3F).to(torch.int8))
    assert bool((vol[:, 1, 0] == 24).all())
    for form in ("no_runs", "no_copy", "copy_only"):
        assert bench_cuda.cost_volume_ablations(cl, cr, 7, 2, 24, form) is None
    assert torch.equal(bench_cuda.cost_volume_ablations(cl, cr, 16, 2, 24, "direct"),
                       sgm_cuda.cost_volume_plain(cl, cr, 16, 2, 24))
    with pytest.raises(ValueError):
        bench_cuda.cost_volume_ablations(cl, cr, 7, 2, 24, "direct")
    with pytest.raises(ValueError):
        bench_cuda.census_words_ablations(img, "no_compare")
    with pytest.raises(ValueError):
        bench_cuda.cost_volume_ablations(cl, cr, 7, 2, 24, "no_popcount")


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


@pytest.mark.parametrize("dtype,hi", [("int8", 128), ("int16", 20000)])
def test_fused_sum_wta_matches_reference(pallas, dtype, hi):
    """The fused wrapper's CPU path (its plain version) on four volumes
    against the reference's XLA sum_wta with emit_transposed: the same
    statistics, and the int16 sum equal to the reference's s_t in
    (H, W, D); the int16 volumes' sums pass the 30000 clamp."""
    import jax.numpy as jnp

    H_, W_, D_ = 9, 20, 16
    vols = [RNG.integers(0, hi, size=(H_, W_, D_)).astype(dtype) for _ in range(4)]
    jv = [jnp.asarray(v.transpose(1, 0, 2)) for v in vols[:2]] + [jnp.asarray(v) for v in vols[2:]]
    ref = pallas.sum_wta(tuple(jv), d_valid=D_, emit_transposed=True)
    out = sgm_cuda.sum_wta_fused(*(torch.from_numpy(v) for v in vols), emit="hwd")
    assert out[0].dtype == torch.int16
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]).transpose(1, 2, 0))
    for r, o in zip(ref[1:], out[1:]):
        assert o.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if dtype == "int16":
        assert (out[0] == 30000).any() and (out[0] < 30000).any()
    none = sgm_cuda.sum_wta_fused(*(torch.from_numpy(v) for v in vols), emit="none")
    assert none[0] is None and all(torch.equal(a, b) for a, b in zip(none[1:], out[1:]))


# D → (G, P, Q, 16-byte run loads for int8, for int16, whole-word hwd stores)
SUM_DESIGNS = {1: (1, 256, 4, False, False, False), 32: (1, 256, 32, True, True, True),
               107: (4, 64, 28, False, False, False), 320: (16, 16, 20, False, False, True),
               321: (16, 16, 24, False, False, False), 1024: (32, 8, 32, True, True, True)}


@pytest.mark.parametrize("D", sorted(SUM_DESIGNS))
def test_sum_wta_design(D):
    """G is the least power of two that leaves at most 32 planes a lane, a
    block of 256 threads takes 256 / G pixels, Q is the least multiple of
    4 that covers D in G lanes; runs load as 16-byte vectors only where
    pixels and runs are multiples of 16 bytes, and the int16 sum stores as
    words where D is even. The staged spans and outputs fit the 96 KB the
    kernel asks for (csrc/sum_wta.cu's Layout)."""
    g, p, q, vec8, vec16, words = SUM_DESIGNS[D]
    for itemsize, vec in ((1, vec8), (2, vec16)):
        d = sgm_cuda.sum_wta_design(D, itemsize)
        assert (d.g, d.p, d.q, d.vec, d.words) == (g, p, q, vec, words)
        assert d.g & (d.g - 1) == 0 and d.g * d.p == 256 and d.q % 4 == 0 and d.q <= 32
        assert d.g * d.q >= D > d.g * (d.q - 4) and (d.g == 1 or -(-D // (d.g // 2)) > 32)
        region = (d.p * D * itemsize + 128 + 15) // 16 * 16
        out = max(d.p * D * 2 + 32, D * (d.p + 2) * 2)
        assert 4 * region + out + 20 * d.p <= 96 * 1024


def test_library_path_names_the_source_hash():
    p = _build.library_path("aggregate")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("aggregate-")
    assert p == _build.library_path("aggregate")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_variant_libraries_build_from_the_shipping_sources():
    """Each variant library is its shipping source built again with
    -DSVT_VARIANTS: the same file, another library."""
    assert set(_build.LIBRARIES) == set(_build.KERNELS) | set(_build.VARIANTS)
    for name, src in _build.VARIANTS.items():
        assert _build.source(name) == _build.CSRC / f"{src}.cu" and src in _build.KERNELS
        assert "SVT_VARIANTS" in _build.source(name).read_text()
        assert _build.library_path(name) != _build.library_path(src)


def test_staged_ablations_plain_and_arguments():
    """The staged kernel's ablations: no_recurrence stores the cost (int8,
    clamped at 127) in both directions; the other forms define no values;
    an unknown form or axis raises on any device."""
    cost = torch.from_numpy(RNG.integers(-128, 128, size=(5, 6, 7)).astype(np.int8))
    lf, lb = bench_cuda.aggregate_staged_variants(cost, "no_recurrence")
    assert torch.equal(lf, cost) and torch.equal(lb, cost)
    assert bench_cuda.aggregate_staged_variants(cost, "stage_only") is None
    assert bench_cuda.aggregate_staged_variants(cost, "scan_only", axis=1) is None
    for bad in (dict(form="no_such"), dict(form="scan_only", axis=2)):
        with pytest.raises(ValueError):
            bench_cuda.aggregate_staged_variants(cost, **bad)


def _meta(shape, dtype):
    """A tensor that is neither on the CPU nor on a card: the wrappers'
    argument checks run, and nothing can launch."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("D,raises", [(1025, NotImplementedError), (1024, ValueError)])
def test_register_kernels_take_at_most_1024_disparities(D, raises):
    """Past 1024 disparities (32 a lane in registers) the kernels refuse
    before any other check; at 1024 they go on to the device check."""
    i8, f32 = _meta((2, 3, D), torch.int8), _meta((2, 3, D), torch.float32)
    calls = [lambda: sgm_cuda.aggregate_dual(i8, 8.0, 96.0),
             lambda: sgm_cuda.aggregate_dir(f32, 8.0, 96.0),
             lambda: sgm_cuda.wta_stats_from_duals(i8, i8),
             lambda: sgm_cuda.wta(f32),
             lambda: bench_cuda.sum_wta(i8, i8, i8, i8),
             lambda: bench_cuda.right_disparity_variants(i8, "staged")]
    for call in calls:
        with pytest.raises(raises, match="1024" if raises is NotImplementedError else "CUDA"):
            call()


def test_fused_sum_wta_checks_its_volumes():
    """int8 and int16 volumes go on to the device check; another dtype, a
    shape mismatch, an unknown emit or d_valid outside (0, D] raise before
    anything could launch."""
    i16, i32 = _meta((2, 3, 8), torch.int16), _meta((2, 3, 8), torch.int32)
    i8 = _meta((2, 3, 8), torch.int8)
    for ok in (i8, i16):
        with pytest.raises(ValueError, match="CUDA"):
            sgm_cuda.sum_wta_fused(ok, ok, ok, ok)
    with pytest.raises(TypeError, match="int8 or int16"):
        sgm_cuda.sum_wta_fused(i32, i32, i32, i32)
    with pytest.raises(ValueError, match="shapes"):
        sgm_cuda.sum_wta_fused(i8, i8, i8, i8[:1])
    with pytest.raises(ValueError, match="emit"):
        sgm_cuda.sum_wta_fused(i8, i8, i8, i8, emit="whd")
    with pytest.raises(ValueError, match="d_valid"):
        sgm_cuda.sum_wta_fused(i8, i8, i8, i8, d_valid=0)


def test_aggregate_dir_wta_out_needs_axis_0():
    """As the reference asserts (``sgm_pallas.py:666``), on any device."""
    with pytest.raises(ValueError, match="axis-0"):
        sgm_cuda.aggregate_dir(torch.zeros((4, 5, 8)), 8.0, 96.0, axis=1, wta_out=True)
    with pytest.raises(ValueError, match="axis-0"):
        sgm_cuda.aggregate_dir(_meta((4, 5, 8), torch.float32), 8.0, 96.0, axis=1, wta_out=True)


@pytest.mark.parametrize("reverse,with_acc", [(False, False), (True, True)])
def test_aggregate_dir_wta_out_plain_matches_pallas(pallas, reverse, with_acc):
    """``wta_out``: the statistics of the volume written, against the
    reference's ``aggregate_dir(..., wta_out=True)`` in interpret mode; 13
    rows (not a multiple of its block of 8), D = 128; values 0..6 make ties."""
    import jax.numpy as jnp

    cost = RNG.integers(0, 7, (13, 20, 128)).astype(np.float32)
    acc = RNG.integers(0, 300, (13, 20, 128)).astype(np.float32) if with_acc else None
    ref = pallas.aggregate_dir(jnp.asarray(cost), 8.0, 32.0, axis=0, reverse=reverse,
                               acc=None if acc is None else jnp.asarray(acc), wta_out=True,
                               interpret=True)
    out = sgm_cuda.aggregate_dir(torch.from_numpy(cost), 8.0, 32.0, axis=0, reverse=reverse,
                                 acc=None if acc is None else torch.from_numpy(acc.copy()),
                                 wta_out=True)
    assert len(out) == len(ref) == 6
    for o, r in zip(out, ref):
        assert o.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------


# every templated census window, and runtime ones (an even width, a window
# of exactly 32 bits, three words)
_CENSUS_SIZES = [*sgm_cuda.CENSUS_FORMS, (4, 3), (11, 3), (9, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 150), (19, 426), (13, 128)])
@pytest.mark.parametrize("k,w", _CENSUS_SIZES)
def test_census_words_kernel(cuda, k, w, shape):
    """W = 150 and 426 are not multiples of 4 (rows start off 16-byte
    boundaries) nor of the 128-pixel tile; 37×150 words make a plane that
    shifts the next one's alignment."""
    img = torch.from_numpy(_image(*shape)).to(cuda)
    before = sgm_cuda.launch_counts()["census_words"]
    out = sgm_cuda.census_words(img, k, w)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["census_words"] == before + 1
    assert torch.equal(out, sgm_cuda.census_words_plain(img, k, w))


def _cost_case(D, k, w):
    """A seeded census pair wide enough that every disparity plane of D has
    columns inside the image; rows of an odd D's volume start off 16-byte
    boundaries."""
    h, wd = (24, 140) if D <= 107 else (5, D + 60)
    return (sgm_cuda.census_words(torch.from_numpy(_image(h, wd)), k, w) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", [(5, 5), (7, 5), (9, 9)])
@pytest.mark.parametrize("min_d", [0, 4, -3])
@pytest.mark.parametrize("D", [32, 33, 40, 45, 64, 107, 320, 1024])
def test_cost_volume_kernel(cuda, D, min_d, k, w):
    """nw = 1 (5×5), 2 (7×5) and 3 (9×9, the runtime-nw instance)."""
    cl, cr = (c.to(cuda) for c in _cost_case(D, k, w))
    n_bits = k * w - 1
    before = sgm_cuda.launch_counts()["cost_volume"]
    out = sgm_cuda.cost_volume(cl, cr, D, min_d, n_bits)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["cost_volume"] == before + 1
    assert torch.equal(out, sgm_cuda.cost_volume_plain(cl, cr, D, min_d, n_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 107, 320])
def test_census_and_cost_ablations_kernel(cuda, D):
    """The ablations with a defined output equal their plain versions; each
    launch is counted."""
    img = torch.from_numpy(_image(37, 426)).to(cuda)
    before = sgm_cuda.launch_counts()
    for form in bench_cuda.CENSUS_ABLATIONS:
        got = bench_cuda.census_words_ablations(img, form)
        want = bench_cuda.census_words_ablations_plain(img, form)
        assert want is None or torch.equal(got, want)
    cl, cr = sgm_cuda.census_words(img), sgm_cuda.census_words(img.roll(7, 1).contiguous())
    forms = [f for f in bench_cuda.COST_ABLATIONS if f != "direct" or D % 16 == 0]
    for form in forms:
        got = bench_cuda.cost_volume_ablations(cl, cr, D, 3, 24, form)
        want = bench_cuda.cost_volume_ablations_plain(cl, cr, D, 3, 24, form)
        assert want is None or torch.equal(got, want)
    torch.cuda.synchronize()
    after = sgm_cuda.launch_counts()
    assert after["census_words_ablations"] == before["census_words_ablations"] + 2
    assert after["cost_volume_ablations"] == before["cost_volume_ablations"] + len(forms)


@pytest.mark.cuda
@pytest.mark.parametrize("D,min_d", [(32, 0), (107, 4), (320, -3)])
def test_first_designs_equal_the_shipping_kernels(cuda, D, min_d):
    """bench_cuda's first-design census and cost kernels, and the earlier
    designs of right_disparity (the ``in_place`` variant, on the cost
    volume as an int8 sum) and nearest_valid_lohi (chunk walks, both axes),
    counted apart, give the shipping kernels' outputs."""
    img = torch.from_numpy(_image(37, 426)).to(cuda)
    before = sgm_cuda.launch_counts()
    cl = bench_cuda.census_words_first(img)
    assert torch.equal(cl, sgm_cuda.census_words(img))
    cr = sgm_cuda.census_words(img.roll(5, 1).contiguous())
    cost = bench_cuda.cost_volume_first(cl, cr, D, min_d, 24)
    assert torch.equal(cost, sgm_cuda.cost_volume(cl, cr, D, min_d, 24))
    assert torch.equal(bench_cuda.right_disparity_variants(cost, "in_place", D - min_d % 7),
                       sgm_cuda.right_disparity(cost, D - min_d % 7))
    valid = img > 200
    for axis in (0, 1):
        got = bench_cuda.nearest_valid_lohi_chunks(img, valid, img * 0.5, axis)
        want = sgm_cuda.nearest_valid_lohi(img, valid, img * 0.5, axis)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    after = sgm_cuda.launch_counts()
    for name, n in (("census_words_first", 1), ("cost_volume_first", 1),
                    ("right_disparity_variants", 1), ("nearest_valid_lohi_chunks", 2)):
        assert after[name] == before[name] + n


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
@pytest.mark.parametrize("shape", [(37, 150), (200, 70), (9, 12)])
@pytest.mark.parametrize("nbins", [6, 13, 100])
@pytest.mark.parametrize("k", [3, 15, 21])
def test_speckle_counts_kernel_paths(cuda, k, nbins, shape):
    """Both forms: the column counts (nbins ≤ 16) and the direct form
    (nbins = 100), at tiles cut by the image's edges (200 rows: three
    blocks' 64 and a ragged rest) and at an image smaller than the window."""
    assert sgm_cuda.speckle_design(k, nbins) == ("direct" if nbins > 16 else "columns")
    dv = torch.from_numpy(_dv(*shape)).to(cuda)
    before = sgm_cuda.launch_counts()["speckle_counts"]
    out = sgm_cuda.speckle_counts(dv, k, 32.0, nbins)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["speckle_counts"] == before + 1
    assert torch.equal(out, sgm_cuda.speckle_counts_plain(dv, k, 32.0, nbins))


@pytest.mark.cuda
def test_speckle_design_follows_k_and_nbins(cuda):
    """The column counts hold k ≤ 31 and nbins ≤ 16; the direct form
    takes the rest, and its measurement entry takes any k and nbins."""
    for k, nbins in [(1, 0), (15, 13), (31, 16), (4, 6)]:
        assert sgm_cuda.speckle_design(k, nbins) == "columns"
    for k, nbins in [(33, 6), (15, 17), (45, 300), (3, 64)]:
        assert sgm_cuda.speckle_design(k, nbins) == "direct"
    dv = torch.from_numpy(_dv(40, 75)).to(cuda)
    for k, nbins in [(15, 13), (33, 6), (31, 16), (15, 17)]:
        want = sgm_cuda.speckle_counts_plain(dv, k, 32.0, nbins)
        assert torch.equal(sgm_cuda.speckle_counts(dv, k, 32.0, nbins), want)
        assert torch.equal(bench_cuda.speckle_counts_direct(dv, k, 32.0, nbins), want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [24.0, 7.0, 0.3])
def test_speckle_counts_kernel_divides_as_the_cpu(cuda, r):
    """r is no power of two: the kernel bins with a correctly rounded
    division, as the plain version does on the CPU (on a card PyTorch
    divides a tensor by a Python float through its reciprocal). Values at
    the bins' edges (multiples of r / 2, where floor(v / r) and
    floor(v / r + 0.5) step) and one ulp either side, and values the fast
    division leaves to the slow one (infinities, NaN, huge, denormal)."""
    edges = (np.arange(-20, 300, dtype=np.float32) * np.float32(r / 2)).astype(np.float32)
    rows = [RNG.uniform(-2 * r, 14 * r, size=320).astype(np.float32), edges,
            np.nextafter(edges, np.float32(np.inf)), np.nextafter(edges, np.float32(-np.inf))]
    dv = np.stack([rows[i % 4] for i in range(60)])
    dv[5, :7] = [np.inf, -np.inf, np.nan, 1e30, -1e-40, 0.0, -0.0]
    want = sgm_cuda.speckle_counts_plain(torch.from_numpy(dv), 5, r, 16)
    got = sgm_cuda.speckle_counts(torch.from_numpy(dv).to(cuda), 5, r, 16)
    assert sgm_cuda.speckle_design(5, 16) == "columns"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernels_reject_wrong_dtype(cuda):
    with pytest.raises(TypeError):
        sgm_cuda.census_words(torch.zeros((4, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        sgm_cuda.aggregate_dual(torch.zeros((4, 4, 8), dtype=torch.int16, device=cuda), 8.0, 96.0)


@pytest.mark.cuda
def test_aggregate_dual_kernel_raises_past_512_disparities(cuda):
    """The bound moved from 512 to 1024 (32 values a lane)."""
    before = sgm_cuda.launch_counts()["aggregate_dual"]
    with pytest.raises(NotImplementedError, match="1024"):
        sgm_cuda.aggregate_dual(torch.zeros((2, 3, 1025), dtype=torch.int8, device=cuda), 8.0,
                                96.0)
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
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("D", [1, 32, 33, 107, 320, 1024])
def test_wta_stats_from_duals_kernel_any_d(cuda, D, dtype, offset):
    """G = 1, 2, 4, 16 and 32 lanes a pixel; 13 × 70 pixels are no multiple
    of a block's (256 / G); d_valid = D and below it; negative sums; with
    ``offset`` the volumes start one element past an aligned address, so
    the staging copies their ends byte by byte."""
    lo, hi = (-128, 128) if dtype == torch.int8 else (-600, 600)
    n = 13 * 70 * D
    flat = torch.from_numpy(RNG.integers(lo, hi, size=2 * n + 2)).to(dtype).to(cuda)
    hf = flat[offset:offset + n].view(13, 70, D)
    hb = flat[n + 1 + offset:2 * n + 1 + offset].view(13, 70, D)
    for d_valid in sorted({D, max(1, D - 3), max(1, D // 2)}):
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


# dtype, D, d_valid, (H, W), values ("wide": all of int8 or 0..599; "narrow":
# 0..3, ties everywhere): W < D at W = 140; W not a multiple of the block's
# 128 pixels; each staging form (the span, 16-byte tiles, element tiles at
# D·itemsize not a multiple of 16); more than 65535 rows, in the span and
# in tiles
_RDISP_CASES = [
    (torch.int8, 32, 32, (11, 140), "wide"), (torch.int16, 107, 107, (11, 140), "wide"),
    (torch.int16, 40, 23, (11, 140), "wide"), (torch.int8, 320, 320, (11, 140), "wide"),
    (torch.int16, 320, 320, (11, 140), "wide"), (torch.int16, 1024, 1000, (5, 140), "wide"),
    (torch.int8, 32, 32, (133, 300), "wide"), (torch.int8, 32, 32, (133, 300), "narrow"),
    (torch.int8, 107, 90, (13, 426), "wide"), (torch.int16, 320, 320, (270, 260), "wide"),
    (torch.int16, 320, 300, (9, 600), "narrow"), (torch.int16, 107, 107, (11, 300), "wide"),
    (torch.int8, 1, 1, (3, 40), "wide"), (torch.int8, 2, 2, (70000, 3), "wide"),
    (torch.int8, 32, 32, (65600, 5), "narrow"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,d_valid,shape,values", _RDISP_CASES)
def test_right_disparity_kernel(cuda, dtype, D, d_valid, shape, values):
    lo, hi = (0, 4) if values == "narrow" else (-128, 127) if dtype == torch.int8 else (0, 600)
    s = torch.randint(lo, hi, (*shape, D), dtype=dtype).to(cuda)
    before = sgm_cuda.launch_counts()["right_disparity"]
    got = sgm_cuda.right_disparity(s, d_valid)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["right_disparity"] == before + 1
    assert torch.equal(got, sgm_cuda.right_disparity_plain(s, d_valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,W", [(torch.int8, 32, 300), (torch.int8, 107, 426),
                                       (torch.int16, 320, 260), (torch.int16, 107, 300)])
def test_right_disparity_ablations_kernel(cuda, dtype, D, W):
    """Each ablation launches (counted apart) in each staging form: the
    span, 16-byte tiles, element tiles."""
    s = torch.randint(0, 100, (7, W, D), dtype=dtype).to(cuda)
    before = sgm_cuda.launch_counts()
    for form in bench_cuda.RDISP_ABLATIONS:
        out = bench_cuda.right_disparity_ablations(s, form)
        assert out.shape == (7, W) and out.dtype == torch.int32
    torch.cuda.synchronize()
    after = sgm_cuda.launch_counts()
    assert after["right_disparity_ablations"] == before["right_disparity_ablations"] + 2
    assert after["right_disparity"] == before["right_disparity"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(19, 150), (2, 19, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_shift_gather_kernel(cuda, shape, dtype):
    src = torch.from_numpy(RNG.uniform(-300, 300, size=shape)).to(dtype).to(cuda)
    off = torch.from_numpy(_offsets(19, 150, 40, clipped=False)).to(cuda)
    got = sgm_cuda.shift_gather(src, off, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_cuda.shift_gather_plain(src, off, 40))


# (H, W), the share of valid pixels: lines a multiple of the block's tile
# (1280 = 320·4 along the rows, 768 = 12 tiles of 64 rows down the
# columns) and not (1500; 1283, not a multiple of 4: scalar loads; 771
# rows; 41 columns: a last block of 9; 2500 columns: two tiles of a row),
# lines of length 1, all valid, none valid
_LOHI_CASES = [((37, 1500), 0.02), ((37, 1280), 0.02), ((37, 1283), 0.02), ((768, 40), 0.02),
               ((771, 41), 0.02), ((37, 1), 0.3), ((1, 37), 0.3), ((64, 300), 1.0),
               ((64, 300), 0.0), ((5, 2500), 0.002)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,density", _LOHI_CASES)
@pytest.mark.parametrize("axis", [0, 1])
def test_nearest_valid_lohi_kernel(cuda, axis, shape, density):
    d = torch.from_numpy(RNG.uniform(0, 64, size=shape).astype(np.float32)).to(cuda)
    v = torch.from_numpy(RNG.uniform(size=shape) < density).to(cuda)
    if 0 < density < 1 and min(shape) > 7:
        v[3] = False
        v[:, 7] = False
    up = torch.from_numpy(RNG.uniform(0, 64, size=shape).astype(np.float32)).to(cuda)
    before = sgm_cuda.launch_counts()["nearest_valid_lohi"]
    got = sgm_cuda.nearest_valid_lohi(d, v, up, axis)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["nearest_valid_lohi"] == before + 1
    want = sgm_cuda.nearest_valid_lohi_plain(d, v, up, axis)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((5, 10000), 1), ((9000, 7), 0)])
def test_nearest_valid_lohi_kernel_long_lines(cuda, shape, axis):
    """Lines past 8192 on both axes (no per-position array in shared
    memory); a line with no valid pixel gets d_up on both sides."""
    d = torch.from_numpy(RNG.uniform(0, 64, size=shape).astype(np.float32)).to(cuda)
    v = torch.from_numpy(RNG.uniform(size=shape) < 0.002).to(cuda)
    v[2] = False
    v[:, 3] = False
    up = torch.from_numpy(RNG.uniform(0, 64, size=shape).astype(np.float32)).to(cuda)
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
        with pytest.raises(NotImplementedError, match="1024"):
            fn(torch.zeros((2, 3, 1025), device=cuda), *((8.0, 96.0) if fn is not sgm_cuda.wta
                                                          else ()))
    assert sgm_cuda.launch_counts() == before


# ---------------------------------------------------------------------------
# Up to 1024 disparities, and aggregate_dir's wta_out (on a card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("D", [640, 1000, 1024])
@pytest.mark.parametrize("axis", [0, 1])
def test_aggregate_dual_kernel_past_512(cuda, D, axis):
    """32 values a lane (V = 20, 32, 32); int8 stores reach the clamp."""
    cost = torch.from_numpy(RNG.integers(0, 61, size=(9, 12, D)).astype(np.int8)).to(cuda)
    for dtype in (torch.int8, torch.int16):
        got = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=axis, out_dtype=dtype)
        torch.cuda.synchronize()
        want = sgm_cuda.aggregate_dual_plain(cost, 8.0, 96.0, axis=axis, out_dtype=dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [640, 1024])
def test_register_kernels_past_512(cuda, D):
    """aggregate_dir (both axes, with acc), the chain mode, wta_stats_from_duals
    (int8, d_valid < D) and wta at 640 and 1024 disparities."""
    costf = torch.from_numpy(RNG.integers(0, 40, size=(7, 11, D)).astype(np.float32)).to(cuda)
    acc = torch.from_numpy(RNG.integers(0, 500, size=(7, 11, D)).astype(np.float32)).to(cuda)
    for axis in (0, 1):
        got = sgm_cuda.aggregate_dir(costf, 8.0, 96.0, axis, True, acc.clone())
        assert torch.equal(got, sgm_cuda.aggregate_dir_plain(costf, 8.0, 96.0, axis, True,
                                                             acc.clone()))
    cost = torch.from_numpy(RNG.integers(0, 61, size=(7, 11, D)).astype(np.int8)).to(cuda)
    bf, bb = _seeds((11, D), cuda), _seeds((11, D), cuda)
    got = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, boundary=(bf, bb), return_final=True)
    want = sgm_cuda.aggregate_dual_plain(cost, 8.0, 96.0, boundary=(bf, bb), return_final=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    hf, hb = (torch.from_numpy(RNG.integers(0, 128, size=(7, 11, D)).astype(np.int8)).to(cuda)
              for _ in range(2))
    got = sgm_cuda.wta_stats_from_duals(hf, hb, D - 37)
    want = sgm_cuda.wta_stats_from_duals_plain(hf, hb, D - 37)
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    agg = torch.from_numpy(RNG.integers(0, 7, size=(7, 11, D)).astype(np.float32)).to(cuda)
    assert all(torch.equal(g, w) for g, w in zip(sgm_cuda.wta(agg), sgm_cuda.wta_plain(agg)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 45, 320, 1024])
@pytest.mark.parametrize("reverse,with_acc", [(False, False), (True, True)])
def test_aggregate_dir_wta_out_kernel(cuda, D, reverse, with_acc):
    """The statistics the kernel takes from each row it stores equal
    aggregate_dir followed by wta; values 0..6 make ties."""
    cost = torch.from_numpy(RNG.integers(0, 7, size=(21, 37, D)).astype(np.float32)).to(cuda)
    acc = (torch.from_numpy(RNG.integers(0, 50, size=(21, 37, D)).astype(np.float32)).to(cuda)
           if with_acc else None)
    before = sgm_cuda.launch_counts()["aggregate_dir"]
    got = sgm_cuda.aggregate_dir(cost, 8.0, 96.0, 0, reverse,
                                 None if acc is None else acc.clone(), wta_out=True)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["aggregate_dir"] == before + 1
    out = sgm_cuda.aggregate_dir(cost, 8.0, 96.0, 0, reverse, None if acc is None else acc.clone())
    want = (out, *sgm_cuda.wta(out))
    plain = sgm_cuda.aggregate_dir_wta_plain(cost, 8.0, 96.0, 0, reverse,
                                             None if acc is None else acc.clone())
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, p)


# ---------------------------------------------------------------------------
# aggregate_dual's staging ring and shift_gather's two paths, at the edges
# of their chunks, vectors and alignment (on a card)
# ---------------------------------------------------------------------------


def _int8_cost(shape, device, crop: int = 0):
    """Costs 0..60 (with P2 = 96 the int8 stores reach their clamp);
    ``crop`` rows off each end give a contiguous view whose base is not
    16-byte aligned when a row's bytes are not a multiple of 16, as
    ``cost[crop:-crop]`` in ``stereo.sgm`` does."""
    h, w, d = shape
    full = torch.from_numpy(RNG.integers(0, 61, size=(h + 2 * crop, w, d)).astype(np.int8))
    full = full.to(device)
    return full[crop:h + crop] if crop else full


def _dual_equal(cost, dtype, axis, **kw):
    before = sgm_cuda.launch_counts()
    got = sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=axis, out_dtype=dtype, **kw)
    torch.cuda.synchronize()
    name = "aggregate_dual_chain" if kw else "aggregate_dual"
    assert sgm_cuda.launch_counts()[name] == before[name] + 1
    want = sgm_cuda.aggregate_dual_plain(cost, 8.0, 96.0, axis=axis, out_dtype=dtype, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# (axis, (H, W, D), rows cropped off each end): lines of many chunks (2 to
# 32 steps a chunk) with a ragged last chunk and a ragged last block of
# lines (9 rows, 13 columns); one step, and fewer steps than a chunk (32 at
# D=32, 14 at D=107); a cost[1:-1] view with odd D, whose base and line
# starts are off 16 bytes (int16 rows of odd D too)
_CHUNK_EDGES = ([(axis, (*shape, D), 0) for D in (1, 32, 33, 107, 320, 1024)
                 for axis, shape in ((1, (9, 517)), (0, (301, 13)))]
                + [(0, (S, 11, D), 0) for S in (1, 5) for D in (32, 107)]
                + [(1, (6, S, D), 0) for S in (1, 5) for D in (32, 107)]
                + [(axis, (37, 45, D), 1) for axis in (0, 1) for D in (33, 107)])


@pytest.mark.cuda
@pytest.mark.parametrize("axis,shape,crop", _CHUNK_EDGES)
def test_aggregate_dual_kernel_chunk_edges(cuda, axis, shape, crop):
    cost = _int8_cost(shape, cuda, crop)
    assert cost.is_contiguous() and (crop == 0 or cost.data_ptr() % 16 != 0)
    for dtype in (torch.int8, torch.int16):
        _dual_equal(cost, dtype, axis)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 107, 320])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_aggregate_dual_chain_kernel_many_chunks(cuda, dtype, D):
    """Chain mode over lines of many chunks: nonzero seeds, ``cost_b``, the
    final carries, and a cropped (unaligned) forward volume."""
    cost = _int8_cost((131, 13, D), cuda, crop=1)
    cost_b = _int8_cost((131, 13, D), cuda)
    bf, bb = _seeds((13, D), cuda), _seeds((13, D), cuda)
    _dual_equal(cost, dtype, 0, boundary=(bf, bb), return_final=True, cost_b=cost_b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 107, 320])
@pytest.mark.parametrize("p1,p2", [(8.0, 96.0), (7.5, 96.25), (-3.0, 96.0)])
def test_aggregate_dual_kernel_any_values(cuda, p1, p2, D):
    """Costs over all of int8 and seeds below 0 (the kernel's exact-integer
    mode takes the bits of positive floats, so a seeded first step takes
    keys), and penalties that are not non-negative integers (the general
    mode: no shift, keyed min, converting stores)."""
    cost = torch.from_numpy(RNG.integers(-128, 128, size=(41, 37, D)).astype(np.int8)).to(cuda)
    seeds = tuple(_seeds((37, D), cuda) - 40.0 for _ in range(2))
    for axis, dtype, kw in ((1, torch.int8, {}), (0, torch.int16, {}),
                            (0, torch.int8, dict(boundary=seeds, return_final=True))):
        got = sgm_cuda.aggregate_dual(cost, p1, p2, axis=axis, out_dtype=dtype, **kw)
        torch.cuda.synchronize()
        want = sgm_cuda.aggregate_dual_plain(cost, p1, p2, axis=axis, out_dtype=dtype, **kw)
        assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 107, 320])
@pytest.mark.parametrize("axis", [0, 1])
def test_aggregate_staged_ablations_kernel(cuda, axis, D):
    """no_recurrence is exact against its plain version; the other two
    forms launch (counted) and define no values; past 384 disparities the
    ablations refuse before any launch."""
    cost = torch.from_numpy(RNG.integers(0, 61, size=(37, 45, D)).astype(np.int8)).to(cuda)
    before = sgm_cuda.launch_counts()["aggregate_staged_variants"]
    for form in bench_cuda.STAGED_FORMS:
        got = bench_cuda.aggregate_staged_variants(cost, form, axis=axis)
        torch.cuda.synchronize()
        want = bench_cuda.aggregate_staged_variants_plain(cost, form)
        if want is not None:
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sgm_cuda.launch_counts()["aggregate_staged_variants"] == before + 3
    with pytest.raises(NotImplementedError, match="384"):
        bench_cuda.aggregate_staged_variants(torch.zeros((2, 3, 385), dtype=torch.int8,
                                                         device=cuda), "scan_only")


def _edge_offsets(h, w, max_offset):
    """Offsets at every edge of the range, row by row: off = x (the first
    column), max_offset − 1, negative, ≥ max_offset, then random ones."""
    off = RNG.integers(-6, max_offset + 25, size=(h, w)).astype(np.int32)
    x = np.arange(w)
    off[0], off[1] = x, max_offset - 1
    off[2], off[3] = -1 - x % 3, max_offset + x % 3
    return off


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("W", [148, 150])
def test_shift_gather_kernel_paths(cuda, W, B, dtype, aligned):
    """W % 4 = 0 takes the 16-byte path where the offsets are aligned (the
    row path otherwise), W = 150 the row path; an unaligned source and
    unaligned offsets come from views one element into a buffer."""
    H, mx = 9, 40
    shape = (B, H, W) if B > 1 else (H, W)
    n = B * H * W
    skip = 0 if aligned else 1
    src_buf = torch.from_numpy(RNG.uniform(-300, 300, size=n + 1)).to(dtype).to(cuda)
    src = src_buf[skip:skip + n].view(shape)
    off_buf = np.zeros(H * W + 1, dtype=np.int32)
    off_buf[skip:skip + H * W] = _edge_offsets(H, W, mx).ravel()
    off = torch.from_numpy(off_buf).to(cuda)[skip:skip + H * W].view(H, W)
    assert (src.data_ptr() % 16 == 0) == aligned and (off.data_ptr() % 16 == 0) == aligned
    before = sgm_cuda.launch_counts()["shift_gather"]
    got = sgm_cuda.shift_gather(src, off, mx)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["shift_gather"] == before + 1
    assert got.dtype == dtype and torch.equal(got, sgm_cuda.shift_gather_plain(src, off, mx))


# ---------------------------------------------------------------------------
# The measurement kernels of bench_cuda against their plain versions, at
# ragged shapes: D not a multiple of 32, lines and pixels not a multiple of
# the warps per block (on a card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("D", [29, 32, 45, 128])
@pytest.mark.parametrize("variant", list(bench_cuda.AGG_VARIANTS))
def test_aggregate_dual_variant_kernel(cuda, variant, D):
    if variant == "gm_interleave5" and D > 32:
        pytest.skip("gm_interleave5 carries lines of at most 32 planes")
    cost = torch.from_numpy(RNG.integers(0, 61, size=(23, 37, D)).astype(np.int8)).to(cuda)
    if variant == "f32in":
        cost = cost.float()
    before = sgm_cuda.launch_counts()["aggregate_dual_variants"]
    got = bench_cuda.aggregate_dual_variants(cost, variant, 8.0, 96.0, bs=4)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["aggregate_dual_variants"] == before + 1
    want = bench_cuda.aggregate_dual_variants_plain(cost, variant, 8.0, 96.0, bs=4)
    assert len(got) == len(want)
    assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [200, 320])
def test_aggregate_dual_earlier_design_past_128(cuda, D):
    """The earlier design's shipping kernel (the ``shipping`` variant) takes
    D ≤ 384, to be timed beside the staged kernel at the full search's D;
    the other variants stay at 128."""
    cost = torch.from_numpy(RNG.integers(0, 61, size=(23, 37, D)).astype(np.int8)).to(cuda)
    got = bench_cuda.aggregate_dual_variants(cost, "shipping", 8.0, 96.0)
    torch.cuda.synchronize()
    want = bench_cuda.aggregate_dual_variants_plain(cost, "shipping", 8.0, 96.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, sgm_cuda.aggregate_dual(
        cost, 8.0, 96.0, axis=0, out_dtype=torch.int8)))
    with pytest.raises(NotImplementedError):
        bench_cuda.aggregate_dual_variants(cost, "copy")


@pytest.mark.cuda
@pytest.mark.parametrize("D,d_valid", [(32, 32), (45, 30), (128, 128)])
@pytest.mark.parametrize("variant", list(bench_cuda.WTA_VARIANTS))
def test_wta_stats_variant_kernel(cuda, variant, D, d_valid):
    hf, hb = (torch.from_numpy(RNG.integers(0, 128, size=(13, 71, D)).astype(np.int8)).to(cuda)
              for _ in range(2))
    got = bench_cuda.wta_stats_variants(hf, hb, variant, d_valid)
    torch.cuda.synchronize()
    want = bench_cuda.wta_stats_variants_plain(hf, hb, variant, d_valid)
    assert len(got) == len(want)
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,d_valid", [(torch.int8, 32, 32), (torch.int16, 107, 90),
                                             (torch.int16, 320, 320), (torch.int16, 1024, 1000)])
@pytest.mark.parametrize("variant", list(bench_cuda.RDISP_VARIANTS))
def test_right_disparity_variant_kernel(cuda, variant, dtype, D, d_valid):
    """W = 140: shorter than the staged band at D = 320 (the last columns
    reach few planes); values make ties."""
    lo, hi = (-128, 127) if dtype == torch.int8 else (0, 600)
    s = torch.randint(lo, hi, (5, 140, D), dtype=dtype).to(cuda)
    arg = s.permute(2, 0, 1).contiguous() if variant == "transposed" else s
    got = bench_cuda.right_disparity_variants(arg, variant, d_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, sgm_cuda.right_disparity_plain(s, d_valid))


# (dtype, H, W, D, d_valid): the first four the first design's cases; D
# from 1 to 1024 over every instance of the design (sgm_cuda.sum_wta_design),
# W * D * itemsize mostly not a multiple of 16, H = 1, d_valid < D
SUM_CASES = [(torch.int8, 7, 13, 40, 40), (torch.int8, 7, 13, 45, 30),
             (torch.int8, 7, 13, 384, 320), (torch.int8, 7, 13, 1024, 1000),
             (torch.int8, 5, 33, 1, 1), (torch.int16, 5, 33, 1, 1),
             (torch.int8, 6, 29, 31, 31), (torch.int16, 6, 29, 31, 20),
             (torch.int8, 3, 31, 64, 64), (torch.int16, 3, 21, 100, 97),
             (torch.int8, 9, 37, 107, 107), (torch.int16, 9, 37, 107, 100),
             (torch.int8, 1, 77, 107, 107), (torch.int16, 2, 23, 200, 200),
             (torch.int8, 4, 61, 320, 320), (torch.int16, 4, 61, 320, 320),
             (torch.int16, 3, 17, 320, 200), (torch.int8, 3, 19, 321, 321),
             (torch.int16, 3, 19, 321, 300), (torch.int8, 2, 5, 640, 640),
             (torch.int16, 2, 9, 1024, 1024), (torch.int16, 1, 3, 1024, 999)]


def _sum_volumes(dtype, H, W, D, lo=0, hi=None, device=None):
    """Four seeded volumes: int8 in [0, 120), int16 in [0, 20000) (sums
    past the 30000 clamp), unless lo and hi say otherwise."""
    hi = hi if hi is not None else (120 if dtype == torch.int8 else 20000)
    np_dtype = np.int8 if dtype == torch.int8 else np.int16
    return [torch.from_numpy(RNG.integers(lo, hi, size=(H, W, D)).astype(np_dtype)).to(device)
            for _ in range(4)]


def _assert_sum_equal(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,W,D,d_valid", SUM_CASES)
@pytest.mark.parametrize("emit", list(sgm_cuda.SUM_EMITS))
def test_sum_wta_kernel(cuda, emit, dtype, H, W, D, d_valid):
    vols = _sum_volumes(dtype, H, W, D, device=cuda)
    before = sgm_cuda.launch_counts()["sum_wta"]
    got = sgm_cuda.sum_wta_fused(*vols, d_valid=d_valid, emit=emit)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["sum_wta"] == before + 1
    _assert_sum_equal(got, sgm_cuda.sum_wta_fused_plain(*vols, d_valid=d_valid, emit=emit))
    assert bench_cuda.sum_wta is sgm_cuda.sum_wta_fused


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lo,hi", [(torch.int8, 0, 2), (torch.int8, -128, 128),
                                         (torch.int16, 0, 1), (torch.int16, -8000, 8000)])
@pytest.mark.parametrize("D,d_valid", [(16, 16), (107, 90), (320, 320), (1024, 1024)])
@pytest.mark.parametrize("emit", list(sgm_cuda.SUM_EMITS))
def test_sum_wta_kernel_ties_and_signs(cuda, emit, D, d_valid, dtype, lo, hi):
    """Ties everywhere (values 0 and 1, or all 0) go to the smallest d, as
    in the plain version; negative sums key and store as it does."""
    vols = _sum_volumes(dtype, 3, 41, D, lo, hi, device=cuda)
    got = sgm_cuda.sum_wta_fused(*vols, d_valid=d_valid, emit=emit)
    torch.cuda.synchronize()
    _assert_sum_equal(got, sgm_cuda.sum_wta_fused_plain(*vols, d_valid=d_valid, emit=emit))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,W,D,d_valid", SUM_CASES[::3])
@pytest.mark.parametrize("emit", list(sgm_cuda.SUM_EMITS))
def test_sum_wta_first_design_kernel(cuda, emit, dtype, H, W, D, d_valid):
    """The first design (a warp a pixel, templated on the item size) computes
    the shipping kernel's function."""
    vols = _sum_volumes(dtype, H, W, D, device=cuda)
    before = sgm_cuda.launch_counts()["sum_wta_first"]
    got = bench_cuda.sum_wta_first(*vols, d_valid=d_valid, emit=emit)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["sum_wta_first"] == before + 1
    _assert_sum_equal(got, sgm_cuda.sum_wta_fused_plain(*vols, d_valid=d_valid, emit=emit))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,W,D,d_valid", SUM_CASES[1::4])
@pytest.mark.parametrize("form", list(bench_cuda.SUM_ABLATIONS))
def test_sum_wta_ablations_kernel(cuda, form, dtype, H, W, D, d_valid):
    """Each ablation launches; no_store's statistics are the plain ones."""
    vols = _sum_volumes(dtype, H, W, D, device=cuda)
    before = sgm_cuda.launch_counts()["sum_wta_ablations"]
    got = bench_cuda.sum_wta_ablations(*vols, form, d_valid)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["sum_wta_ablations"] == before + 1
    want = bench_cuda.sum_wta_ablations_plain(*(v.cpu() for v in vols), form, d_valid)
    if want is None:
        assert got is None
    else:
        assert got[0].shape == (H, W, D) and got[0].dtype == torch.int16
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got[1:], want[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("change", [{"lr_max_diff": -1}, {}, {"p1": 7.0, "p2": 110.0}])
def test_full_search_frames_launch_sum_wta_once(cuda, monkeypatch, change):
    """The full search (paths=4; LR off, on, and int16 path volumes) sends
    its four volumes to the kernel once a frame and never calls the plain
    sgm_cuda.sum_wta; the frame equals the plain path's on the card."""
    import dataclasses

    from stereovision_tpu_torch import stereo

    base = RNG.uniform(0, 255, size=(40, 77)).astype(np.float32)
    left, right = base[:, :72], base[:, 5:77]
    p = dataclasses.replace(stereo.SGMParams(num_disparities=32), **change)

    def plain(*a, **kw):
        raise AssertionError("the plain sum_wta ran on the full search")

    want = stereo.compute_disparity(left, right, dataclasses.replace(p, impl="xla"))
    monkeypatch.setattr(sgm_cuda, "sum_wta", plain)
    sgm_cuda.reset_launch_counts()
    disp, valid = stereo.compute_disparity(left, right, p)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["sum_wta"] == 1
    assert torch.equal(valid, want[1])
    assert (disp - want[0]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_measurement_kernels_reject_bad_inputs(cuda):
    before = sgm_cuda.launch_counts()
    i16 = torch.zeros((4, 5, 32), dtype=torch.int16, device=cuda)
    i32 = torch.zeros((4, 5, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bench_cuda.sum_wta(i32, i32, i32, i32)
    with pytest.raises(TypeError):
        bench_cuda.sum_wta_first(i32, i32, i32, i32)
    with pytest.raises(TypeError):
        bench_cuda.aggregate_dual_variants(i16, "shipping")
    with pytest.raises(TypeError):
        bench_cuda.wta_stats_variants(i16, i16, "base")
    with pytest.raises(NotImplementedError):
        bench_cuda.aggregate_dual_variants(torch.zeros((4, 5, 33), dtype=torch.int8, device=cuda),
                                           "gm_interleave5")
    with pytest.raises(ValueError):
        bench_cuda.right_disparity_variants(i16.transpose(0, 1), "in_place")
    assert sgm_cuda.launch_counts() == before


# ---------------------------------------------------------------------------
# The kernels on the paths of agg_wseg and the separable remap
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seg", [((24, 1280, 32), 5), ((16, 256, 107), 2),
                                       ((9, 640, 32), 5)])
def test_aggregate_dual_kernel_on_the_segmented_view(cuda, shape, seg):
    """#4 on ``agg_wseg``'s (H·seg, W/seg, D) view of a cost volume: each
    segment's scans restart at its first column, as on separate volumes."""
    H, W, D = shape
    cost = torch.from_numpy(RNG.integers(0, 61, size=shape).astype(np.int8)).to(cuda)
    view = cost.reshape(H * seg, W // seg, D)
    got = sgm_cuda.aggregate_dual(view, 8.0, 96.0, axis=1, out_dtype=torch.int8)
    torch.cuda.synchronize()
    want = sgm_cuda.aggregate_dual_plain(view, 8.0, 96.0, axis=1, out_dtype=torch.int8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    first = sgm_cuda.aggregate_dual_plain(cost[:, :W // seg].contiguous(), 8.0, 96.0, axis=1,
                                          out_dtype=torch.int8)
    assert torch.equal(got[0].reshape(H, W, D)[:, :W // seg], first[0])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(64, 200), (720, 1280)])
def test_remap_separable_runs_shift_gather(cuda, H, W, monkeypatch):
    """``remap_separable`` on the card: four #7 launches (two a pass),
    equal bit for bit to the same passes through #7's plain version on
    the card."""
    from stereovision_tpu_torch.core import image as im

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mx = (1.01 * xx + 3.0 * np.sin(yy / 23.0) - 4.0).astype(np.float32)
    my = (yy + 2.0 * np.cos(xx / 37.0) - 0.7).astype(np.float32)
    img = np.cumsum(RNG.uniform(-3, 3, (H, W)), axis=1).astype(np.float32)
    my_adj, valid, rx, ry = im.prepare_separable_remap(mx, my)
    args = [torch.from_numpy(a).to(cuda) for a in (img, mx, my_adj, valid)]
    sgm_cuda.reset_launch_counts()
    got = im.remap_separable(*args, rx, ry)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["shift_gather"] == 4
    monkeypatch.setattr(sgm_cuda, "shift_gather", sgm_cuda.shift_gather_plain)
    assert torch.equal(got, im.remap_separable(*args, rx, ry))


# ---------------------------------------------------------------------------
# The median filter
# ---------------------------------------------------------------------------

# the kinds of map the median is held on: random floats; NaN of both signs,
# ±inf and ±0 among them; plateaus of a few values (ties everywhere)
MEDIAN_KINDS = ("random", "special", "plateau")


def _median_input(kind: str, h: int, w: int) -> np.ndarray:
    img = RNG.uniform(-300, 300, size=(h, w)).astype(np.float32)
    if kind == "special":
        special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
        pick = RNG.uniform(size=(h, w)) < 0.3
        img[pick] = RNG.choice(special, size=int(pick.sum()))
    elif kind == "plateau":
        img = np.array([-1.0, 0.0, -0.0, 40.0], np.float32)[
            np.repeat(RNG.integers(0, 4, size=(h, w // 8 + 1)), 8, axis=1)[:, :w]]
    return img


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 map's bits: NaN payloads and signed zeros compared too."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", MEDIAN_KINDS)
@pytest.mark.parametrize("shape", [(37, 150), (1, 1), (1, 9), (9, 1), (2, 3), (4, 2)])
def test_median_blur_on_the_cpu_is_the_plain_network(k, kind, shape):
    img = torch.from_numpy(_median_input(kind, *shape))
    before = sgm_cuda.launch_counts()
    out = sgm_cuda.median_blur(img, k)
    assert out.dtype == torch.float32 and out.shape == shape
    assert torch.equal(_bits(out), _bits(sgm_cuda.median_blur_plain(img, k)))
    assert sgm_cuda.launch_counts() == before


@pytest.mark.parametrize("n,pairs", [(9, 24), (25, 113)])
def test_median_kernel_bakes_the_plain_network(n, pairs):
    """The compare-exchanges of ``csrc/median.cu`` are
    ``core.image._median_pairs(n)``, in order: the kernel and the plain
    network cannot drift apart."""
    from stereovision_tpu_torch.core import image as im

    src = (_build.CSRC / "median.cu").read_text()
    body = re.search(rf"#define SVT_MEDIAN_PAIRS_{n}\(X\)((?:[^\n]*\\\n)*[^\n]*)", src)
    baked = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body.group(1)))
    assert baked == im._median_pairs(n)
    assert len(baked) == pairs
    assert set(sgm_cuda.MEDIAN_SIZES) == {3, 5} and "median" in _build.KERNELS


def _rig(w: int, h: int, f: float = 700.0, tx: float = -6.0) -> dict:
    """An identity-rectified rig: focal length f px, baseline tx cm along x."""
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    P2 = np.hstack([K, np.zeros((3, 1))])
    P2[0, 3] = tx * f
    return {"mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5),
            "dist_right": np.zeros(5), "R": np.eye(3), "T": np.array([[tx], [0.0], [0.0]]),
            "R1": np.eye(3), "R2": np.eye(3), "P1": np.hstack([K, np.zeros((3, 1))]),
            "P2": P2, "img_size": np.array([w, h])}


def _median_frame_params(mode: str):
    import dataclasses

    from stereovision_tpu_torch.stereo import SGMParams, production_preset

    if mode.startswith("production"):
        return dataclasses.replace(production_preset(), num_disparities=64)
    return SGMParams(num_disparities=32, impl="xla" if mode == "full-xla" else "auto")


@pytest.mark.parametrize("mode,h,w,calls", [
    ("production-stacked", 48, 192, 3), ("production-two-passes", 40, 192, 3),
    ("full", 48, 128, 1), ("full-xla", 48, 128, 0)])
def test_depth_frames_send_each_median_to_the_wrapper(monkeypatch, mode, h, w, calls):
    """A production frame takes three medians through ``sgm_cuda.median_blur``
    (the coarse search's, the coarse fill's, the fill's), a full-search frame
    one, ``impl="xla"`` none (the plain network): each a contiguous (H, W)
    float32 map at a size the kernel takes, as a card's launch needs. The
    frame equals the one whose medians all run the plain network."""
    from stereovision_tpu_torch.pipeline import DepthPipeline

    seen = []
    wrapper = sgm_cuda.median_blur

    def spy(img, ksize=5):
        seen.append((img.dim(), img.dtype, img.is_contiguous(), ksize))
        return wrapper(img, ksize)

    base = RNG.integers(0, 256, (h, w + 6), dtype=np.uint8)
    left, right = np.ascontiguousarray(base[:, 6:]), np.ascontiguousarray(base[:, :w])
    pipe = DepthPipeline(_rig(w, h), _median_frame_params(mode), device="cpu")
    monkeypatch.setattr(sgm_cuda, "median_blur", spy)
    got = pipe(left, right)
    assert len(seen) == calls
    assert all(c[:3] == (2, torch.float32, True) and c[3] in sgm_cuda.MEDIAN_SIZES
               for c in seen)
    monkeypatch.setattr(sgm_cuda, "median_blur", sgm_cuda.median_blur_plain)
    want = pipe(left, right)
    assert torch.equal(got.disparity, want.disparity)
    assert torch.equal(got.confidence, want.confidence)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", MEDIAN_KINDS)
@pytest.mark.parametrize("shape", [(720, 1280), (240, 426)])
def test_median_blur_kernel(cuda, k, kind, shape):
    """The kernel at the production frame's shapes equals the plain network
    on the card bit for bit, and counts one launch a call."""
    img = torch.from_numpy(_median_input(kind, *shape)).to(cuda)
    before = sgm_cuda.launch_counts()["median"]
    out = sgm_cuda.median_blur(img, k)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["median"] == before + 1
    assert out.shape == shape and out.dtype == torch.float32
    assert torch.equal(_bits(out), _bits(sgm_cuda.median_blur_plain(img, k)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("kind", MEDIAN_KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (1, 1280), (720, 1), (2, 3), (4, 2), (3, 5), (5, 3),
                                   (17, 33), (1100000, 1)])
def test_median_blur_kernel_narrow_and_ragged(cuda, k, kind, shape):
    """Maps narrower than the window (replicate borders on both sides of a
    single row or column), tiles cut by the edges, and a column of more
    rows than the grid holds (the blocks walk the rest)."""
    img = torch.from_numpy(_median_input(kind, *shape)).to(cuda)
    out = sgm_cuda.median_blur(img, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(sgm_cuda.median_blur_plain(img, k)))


@pytest.mark.cuda
def test_median_blur_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((8, 10), device=cuda)
    before = sgm_cuda.launch_counts()
    for bad in (x.t(), x[:, ::2], x[None]):
        with pytest.raises(ValueError):
            sgm_cuda.median_blur(bad, 5)
    with pytest.raises(ValueError):
        sgm_cuda.median_blur(x, 7)
    with pytest.raises(TypeError):
        sgm_cuda.median_blur(x.double(), 5)
    assert sgm_cuda.launch_counts() == before
    assert sgm_cuda.median_blur(torch.zeros((0, 10), device=cuda), 5).shape == (0, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,launches", [("production", 3), ("full", 1)])
def test_depth_frames_launch_the_median(cuda, monkeypatch, mode, launches):
    """A 720p production frame through ``DepthPipeline`` launches the median
    three times, a full-search frame once; the frame equals the one whose
    medians run the plain network on the card, bit for bit (run eagerly: a
    replayed graph would launch the kernel it captured)."""
    from stereovision_tpu_torch.pipeline import DepthPipeline
    from stereovision_tpu_torch.stereo import sgm

    h, w = 720, 1280
    base = RNG.integers(0, 256, (h, w + 40), dtype=np.uint8)
    left, right = np.ascontiguousarray(base[:, 40:]), np.ascontiguousarray(base[:, :w])
    from stereovision_tpu_torch.stereo import SGMParams, production_preset

    params = production_preset() if mode == "production" else SGMParams(num_disparities=320)
    pipe = DepthPipeline(_rig(w, h), params)
    pipe(left, right)  # builds the libraries
    sgm_cuda.reset_launch_counts()
    got = pipe(left, right)
    torch.cuda.synchronize()
    assert sgm_cuda.launch_counts()["median"] == launches
    monkeypatch.setattr(sgm_cuda, "median_blur", sgm_cuda.median_blur_plain)
    sgm.GRAPHS.reset()
    want = pipe(left, right)
    for a, b in zip((got.disparity, got.confidence, got.depth_m),
                    (want.disparity, want.confidence, want.depth_m)):
        assert torch.equal(_bits(a), _bits(b))
