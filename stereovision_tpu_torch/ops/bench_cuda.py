"""Measurement kernels: the counterparts of the Pallas kernels of the JAX
package's four TPU measurement scripts, each beside its plain version.

- :func:`sum_wta` ← ``scripts/bench_sumwta.py:110`` (``make_pallas``): the
  engine's ``sgm_cuda.sum_wta_fused`` (``csrc/sum_wta.cu``), under the name
  the measurement script calls; :func:`sum_wta_first`, its first design (a
  warp a pixel), and :func:`sum_wta_ablations`, the shipping kernel with a
  part taken out (no TPU counterpart).
- :func:`aggregate_dual_variants` ← ``scripts/bench_agg_step.py:216``:
  ablations of ``aggregate_dual``'s recurrence (``csrc/aggregate.cu``), on
  the earlier design of that kernel, the one the script's variants were
  written against.
- :func:`aggregate_staged_variants`: the shipping (staged) ``aggregate_dual``
  with its recurrence, its scan or its staging and flushing taken out (no
  TPU counterpart: they say which part of that design holds its time).
- :func:`wta_stats_variants` ← ``scripts/bench_wta_variants.py:149``:
  ablations of ``wta_stats_from_duals`` (``csrc/wta_stats.cu``), on the
  earlier design of that kernel (a warp a pixel), the one the script's
  variants were written against; ``base`` is that design as it shipped.
- :func:`speckle_counts_direct`: ``speckle_counts``' earlier design (the
  direct k×k form of ``csrc/speckle.cu``) at any k and nbins, timed beside
  the shipping column counts (no TPU counterpart).
- :func:`census_words_first` and :func:`cost_volume_first`: the first
  designs of ``census_words`` and ``cost_volume`` (a thread a pixel; four
  disparities a thread), timed beside the shipping kernels, and
  :func:`census_words_ablations` / :func:`cost_volume_ablations`: the
  shipping kernels with one part taken out (no TPU counterpart).
- :func:`right_disparity_ablations`: the shipping ``right_disparity``
  (diagonal boxes) with its staging or its walk taken out (no TPU
  counterpart).
- :func:`right_disparity_variants` ← ``scripts/bench_rdisp.py:84``:
  ``right_disparity`` read in place (its first design), from a (D, H, W)
  copy, through a band staged in shared memory, and as the shipping
  diagonal boxes (``csrc/right_disparity.cu``).
- :func:`nearest_valid_lohi_chunks`: ``nearest_valid_lohi``'s earlier
  design (chunk walks, ``csrc/nearest_lohi.cu``), timed beside the
  shipping scans (no TPU counterpart).

The variant families, the ablations and ``sum_wta_first`` are compile-time
variants of the shipping kernels, built into libraries of their own
(``_build.VARIANTS``); the
variant named ``boxes`` is the shipping ``right_disparity`` kernel itself,
``in_place``, ``shipping`` and ``base`` the earlier designs of
``right_disparity``, ``aggregate_dual`` and ``wta_stats_from_duals``. No
engine path launches any of these (``sum_wta`` is the engine's own wrapper,
counted as ``sum_wta``): they are what the scripts of
``stereovision_tpu_torch.scripts`` and ``chip_smoke.py`` time. As in :mod:`.sgm_cuda`, a wrapper
sends a CPU tensor to its plain version and launches its kernel on a CUDA
tensor (no fallback), and adds one to its count in
``sgm_cuda.launch_counts()`` at each launch.

Some variants compute another function than the shipping kernel on
purpose, as the script's do (no_groupmin, no_shifts, no_store, full_norm,
copy, f32sum's sentinel, bestonly, sumonly); each plain version computes
that function exactly, so the CPU tests hold it against the script's own
kernel. Left out, with no GPU counterpart: ``bench_agg_step``'s
``gm_slice``, ``gm_cat`` and ``gm_interleave`` (ways of laying 4 disparity
groups across the TPU's 128 lanes; the script marks ``gm_interleave``
WRONG: it reduces 4 of a group's 32 values) and ``bench_wta_variants``'
packed output layout (a TPU store layout; the port writes five maps, which
is the script's ``unpacked``).
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.ops.sgm_cuda import (_BIGI, _MASKED, _P, _F, _I, _L, _check,
                                                 _check_d_valid, _float_stats, _launch,
                                                 _launches, _renorm, _scan, _sgm_step_norm,
                                                 _store, _wta_stats)

# ---------------------------------------------------------------------------
# Fused sum of four volumes + winner statistics: the first design, ablations
# ---------------------------------------------------------------------------

# the engine's wrapper (sgm_cuda.sum_wta_fused) and its plain version, under
# the names the measurement script calls
sum_wta, sum_wta_plain = sgm_cuda.sum_wta_fused, sgm_cuda.sum_wta_fused_plain


def sum_wta_first(hf, hb, vf, vb, d_valid: int | None = None, emit: str = "hwd"):
    """``sum_wta``'s first design (one warp a pixel, lane l holding planes
    l, l + 32, ...; ``csrc/sum_wta.cu``'s ``sum_wta_first``, templated on
    the item size), timed beside the shipping kernel. The same function:
    its plain version is :func:`sgm_cuda.sum_wta_fused_plain`."""
    vols = (hf, hb, vf, vb)
    d_valid = sgm_cuda._sum_wta_check(vols, d_valid, emit)
    if hf.device.type == "cpu":
        return sgm_cuda.sum_wta_fused_plain(hf, hb, vf, vb, d_valid, emit)
    vol, stats, args = sgm_cuda._sum_wta_outputs("sum_wta_first", vols, d_valid, emit)
    _launch("sum_wta_first", hf.device, *args, sgm_cuda.SUM_EMITS[emit], hf.element_size())
    _launches["sum_wta_first"] += 1
    return (vol, *stats)


# ablations of the shipping sum_wta (hwd) → their code in csrc/sum_wta.cu
SUM_ABLATIONS = {"stage_only": 1, "no_store": 2, "move_only": 3}


def sum_wta_ablations_plain(hf, hb, vf, vb, form: str, d_valid: int | None = None):
    """What each ablation defines: ``no_store`` the statistics (its volume
    is never written: None); ``stage_only`` and ``move_only`` nothing."""
    _ablation(form, SUM_ABLATIONS)
    if form != "no_store":
        return None
    return (None, *sgm_cuda.sum_wta_fused_plain(hf, hb, vf, vb, d_valid, "none")[1:])


def sum_wta_ablations(hf, hb, vf, vb, form: str, d_valid: int | None = None):
    """The shipping ``sum_wta`` kernel with ``emit="hwd"`` and one part
    taken out, to say which part holds its time (a key of
    :data:`SUM_ABLATIONS`): ``stage_only`` (the four spans staged by
    cp.async, nothing computed or written), ``no_store`` (everything but
    the summed volume's copy-out to device memory: the statistics are
    written), ``move_only`` (the spans staged and the staged output span
    written out, nothing computed). The design is the shipping kernel's
    (``sgm_cuda.sum_wta_design``). See :func:`sum_wta_ablations_plain`
    for what each returns."""
    code = _ablation(form, SUM_ABLATIONS)
    vols = (hf, hb, vf, vb)
    d_valid = sgm_cuda._sum_wta_check(vols, d_valid, "hwd")
    if hf.device.type == "cpu":
        return sum_wta_ablations_plain(hf, hb, vf, vb, form, d_valid)
    vol, stats, args = sgm_cuda._sum_wta_outputs("sum_wta_ablations", vols, d_valid, "hwd")
    g, _, q, _, _ = sgm_cuda.sum_wta_design(hf.shape[-1], hf.element_size())
    _launch("sum_wta_ablations", hf.device, *args, hf.element_size(), g.bit_length() - 1, q,
            code)
    _launches["sum_wta_ablations"] += 1
    return (vol, *stats) if form == "no_store" else None


# ---------------------------------------------------------------------------
# aggregate_dual's recurrence, variants (bench_agg_step)
# ---------------------------------------------------------------------------

# forms of csrc/aggregate.cu's variant parameter
_SHIP, _RAW, _NORM_STORE_N, _NO_GROUPMIN, _NO_SHIFTS, _NO_STORE, _COPY, _INTERLEAVE = range(8)
_FWD_ONLY = 16
# variant → (kernel code, warps per block, float32 cost)
AGG_VARIANTS = {
    # the earlier design's shipping kernel (the script's full_raw function);
    # the name is the script's
    "shipping": (_SHIP, 4, False),
    "full_raw": (_RAW, 4, False),
    "full_norm": (_NORM_STORE_N, 4, False),
    "no_groupmin": (_NO_GROUPMIN, 4, False),
    "no_shifts": (_NO_SHIFTS, 4, False),
    "no_store": (_NO_STORE, 4, False),
    "fwd_only": (_SHIP | _FWD_ONLY, 4, False),
    "g1_raw": (_RAW, 4, False),
    "gm_interleave5": (_INTERLEAVE, 4, False),
    "copy": (_COPY, 4, False),
    "copy1": (_COPY | _FWD_ONLY, 4, False),
    "bs1": (_SHIP, 1, False),
    "bs2": (_SHIP, 2, False),
    "bs8": (_SHIP, 8, False),
    "bs16": (_SHIP, 16, False),
    "f32in": (_SHIP, 4, True),
}


def _agg_variant(variant: str):
    if variant not in AGG_VARIANTS:
        raise ValueError(f"unknown aggregate_dual variant {variant!r}: {tuple(AGG_VARIANTS)}")
    return AGG_VARIANTS[variant]


def _variant_scan(cost: torch.Tensor, form: int, p1: float, p2: float, reverse: bool):
    """One direction of the full_norm, no_groupmin and no_shifts recurrences
    along axis 0 → the float32 values each row stores:

    - full_norm stores the normalised carry L − min(L), and its first row
      stores c and passes c on un-normalised (the script's carry);
    - no_groupmin (WRONG on purpose: isolates the min) carries L itself:
      L = c + min(L_prev, P2, L_prev[d±1] + P1);
    - no_shifts (WRONG on purpose: isolates the d±1 terms) drops the d±1
      terms of the raw-carry step: L = c + min(L_prev, m + P2) − m, m the
      previous row's min."""
    S = cost.shape[0]
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    prev = None
    for i in (range(S - 1, -1, -1) if reverse else range(S)):
        c = cost[i].to(torch.float32)
        if prev is None:
            prev = stored = c
        elif form == _NORM_STORE_N:
            prev = stored = _renorm(_sgm_step_norm(prev, c, p1, p2))
        elif form == _NO_GROUPMIN:
            prev = stored = _sgm_step_norm(prev, c, p1, p2)
        else:  # _NO_SHIFTS
            mp = prev.amin(dim=-1, keepdim=True)
            prev = stored = c + torch.minimum(prev, mp + p2) - mp
        out[i] = stored
    return out


def aggregate_dual_variants_plain(cost: torch.Tensor, variant: str, p1: float = 8.0,
                                  p2: float = 96.0, bs: int = 4):
    """The plain version of one variant (see :func:`aggregate_dual_variants`):
    the shipping kernel's L (int8 stores clamped at 127) for shipping,
    full_raw, g1_raw, gm_interleave5, fwd_only, bs* and f32in, whose values
    are all the same; :func:`_variant_scan`'s values for full_norm,
    no_groupmin and no_shifts; for no_store (its other rows are never
    written) row j of a compact volume holds L at row j·bs + bs − 1 (the
    forward scan's last row of block j; row S − 1 for a short last block)
    and at row j·bs (the backward scan's); copy and copy1 the cost itself."""
    code, _, _ = _agg_variant(variant)
    form, dirs = code & 15, (1 if code & _FWD_ONLY else 2)
    outs = []
    for reverse in (False, True)[:dirs]:
        if form == _COPY:
            vals = cost.to(torch.float32)
        elif form in (_NORM_STORE_N, _NO_GROUPMIN, _NO_SHIFTS):
            vals = _variant_scan(cost, form, p1, p2, reverse)
        else:
            vals = _scan(cost, p1, p2, 0, reverse)[0]
        if form == _NO_STORE:
            S = cost.shape[0]
            rows = torch.arange(0, S, bs, device=cost.device)
            vals = vals[rows if reverse else (rows + bs - 1).clamp(max=S - 1)]
        outs.append(_store(vals, torch.int8))
    return tuple(outs)


def aggregate_dual_variants(cost: torch.Tensor, variant: str, p1: float = 8.0,
                            p2: float = 96.0, bs: int = 4):
    """(S, L, D) cost scanned along S, L lines of D planes (int8, float32
    for ``f32in``) → int8 (L_fwd, L_bwd) of ``variant`` (a key of
    :data:`AGG_VARIANTS`; (L_fwd,) for fwd_only and copy1; for no_store
    compact (ceil(S/bs), L, D) volumes). D ≤ 128 (≤ 32 for gm_interleave5,
    which carries 4 lines a warp; ≤ 384 for shipping, to be timed beside the
    shipping kernel at the full search's D). See
    :func:`aggregate_dual_variants_plain`."""
    code, wpb, f32 = _agg_variant(variant)
    if bs < 1:
        raise ValueError(f"bs must be positive, got {bs}")
    if cost.device.type == "cpu":
        return aggregate_dual_variants_plain(cost, variant, p1, p2, bs)
    S, L, D = cost.shape
    limit = 32 if code == _INTERLEAVE else 384 if variant == "shipping" else 128
    if D > limit:
        raise NotImplementedError(f"aggregate_dual variant {variant} takes D <= {limit}, got {D}")
    _check(cost, "cost", torch.float32 if f32 else torch.int8, 3)
    rows = -(-S // bs) if (code & 15) == _NO_STORE else S
    outs = tuple(torch.empty((rows, L, D), dtype=torch.int8, device=cost.device)
                 for _ in range(1 if code & _FWD_ONLY else 2))
    _launch("aggregate_variants", cost.device, cost.data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr(), S, L, D, float(p1), float(p2), code, wpb, cost.element_size(),
            bs)
    _launches["aggregate_dual_variants"] += 1
    return outs


# ---------------------------------------------------------------------------
# The shipping aggregate_dual's ablations (no TPU counterpart)
# ---------------------------------------------------------------------------

# form → the staged kernel's form code (csrc/aggregate.cu, kNoRecurrence ...)
STAGED_FORMS = {"no_recurrence": 1, "stage_only": 2, "scan_only": 3}
_STAGED_MAX_D = 384  # 12 values a lane


def aggregate_staged_variants_plain(cost: torch.Tensor, form: str):
    """``no_recurrence``: each direction stores L = c (int8, clamped at
    127). ``stage_only`` and ``scan_only`` write no defined values: None."""
    if form != "no_recurrence":
        return None
    vals = _store(cost.to(torch.float32), torch.int8)
    return vals, vals.clone()


def aggregate_staged_variants(cost: torch.Tensor, form: str, p1: float = 8.0, p2: float = 96.0,
                              axis: int = 0):
    """The shipping ``aggregate_dual`` kernel with one part taken out, to
    say which part holds its time: ``form`` a key of :data:`STAGED_FORMS`
    (no_recurrence: L = c; stage_only: the staging of the cost and the
    flushing of the tile alone, no scan; scan_only: the scan alone, on
    whatever the ring holds, nothing staged or flushed). (H, W, D) int8 cost, D ≤ 384, along ``axis``
    → int8 (L_fwd, L_bwd), defined for no_recurrence only."""
    if form not in STAGED_FORMS:
        raise ValueError(f"unknown staged form {form!r}: {tuple(STAGED_FORMS)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if cost.device.type == "cpu":
        return aggregate_staged_variants_plain(cost, form)
    H, W, D = cost.shape
    if D > _STAGED_MAX_D:
        raise NotImplementedError(f"the staged ablations take D <= {_STAGED_MAX_D}, got {D}")
    _check(cost, "cost", torch.int8, 3)
    lf, lb = torch.empty((2, H, W, D), dtype=torch.int8, device=cost.device)
    _launch("aggregate_staged_variants", cost.device, cost.data_ptr(), lf.data_ptr(),
            lb.data_ptr(), H, W, D, axis, float(p1), float(p2), STAGED_FORMS[form])
    _launches["aggregate_staged_variants"] += 1
    return lf, lb


# ---------------------------------------------------------------------------
# wta_stats_from_duals, variants (bench_wta_variants)
# ---------------------------------------------------------------------------

_BASE, _F32SUM, _BESTONLY, _NOKEY, _SUMONLY = range(5)
# variant → (kernel form, warps per block)
WTA_VARIANTS = {
    "base": (_BASE, 8),  # the earlier design as it shipped
    "f32sum": (_F32SUM, 8),
    "bestonly": (_BESTONLY, 8),
    "nokey": (_NOKEY, 8),
    "unpacked": (_BASE, 8),  # the script's five separate maps: the port's layout
    "smallblk": (_BASE, 2),
    "bigblk": (_BASE, 32),
    "sumonly": (_SUMONLY, 8),
}


def _wta_variant(variant: str):
    if variant not in WTA_VARIANTS:
        raise ValueError(f"unknown wta_stats variant {variant!r}: {tuple(WTA_VARIANTS)}")
    return WTA_VARIANTS[variant]


def wta_stats_variants_plain(hf: torch.Tensor, hb: torch.Tensor, variant: str,
                             d_valid: int | None = None):
    """The plain version of one variant: ``wta_stats_from_duals_plain``
    for base, unpacked, smallblk, bigblk and nokey (the same values); for
    f32sum the same statistics of the float32 sum with the float sentinel
    1e9; bestonly its (best, idx); sumonly (min s as float32, min s as
    int32), the script's min written into idx."""
    form, _ = _wta_variant(variant)
    D = hf.shape[-1]
    d_valid = _check_d_valid(D, d_valid)
    if form == _F32SUM:
        s = hf.to(torch.float32) + hb.to(torch.float32)
        s = torch.where(torch.arange(D, device=s.device) >= d_valid, float(_MASKED), s)
        return _float_stats(*_wta_stats(s))
    stats = sgm_cuda.wta_stats_from_duals_plain(hf, hb, d_valid)
    if form == _BESTONLY:
        return stats[:2]
    if form == _SUMONLY:
        return stats[0], stats[0].to(torch.int32)
    return stats


def wta_stats_variants(hf: torch.Tensor, hb: torch.Tensor, variant: str,
                       d_valid: int | None = None):
    """(H, W, D) int8 dual volumes, D ≤ 128 → the statistics of ``variant``
    (a key of :data:`WTA_VARIANTS`): (best, idx, cm, cp, competitor), or
    (best, idx) for bestonly and sumonly. See
    :func:`wta_stats_variants_plain`."""
    form, wpb = _wta_variant(variant)
    D = hf.shape[-1]
    d_valid = _check_d_valid(D, d_valid)
    if hf.shape != hb.shape:
        raise ValueError(f"volume shapes differ: {tuple(hf.shape)} vs {tuple(hb.shape)}")
    if hf.device.type == "cpu":
        return wta_stats_variants_plain(hf, hb, variant, d_valid)
    if D > 128:
        raise NotImplementedError(f"wta_stats variant {variant} takes D <= 128, got {D}")
    _check(hf, "hf", torch.int8, 3)
    _check(hb, "hb", torch.int8, 3)
    H, W, _ = hf.shape
    n_maps = 2 if form in (_BESTONLY, _SUMONLY) else 5
    maps = [torch.empty((H, W), dtype=torch.int32 if k == 1 else torch.float32, device=hf.device)
            for k in range(n_maps)]
    ptrs = [m.data_ptr() for m in maps] + [None] * (5 - n_maps)
    _launch("wta_stats_variants", hf.device, hf.data_ptr(), hb.data_ptr(), *ptrs, H * W, D,
            d_valid, form, wpb)
    _launches["wta_stats_variants"] += 1
    return tuple(maps)


# ---------------------------------------------------------------------------
# right_disparity, variants (bench_rdisp)
# ---------------------------------------------------------------------------

# variant → csrc/right_disparity.cu's variant code: in_place is the first
# design, boxes the shipping kernel (sgm_cuda.right_disparity_design)
RDISP_VARIANTS = {"in_place": 0, "transposed": 1, "staged": 2, "boxes": 3}


def right_disparity_variants_plain(s: torch.Tensor, variant: str,
                                   d_valid: int | None = None) -> torch.Tensor:
    """``right_disparity_plain`` of the (H, W, D) sum, which ``transposed``
    takes as its (D, H, W) copy."""
    if variant not in RDISP_VARIANTS:
        raise ValueError(f"unknown right_disparity variant {variant!r}: {tuple(RDISP_VARIANTS)}")
    return sgm_cuda.right_disparity_plain(s.permute(1, 2, 0) if variant == "transposed" else s,
                                          d_valid)


def right_disparity_variants(s: torch.Tensor, variant: str,
                             d_valid: int | None = None) -> torch.Tensor:
    """The (H, W, D) summed volume (int8 or int16; for ``transposed`` its
    (D, H, W) copy) → (H, W) int32 right-view disparities, the same
    function in every variant of :data:`RDISP_VARIANTS`; D ≤ 1024. ``boxes``
    stages as the shipping kernel does (``sgm_cuda.right_disparity_design``)."""
    if variant not in RDISP_VARIANTS:
        raise ValueError(f"unknown right_disparity variant {variant!r}: {tuple(RDISP_VARIANTS)}")
    if s.ndim != 3:
        raise ValueError(f"s must have 3 dims, got shape {tuple(s.shape)}")
    D, H, W = s.shape if variant == "transposed" else (s.shape[2], s.shape[0], s.shape[1])
    d_valid = _check_d_valid(D, d_valid)
    if s.device.type == "cpu":
        return right_disparity_variants_plain(s, variant, d_valid)
    sgm_cuda._check_planes("right_disparity_variants", D)
    out = _rdisp_variant_launch(s, H, W, D, d_valid, RDISP_VARIANTS[variant])
    _launches["right_disparity_variants"] += 1
    return out


def _rdisp_variant_launch(s: torch.Tensor, H: int, W: int, D: int, d_valid: int, code: int):
    """Launch variant ``code`` of ``csrc/right_disparity.cu`` (an int8 or
    int16 volume, checked; the shipping kernel's staging for the boxes
    variant and its ablations) into a new (H, W) int32 map."""
    if s.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"s must be int8 or int16, got {s.dtype}")
    _check(s, "s", s.dtype, 3)
    out = torch.empty((H, W), dtype=torch.int32, device=s.device)
    _launch("right_disparity_variants", s.device, s.data_ptr(), out.data_ptr(),
            *sgm_cuda._rdisp_args(H, W, D, d_valid, s.element_size()), code)
    return out


# form → csrc/right_disparity.cu's variant code of the ablation
RDISP_ABLATIONS = {"stage_only": 4, "reduce_only": 5}


def right_disparity_ablations(s: torch.Tensor, form: str, d_valid: int | None = None):
    """The shipping ``right_disparity`` kernel with one part taken out, to
    say which part holds its time (a key of :data:`RDISP_ABLATIONS`):
    ``stage_only`` stages each block's rectangles and walks none,
    ``reduce_only`` walks whatever shared memory holds, nothing staged.
    The staging is the shipping kernel's (``sgm_cuda.right_disparity_design``).
    (H, W, D) int8 or int16 → an (H, W) int32 map with no defined values;
    on the CPU, None."""
    if form not in RDISP_ABLATIONS:
        raise ValueError(f"unknown ablation {form!r}: {tuple(RDISP_ABLATIONS)}")
    H, W, D = s.shape
    d_valid = _check_d_valid(D, d_valid)
    if s.device.type == "cpu":
        return None
    out = _rdisp_variant_launch(s, H, W, D, d_valid, RDISP_ABLATIONS[form])
    _launches["right_disparity_ablations"] += 1
    return out


# ---------------------------------------------------------------------------
# speckle_counts, the earlier design
# ---------------------------------------------------------------------------


def speckle_counts_direct(dv: torch.Tensor, k: int, r: float, nbins: int) -> torch.Tensor:
    """``sgm_cuda.speckle_counts`` through its direct k×k form at any k and
    nbins (the design it shipped with until the column counts; the
    shipping wrapper takes it only where those do not fit). The same
    function: its plain version is ``sgm_cuda.speckle_counts_plain``."""
    if dv.device.type == "cpu":
        return sgm_cuda.speckle_counts_plain(dv, k, r, nbins)
    _check(dv, "dv", torch.float32, 2)
    H, W = dv.shape
    out = torch.empty_like(dv)
    _launch("speckle_direct", dv.device, dv.data_ptr(), out.data_ptr(), H, W, k, float(r),
            nbins)
    _launches["speckle_counts_direct"] += 1
    return out


# ---------------------------------------------------------------------------
# nearest_valid_lohi, the earlier design
# ---------------------------------------------------------------------------


def nearest_valid_lohi_chunks(disp: torch.Tensor, valid: torch.Tensor, d_up: torch.Tensor,
                              axis: int = 1):
    """``sgm_cuda.nearest_valid_lohi`` through its earlier design (a
    thread a chunk of a line, the left values parked in ``lo`` by a forward
    walk and read back by a backward one; ``csrc/nearest_lohi.cu``'s
    ``svt_nearest_valid_lohi_chunks``). The same function: its plain
    version is ``sgm_cuda.nearest_valid_lohi_plain``."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if disp.device.type == "cpu":
        return sgm_cuda.nearest_valid_lohi_plain(disp, valid, d_up, axis)
    _check(disp, "disp", torch.float32, 2)
    _check(valid, "valid", torch.bool, 2)
    _check(d_up, "d_up", torch.float32, 2)
    if not disp.shape == valid.shape == d_up.shape:
        raise ValueError("disp, valid and d_up must have one shape")
    H, W = disp.shape
    lo, hi = torch.empty_like(disp), torch.empty_like(disp)
    _launch("nearest_lohi_chunks", disp.device, disp.data_ptr(), valid.data_ptr(),
            d_up.data_ptr(), lo.data_ptr(), hi.data_ptr(), H, W, axis)
    _launches["nearest_valid_lohi_chunks"] += 1
    return lo, hi


# ---------------------------------------------------------------------------
# census_words and cost_volume, the first designs
# ---------------------------------------------------------------------------


def census_words_first(img: torch.Tensor, ksize: int = 5, wsize: int = 5) -> torch.Tensor:
    """``sgm_cuda.census_words`` through its first design (a thread a pixel,
    runtime window loops; ``csrc/census.cu``'s ``census_first``). The same
    function: its plain version is ``sgm_cuda.census_words_plain``."""
    if img.device.type == "cpu":
        return sgm_cuda.census_words_plain(img, ksize, wsize)
    _check(img, "img", torch.float32, 2)
    H, W = img.shape
    out = torch.empty(((ksize * wsize - 1 + 31) // 32, H, W), dtype=torch.int32,
                      device=img.device)
    _launch("census_first", img.device, img.data_ptr(), out.data_ptr(), H, W, ksize, wsize)
    _launches["census_words_first"] += 1
    return out


def cost_volume_first(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int, min_d: int,
                      max_cost: int) -> torch.Tensor:
    """``sgm_cuda.cost_volume`` through its first design (four disparities a
    thread where D % 4 == 0, one elsewhere; ``csrc/cost.cu``'s
    ``cost_first``). The same function: its plain version is
    ``sgm_cuda.cost_volume_plain``."""
    if cl.device.type == "cpu":
        return sgm_cuda.cost_volume_plain(cl, cr, num_disparities, min_d, max_cost)
    _check(cl, "cl", torch.int32, 3)
    _check(cr, "cr", torch.int32, 3)
    if cl.shape != cr.shape:
        raise ValueError(f"census shapes differ: {tuple(cl.shape)} vs {tuple(cr.shape)}")
    nw, H, W = cl.shape
    out = torch.empty((H, W, num_disparities), dtype=torch.int8, device=cl.device)
    _launch("cost_first", cl.device, cl.data_ptr(), cr.data_ptr(), out.data_ptr(), H, W,
            num_disparities, nw, min_d, int(max_cost))
    _launches["cost_volume_first"] += 1
    return out


# ---------------------------------------------------------------------------
# census_words and cost_volume, ablations of the shipping kernels
# ---------------------------------------------------------------------------

# form → the census kernel's ablation code (csrc/census.cu, kStageOnly ...)
CENSUS_ABLATIONS = {"stage_only": 1, "no_store": 2}
# form → the cost kernel's ablation code (csrc/cost.cu, kNoPopc ...)
COST_ABLATIONS = {"no_popc": 1, "no_runs": 2, "no_copy": 3, "copy_only": 4, "direct": 5}


def _ablation(form: str, forms: dict) -> int:
    if form not in forms:
        raise ValueError(f"unknown ablation {form!r}: {tuple(forms)}")
    return forms[form]


def census_words_ablations_plain(img: torch.Tensor, form: str):
    """``stage_only`` stores zero words; ``no_store`` stores nothing: None."""
    _ablation(form, CENSUS_ABLATIONS)
    if form == "no_store":
        return None
    return torch.zeros((1, *img.shape), dtype=torch.int32, device=img.device)


def census_words_ablations(img: torch.Tensor, form: str):
    """The shipping 5×5 ``census_words`` kernel with one part taken out, to
    say which part holds its time (a key of :data:`CENSUS_ABLATIONS`):
    ``stage_only`` stages the tile and stores zero words, no compare;
    ``no_store`` makes every compare and stores no word. (H, W) float32 →
    (1, H, W) int32, defined for ``stage_only`` only."""
    code = _ablation(form, CENSUS_ABLATIONS)
    if img.device.type == "cpu":
        return census_words_ablations_plain(img, form)
    _check(img, "img", torch.float32, 2)
    out = torch.empty((1, *img.shape), dtype=torch.int32, device=img.device)
    _launch("census_ablations", img.device, img.data_ptr(), out.data_ptr(), *img.shape, code)
    _launches["census_words_ablations"] += 1
    return out


def cost_volume_ablations_plain(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int,
                                min_d: int, max_cost: int, form: str):
    """``no_popc``: cost_volume_plain's volume with each popcount replaced
    by the xor's low 6 bits; ``direct``: cost_volume_plain's volume; the
    other forms write no defined volume: None."""
    _ablation(form, COST_ABLATIONS)
    if form == "direct":
        return sgm_cuda.cost_volume_plain(cl, cr, num_disparities, min_d, max_cost)
    if form != "no_popc":
        return None
    _, H, W = cl.shape
    out = torch.empty((H, W, num_disparities), dtype=torch.int8, device=cl.device)
    x = torch.arange(W, device=cl.device)
    for d in range(num_disparities):
        src = x - min_d - d
        valid = (src >= 0) & (src <= W - 1)
        cost = (cl[0] ^ cr[0][:, src.clamp(0, W - 1)]) & 0x3F
        out[:, :, d] = torch.where(valid[None, :], cost, max_cost).to(torch.int8)
    return out


def cost_volume_ablations(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int, min_d: int,
                          max_cost: int, form: str):
    """The shipping ``cost_volume`` kernel at nw = 1 with one part taken
    out, to say which part holds its time (a key of
    :data:`COST_ABLATIONS`): ``no_popc`` (the xor's low 6 bits for the
    popcount), ``no_runs`` (the window staged, zero runs put into the
    staged span and written out), ``no_copy`` (the runs made, the span not
    written out), ``copy_only`` (the staged span written out alone),
    ``direct`` (each run stored to device memory as it is made, no staged
    span: D a multiple of 16 only). The
    block shape and padding are the shipping kernel's
    (``sgm_cuda.cost_design``). (1, H, W) int32 census pair → (H, W, D)
    int8, defined for ``no_popc`` only."""
    code = _ablation(form, COST_ABLATIONS)
    if form == "direct" and num_disparities % 16:
        raise ValueError(f"the direct form takes D a multiple of 16, got {num_disparities}")
    if cl.device.type == "cpu":
        return cost_volume_ablations_plain(cl, cr, num_disparities, min_d, max_cost, form)
    _check(cl, "cl", torch.int32, 3)
    _check(cr, "cr", torch.int32, 3)
    if cl.shape != cr.shape or cl.shape[0] != 1:
        raise ValueError(f"the ablations take one census word a pixel, one shape: "
                         f"{tuple(cl.shape)} vs {tuple(cr.shape)}")
    _, H, W = cl.shape
    _, tx, sh = sgm_cuda.cost_design(num_disparities, 1)
    out = torch.empty((H, W, num_disparities), dtype=torch.int8, device=cl.device)
    _launch("cost_ablations", cl.device, cl.data_ptr(), cr.data_ptr(), out.data_ptr(), H, W,
            num_disparities, min_d, int(max_cost), code, tx.bit_length() - 1, sh)
    _launches["cost_volume_ablations"] += 1
    return out


KERNEL_WRAPPERS = (aggregate_dual_variants, aggregate_staged_variants,
                   wta_stats_variants, right_disparity_variants, speckle_counts_direct,
                   census_words_first, cost_volume_first, census_words_ablations,
                   cost_volume_ablations, nearest_valid_lohi_chunks, right_disparity_ablations,
                   sum_wta_first, sum_wta_ablations)
COUNTS = tuple(f.__name__ for f in KERNEL_WRAPPERS)
sgm_cuda.register({
    "sum_wta_first": ("svt_sum_wta_first", (_P,) * 10 + (_L,) + (_I,) * 4 + (_P,),
                      "sum_wta_variants"),
    "sum_wta_ablations": ("svt_sum_wta_ablation", (_P,) * 10 + (_L,) + (_I,) * 6 + (_P,),
                          "sum_wta_variants"),
    "aggregate_variants": ("svt_aggregate_dual_variant",
                           (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P)),
    "aggregate_staged_variants": ("svt_aggregate_staged_variant",
                                  (_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
                                  "aggregate_variants"),
    "wta_stats_variants": ("svt_wta_stats_variant", (_P,) * 7 + (_I,) * 5 + (_P,)),
    "right_disparity_variants": ("svt_right_disparity_variant", (_P, _P) + (_I,) * 7 + (_P,)),
    "speckle_direct": ("svt_speckle_counts_direct", (_P, _P, _I, _I, _I, _F, _I, _P),
                       "speckle"),
    "census_first": ("svt_census_words_first", (_P, _P, _I, _I, _I, _I, _P), "census"),
    "cost_first": ("svt_cost_volume_first", (_P, _P, _P) + (_I,) * 6 + (_P,), "cost"),
    "census_ablations": ("svt_census_words_ablation", (_P, _P, _I, _I, _I, _P),
                         "census_variants"),
    "cost_ablations": ("svt_cost_volume_ablation", (_P, _P, _P) + (_I,) * 8 + (_P,),
                       "cost_variants"),
    "nearest_lohi_chunks": ("svt_nearest_valid_lohi_chunks", (_P,) * 5 + (_I,) * 3 + (_P,),
                            "nearest_lohi"),
}, COUNTS)
