"""Measurement kernels: the counterparts of the Pallas kernels of the JAX
package's four TPU measurement scripts, each beside its plain version.

- :func:`sum_wta` ← ``scripts/bench_sumwta.py:110`` (``make_pallas``): the
  engine's ``sgm_cuda.sum_wta_fused`` (``csrc/sum_wta.cu``), under the name
  the measurement script calls.
- :func:`aggregate_dual_variants` ← ``scripts/bench_agg_step.py:216``:
  ablations of ``aggregate_dual``'s recurrence (``csrc/aggregate.cu``), on
  the earlier design of that kernel, the one the script's variants were
  written against.
- :func:`wta_stats_variants` ← ``scripts/bench_wta_variants.py:149``:
  ablations of ``wta_stats_from_duals`` (``csrc/wta_stats.cu``), on the
  earlier design of that kernel (a warp a pixel), the one the script's
  variants were written against; ``base`` is that design as it shipped.
- :func:`right_disparity_variants` ← ``scripts/bench_rdisp.py:84``:
  ``right_disparity`` read in place (its first design), from a (D, H, W)
  copy, through a band staged in shared memory, and as the shipping
  diagonal boxes (``csrc/right_disparity.cu``).

The three variant families are compile-time variants of the shipping
kernels, built into libraries of their own (``_build.VARIANTS``); the
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
from stereovision_tpu_torch.ops.sgm_cuda import (_MASKED, _P, _F, _I, _check, _check_d_valid,
                                                 _float_stats, _launch, _launches, _renorm,
                                                 _scan, _sgm_step_norm, _store, _wta_stats)

# ---------------------------------------------------------------------------
# Fused sum of four volumes + winner statistics (bench_sumwta)
# ---------------------------------------------------------------------------

# the engine's wrapper (sgm_cuda.sum_wta_fused) and its plain version, under
# the names the measurement script calls
sum_wta, sum_wta_plain = sgm_cuda.sum_wta_fused, sgm_cuda.sum_wta_fused_plain


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
    if s.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"s must be int8 or int16, got {s.dtype}")
    _check(s, "s", s.dtype, 3)
    out = torch.empty((H, W), dtype=torch.int32, device=s.device)
    _launch("right_disparity_variants", s.device, s.data_ptr(), out.data_ptr(),
            *sgm_cuda._rdisp_args(H, W, D, d_valid, s.element_size()), RDISP_VARIANTS[variant])
    _launches["right_disparity_variants"] += 1
    return out


KERNEL_WRAPPERS = (aggregate_dual_variants, wta_stats_variants, right_disparity_variants)
COUNTS = tuple(f.__name__ for f in KERNEL_WRAPPERS)
sgm_cuda.register({
    "aggregate_variants": ("svt_aggregate_dual_variant",
                           (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P)),
    "wta_stats_variants": ("svt_wta_stats_variant", (_P,) * 7 + (_I,) * 5 + (_P,)),
    "right_disparity_variants": ("svt_right_disparity_variant", (_P, _P) + (_I,) * 7 + (_P,)),
}, COUNTS)
