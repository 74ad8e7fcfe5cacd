"""The disparity engine: census cost volume + semi-global matching, in PyTorch.

Counterpart of ``stereovision_tpu/stereo/sgm.py``: census (5×5 by default),
Hamming cost, semi-global aggregation over four paths (→ ← ↓ ↑) or the
horizontal pair (with ``agg_wseg`` column segments), winner-take-all with
parabola subpixel and the uniqueness ratio, the left-right check, windowed
speckle suppression and a median filter; the coarse-to-fine modes ``"hier"``
and ``"hier2"`` (the production configuration, :func:`production_preset`)
with census arbitration and fill; ``fill_invalid``; and the exact speckle
post-pass (:func:`exact_speckle_postpass`). ``SGMParams`` keeps every field
of the reference so that a configuration carries across unchanged.

``impl``: ``"xla"`` runs the plain PyTorch path (the role ``impl="xla"``
plays in the reference: float32 cost volumes, a scan per direction, gathers
and scans); ``"auto"`` and ``"pallas"`` run the kernel path, whose
kernels (``ops.sgm_cuda``) launch on CUDA tensors and use their plain
versions on CPU tensors. The two paths give the same disparity, as the
reference's two do.

Lane packing (``pack``) is ported by its results, not its layout: the pack
strips of the padded image run as separate searches over one shared census,
as the reference's XLA branch runs them.

Each stage opens a profiler span (:func:`utils.profiling.annotate`):
``sgm.search`` (census → cost → aggregation → WTA → LR), ``sgm.coarse``,
``sgm.shifts``, ``sgm.census``, ``sgm.refine``, ``sgm.arbitrate``,
``sgm.speckle``, ``sgm.fill`` and ``sgm.median``; no name opens inside
itself.

On a card the public calls (:func:`compute_disparity`,
:func:`disparity_with_confidence`) run from CUDA graphs
(:mod:`utils.graphs`): a call whose shapes, settings and device recur is
run eagerly the first time, captured the second (an ``sgm.capture`` span,
inside which the stage spans open once) and replayed after (an
``sgm.replay`` span, no stage span), one launch in place of the host's
dispatch of a frame's ~500 operations; the same kernels and operations in
the same order, so the same bits. :func:`graph_counts` counts the three.
The exact engine (``parallel``) and :func:`exact_speckle_postpass` run
eagerly.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.utils import graphs
from stereovision_tpu_torch.utils.backend import resolve_device
from stereovision_tpu_torch.utils.profiling import annotate

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class SGMParams:
    """Static disparity-engine configuration; the fields, defaults and
    meaning of the reference's ``SGMParams`` (cv2.StereoSGBM's knobs, with
    P1/P2 in census-bit units)."""

    min_disparity: int = 0
    num_disparities: int = 128
    census_ksize: int = 5   # census window width
    census_wsize: int = 5   # census window height
    p1: float = 8.0         # small-jump penalty
    p2: float = 96.0        # large-jump penalty
    uniqueness_ratio: int = 10      # % margin, cv2 semantics; 0 disables
    lr_max_diff: int = 1            # disp12MaxDiff; <0 disables
    speckle_window_size: int = 100  # component-area analog; 0 disables
    speckle_range: float = 32.0
    median_ksize: int = 5
    subpixel: bool = True
    # "auto"/"pallas" → the CUDA kernels; "xla" → the plain PyTorch path
    impl: str = "auto"
    # "full" searches all num_disparities at full resolution; "hier"/"hier2"
    # are the reference's coarse-to-fine modes
    mode: str = "full"
    coarse_scale: int = 4
    coarse_paths: int = 4
    census_kill: float = 6.0
    fill_invalid: bool = False
    refine_range: int = 32
    pack: int = 1
    paths: int = 4
    stats_impl: str = "pallas"
    b_decimate: int = 1
    lr_groups: int = 0
    agg_wseg: int = 1

    def __post_init__(self):
        if self.b_decimate not in (1, 3):
            raise ValueError(
                f"b_decimate must be 1 (full-height window B) or 3 "
                f"(implemented decimation factor); got {self.b_decimate}"
            )


def reference_preset(mode: str = "hier") -> SGMParams:
    """The reference's exact SGBM search configuration: 320 disparities from
    0, uniqueness 10, disp12MaxDiff 1, speckle 100/32, median post-filter."""
    return SGMParams(
        min_disparity=0, num_disparities=320,
        uniqueness_ratio=10, lr_max_diff=1,
        speckle_window_size=100, speckle_range=32.0, median_ksize=5,
        mode=mode,
    )


def production_preset() -> SGMParams:
    """The reference's headline 720p configuration (hier2, R=32 windows,
    horizontal paths, census arbitration and fill). ``stats_impl="auto"``
    runs the statistics kernel (:func:`stereo.autotune.tune_stats_impl`)."""
    return SGMParams(
        num_disparities=320, mode="hier2", refine_range=32, paths=2,
        coarse_scale=3, census_kill=6.0, fill_invalid=True,
        b_decimate=3, coarse_paths=2, stats_impl="auto",
    )


_IMPLS = ("auto", "pallas", "xla", "pallas_interpret")


def _resolve_impl(impl: str) -> str:
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "pallas_interpret":
        raise NotImplementedError(
            "impl='pallas_interpret' has no counterpart: the CUDA kernels have no "
            "interpreter; impl='auto' on CPU tensors runs their plain versions "
            "(ROADMAP.md queue 1 item 1)"
        )
    return "xla" if impl == "xla" else "pallas"


def check_params(p: SGMParams) -> SGMParams:
    """``p`` if this port runs it; an unknown impl raises ``ValueError``,
    ``impl="pallas_interpret"`` ``NotImplementedError``."""
    _resolve_impl(p.impl)
    return p


# ---------------------------------------------------------------------------
# Cost volume
# ---------------------------------------------------------------------------


def census_cost_volume(left: torch.Tensor, right: torch.Tensor, p: SGMParams) -> torch.Tensor:
    """(H, W) grayscale pair → (H, W, D) float32 Hamming cost volume:
    cost[y, x, d] = hamming(census_L[y, x], census_R[y, x − (min_d + d)]),
    the census bit count where the match leaves the image."""
    cl = im.census_transform(left, p.census_ksize, p.census_wsize)
    cr = im.census_transform(right, p.census_ksize, p.census_wsize)
    return cost_from_census(cl, cr, p)


def cost_from_census(cl: torch.Tensor, cr: torch.Tensor, p: SGMParams) -> torch.Tensor:
    """(H, W, nw) census pair → (H, W, D) float32 cost volume."""
    W = cl.shape[1]
    D = p.num_disparities
    n_bits = p.census_ksize * p.census_wsize - 1
    x = torch.arange(W, device=cl.device)
    d = torch.arange(D, device=cl.device) + p.min_disparity
    src = x[None, :] - d[:, None]                      # (D, W)
    valid = (src >= 0) & (src <= W - 1)
    src = src.clamp(0, W - 1)
    cr_shift = cr[:, src, :].movedim(1, 0)             # (D, H, W, nw)
    cost = im.hamming_words(cl[None], cr_shift).to(torch.float32)  # (D, H, W)
    cost = torch.where(valid[:, None, :], cost, float(n_bits))
    return cost.movedim(0, -1).contiguous()            # (H, W, D)


# ---------------------------------------------------------------------------
# Path aggregation
# ---------------------------------------------------------------------------


def _effective_wseg(p: SGMParams, W: int, H: int) -> int:
    """``agg_wseg`` where it applies, else 1: the horizontal pair only, and
    the reference's layout gate (``W % (128·agg_wseg) == 0`` and
    ``H % 8 == 0``), which fixes where the scans restart under every impl."""
    if p.paths != 2 or p.agg_wseg <= 1:
        return 1
    ok = W % (128 * p.agg_wseg) == 0 and H % 8 == 0
    return p.agg_wseg if ok else 1


def _segments(vol: torch.Tensor, seg: int) -> torch.Tensor:
    """(H, W, D) → the (H·seg, W/seg, D) view whose rows are the column
    segments: a scan along its rows restarts every W/seg columns."""
    H, W, D = vol.shape
    return vol.reshape(H * seg, W // seg, D)


def aggregate(cost: torch.Tensor, p: SGMParams) -> torch.Tensor:
    """Semi-global aggregation of (H, W, D) → summed float32 (H, W, D) over
    the horizontal pair (``paths=2``) or all four paths (→ ← ↓ ↑): the plain
    scan of each direction (``impl="xla"``), or one
    :func:`sgm_cuda.aggregate_dir` launch per direction adding onto the
    running sum in place (a kernel impl; the reference's kernel branch sums
    four directions whatever ``paths`` says, ROADMAP.md §3). With
    ``agg_wseg`` segments (:func:`_effective_wseg`) the horizontal scans
    restart every W/agg_wseg columns, under both impls."""
    H, W, D = cost.shape
    seg = _effective_wseg(p, W, H)
    if _resolve_impl(p.impl) == "xla":
        agg = sgm_cuda.aggregate_dir_plain
        cs = _segments(cost, seg)
        s = agg(cs, p.p1, p.p2, axis=1)
        s = (s + agg(cs, p.p1, p.p2, axis=1, reverse=True)).reshape(H, W, D)
        if p.paths == 2:
            return s
        s = s + agg(cost, p.p1, p.p2, axis=0)
        return s + agg(cost, p.p1, p.p2, axis=0, reverse=True)
    cost = cost.to(torch.float32).contiguous()
    cs = _segments(cost, seg)
    s = sgm_cuda.aggregate_dir(cs, p.p1, p.p2, axis=1)
    sgm_cuda.aggregate_dir(cs, p.p1, p.p2, axis=1, reverse=True, acc=s)
    s = s.reshape(H, W, D)
    if p.paths != 2:
        sgm_cuda.aggregate_dir(cost, p.p1, p.p2, axis=0, acc=s)
        sgm_cuda.aggregate_dir(cost, p.p1, p.p2, axis=0, reverse=True, acc=s)
    return s


# ---------------------------------------------------------------------------
# Winner selection + validation
# ---------------------------------------------------------------------------


def _wta(agg, p: SGMParams, stats=None):
    """Winner-take-all with parabola subpixel + uniqueness test.

    ``stats`` (best, idx, cm, cp, competitor) comes from the kernel path;
    without it they are computed from the volume ``agg``: in plain PyTorch
    (``impl="xla"``), else by :func:`sgm_cuda.wta`.
    Returns (disp float32 px incl. min_disparity, valid bool, best cost).
    """
    D = p.num_disparities
    if stats is None:
        if _resolve_impl(p.impl) == "xla":
            stats = sgm_cuda._wta_stats(agg)
        else:
            stats = sgm_cuda.wta(agg.to(torch.float32).contiguous())
    best, best_idx, cm, cp, competitor = stats
    cm = torch.where(best_idx == 0, best, cm)
    cp = torch.where(best_idx >= D - 1, best, cp)

    # Uniqueness (cv2 semantics): invalid if any d with |d − d*| > 1 has
    # cost·(100−U) < best·100.
    if p.uniqueness_ratio > 0:
        unique_ok = competitor * (100 - p.uniqueness_ratio) >= best * 100
    else:
        unique_ok = torch.ones_like(best, dtype=torch.bool)

    if p.subpixel:
        denom = cm + cp - 2.0 * best
        offset = torch.where(
            denom > 1e-6, (cm - cp) / (2.0 * denom.clamp(min=1e-6)), 0.0
        ).clamp(-0.5, 0.5)
        interior = (best_idx > 0) & (best_idx < D - 1)
        disp = best_idx.to(torch.float32) + torch.where(interior, offset, 0.0)
    else:
        disp = best_idx.to(torch.float32)
    return disp + p.min_disparity, unique_ok, best


def _left_right_check(agg, disp, p: SGMParams, impl: str):
    """Consistency: the right image's disparity from the same volume,
    dR(u) = argmin_d S[y, u+d, d], and |dL(x) − dR(x − dL)| ≤ maxDiff
    (cv2's disp12MaxDiff without a second matching pass). ``agg`` is the
    float32 sum on the plain path (a loop over d), the kernel path's int8 or
    int16 summed volume otherwise (:func:`sgm_cuda.right_disparity`)."""
    if impl == "xla":
        disp_r_idx = sgm_cuda.right_disparity_plain(agg, p.num_disparities)
    else:
        disp_r_idx = sgm_cuda.right_disparity(agg, p.num_disparities)
    return _lr_compare(disp, disp_r_idx, p, impl)


def _lr_compare(disp, disp_r_idx, p: SGMParams, impl: str):
    """|dL(x) − dR(x − dL)| ≤ maxDiff given the right-view disparity indices.
    disp_r's index u holds the disparity of right pixel u − min_d, so right
    pixel x − round(dL) sits at offset round(dL) − min_d from x."""
    W = disp.shape[-1]
    disp_r = disp_r_idx.to(torch.float32) + p.min_disparity
    x = torch.arange(W, device=disp.device)
    rd = torch.round(disp).to(torch.int32)
    if impl == "xla":
        u = (x[None, :] - rd + p.min_disparity).clamp(0, W - 1)
        dr_at = disp_r.gather(1, u.to(torch.int64))
    else:
        off = torch.minimum((rd - p.min_disparity).clamp(min=0), x[None, :]).to(torch.int32)
        dr_at = sgm_cuda.shift_gather(disp_r, off, p.num_disparities + 1)
    return (disp - dr_at).abs() <= p.lr_max_diff


def _speckle_suppress(disp, valid, p: SGMParams, impl: str):
    """Windowed approximation of cv2.filterSpeckles: a pixel survives only if
    enough pixels of its k×k window (k ≈ √(2·speckleWindowSize)) share its
    disparity bin under one of two half-offset binnings."""
    if p.speckle_window_size <= 0:
        return valid
    k = max(3, int((2 * p.speckle_window_size) ** 0.5) | 1)
    r = float(p.speckle_range)
    nbins = (p.num_disparities + int(r)) // max(1, int(r)) + 2
    with annotate("sgm.speckle"):
        dv = torch.where(valid, disp - p.min_disparity, -2.0 * r)
        if impl == "xla":
            count = sgm_cuda.speckle_counts_plain(dv, k, r, nbins)
        else:
            count = sgm_cuda.speckle_counts(dv, k, r, nbins)
        min_count = min(p.speckle_window_size, k * k) * 0.25
        return valid & (count >= min_count)


def _median(img, ksize: int, impl: str):
    """The k×k median with replicate borders: the kernel
    (``sgm_cuda.median_blur``) on a card, the plain network under
    ``impl="xla"`` or on the CPU; the two are equal bit for bit."""
    if impl == "xla":
        return sgm_cuda.median_blur_plain(img, ksize)
    return sgm_cuda.median_blur(img, ksize)


# ---------------------------------------------------------------------------
# The search: census → cost → aggregation → WTA → LR check
# ---------------------------------------------------------------------------


def _vol_dtype(p: SGMParams) -> torch.dtype:
    """The kernel path's path-volume dtype: per-direction path costs are
    ≤ n_bits + P2, int8-exact for the default census sizes."""
    n_bits = p.census_ksize * p.census_wsize - 1
    return torch.int8 if (n_bits + p.p2) <= 127 else torch.int16


def _kernel_costs(left, right, p: SGMParams, cl=None, cr=None, crop: int = 0,
                  strips: int = 1):
    """The kernel path's head: census words of both images (or
    ``cl``/``cr``) → one int8 (H, W, D) cost volume, less ``crop`` rows at
    each end (rows that only feed the census windows) → the horizontal dual
    sweep, on the segmented view where ``agg_wseg`` applies to the strips'
    height (every row's scan is its own, so the segments of all rows go in
    one launch). Returns (cost, (hf, hb))."""
    n_bits = p.census_ksize * p.census_wsize - 1
    if cl is None:
        cl = sgm_cuda.census_words(left, p.census_ksize, p.census_wsize)
    if cr is None:
        cr = sgm_cuda.census_words(right, p.census_ksize, p.census_wsize)
    cost = sgm_cuda.cost_volume(cl, cr, p.num_disparities, p.min_disparity, n_bits)
    if crop:
        cost = cost[crop:-crop]
    H, W, D = cost.shape
    seg = _effective_wseg(p, W, H // strips)
    hf, hb = sgm_cuda.aggregate_dual(_segments(cost, seg), p.p1, p.p2, axis=1,
                                     out_dtype=_vol_dtype(p))
    return cost, (hf.reshape(H, W, D), hb.reshape(H, W, D))


def _kernel_select(vols, p: SGMParams, lr_rows: int | None = None):
    """The kernel path's tail: the horizontal pair or all four path volumes
    → winner statistics (four volumes: ``sum_wta_fused``, with the summed
    volume only for the LR check; the pair: ``wta_stats_from_duals``, or
    the plain ``sum_wta`` where ``stats_impl="xla"`` asks for that
    formulation) → WTA → the LR check on the leading ``lr_rows`` rows (all
    by default). Returns (disp, valid, best cost)."""
    hf, hb = vols[:2]
    lr_rows = hf.shape[0] if lr_rows is None else lr_rows
    lr = p.lr_max_diff >= 0 and lr_rows > 0
    if len(vols) == 4:
        s, *stats = sgm_cuda.sum_wta_fused(*vols, emit="hwd" if lr else "none")
        s = s[:lr_rows] if lr else None
    elif p.stats_impl != "xla":
        stats = sgm_cuda.wta_stats_from_duals(hf, hb)
        s = sgm_cuda.st_from_duals(hf[:lr_rows], hb[:lr_rows]) if lr else None
    else:
        s, *stats = sgm_cuda.sum_wta(vols, emit_sum=lr)
        s = s[:lr_rows] if lr else None
    disp, valid, best = _wta(None, p, stats)
    if lr:
        lr_ok = _left_right_check(s, disp[:lr_rows], p, "pallas")
        valid = torch.cat([valid[:lr_rows] & lr_ok, valid[lr_rows:]])
    return disp, valid, best


def _kernel_search(left, right, p: SGMParams, strips: int = 1, lr_rows: int | None = None,
                   cl=None, cr=None):
    """The kernel path (the counterpart of the reference's
    ``_cost_aggregate_pallas`` and of the packed core's kernel branch):
    :func:`_kernel_costs`, with ``paths=4`` the vertical dual sweep run per
    row strip (``strips`` equal strips: vertical paths restart at their
    seams), then :func:`_kernel_select`. Every kernel works per row except
    the vertical sweep, so the strips share one launch of each. Returns
    (disp, valid, best cost)."""
    cost, vols = _kernel_costs(left, right, p, cl, cr, strips=strips)
    if p.paths == 4:
        hs = cost.shape[0] // strips
        sweeps = [sgm_cuda.aggregate_dual(cost[g * hs:(g + 1) * hs], p.p1, p.p2, axis=0,
                                          out_dtype=_vol_dtype(p)) for g in range(strips)]
        vols += tuple(torch.cat(parts) for parts in zip(*sweeps))
    return _kernel_select(vols, p, lr_rows)


def _plain_search(cl, cr, p: SGMParams, lr: bool = True):
    """The plain path over (H, W, nw) censuses: float32 cost volume,
    aggregation, WTA and (with ``lr``) the LR check."""
    return _plain_select(aggregate(cost_from_census(cl, cr, p), p), p, lr)


def _plain_select(agg, p: SGMParams, lr: bool = True):
    """The plain path's tail: WTA on the float32 sum ``agg`` and (with
    ``lr``) the LR check. Returns (disp, valid, best cost)."""
    disp, valid, best = _wta(agg, p)
    if lr and p.lr_max_diff >= 0:
        valid = valid & _left_right_check(agg, disp, p, "xla")
    return disp, valid, best


def _disparity_core(left, right, p: SGMParams, impl: str):
    """census → cost → aggregation → WTA → LR check (no speckle/median/fill).
    Inputs are float32 (H, W); returns (disp float32 px, valid bool, best
    cost)."""
    if impl == "xla":
        cl = im.census_transform(left, p.census_ksize, p.census_wsize)
        cr = im.census_transform(right, p.census_ksize, p.census_wsize)
        return _plain_search(cl, cr, p)
    return _kernel_search(left, right, p)


def _pack_pad(img, pk: int):
    """Replicate-pad rows so H divides into pack strips of ×8 height (the
    reference's packed layout contract, which fixes where the strips'
    seams fall)."""
    H = img.shape[0]
    bh = 8
    Hh = -(-(-(-H // pk)) // bh) * bh
    Hp = pk * Hh
    if Hp != H:
        img = torch.cat([img, img[-1:].expand(Hp - H, *img.shape[1:])], dim=0)
    return img


def _disparity_core_packed(left, right, p: SGMParams, impl: str, cl_pre=None, cr_pre=None):
    """The reference's lane-packed core (pack ∈ {2, 4}), ported by its
    results: the pack row strips of the replicate-padded pair are separate
    searches over one shared census (vertical paths restart at the strip
    seams), and only the first ``lr_groups`` strips (all when 0) are
    LR-checked — what the reference's XLA branch computes and its packed
    kernels reproduce bit for bit. The kernel path runs the strips in one
    launch of each kernel but the vertical sweep (one per strip): every
    other stage works per row. ``cl_pre``/``cr_pre``: censuses of the padded
    left / right image in the impl's format ((H, W, nw) plain, (nw, H, W)
    kernel). Returns (disp, valid, best) of the unpadded rows."""
    H = left.shape[0]
    pk = p.pack
    left = _pack_pad(left, pk)
    right = _pack_pad(right, pk)
    Hh = left.shape[0] // pk
    ng_lr = p.lr_groups if 0 < p.lr_groups <= pk else pk
    if impl == "xla":
        cl = cl_pre if cl_pre is not None else im.census_transform(
            left, p.census_ksize, p.census_wsize)
        cr = cr_pre if cr_pre is not None else im.census_transform(
            right, p.census_ksize, p.census_wsize)
        parts = [_plain_search(cl[g * Hh:(g + 1) * Hh], cr[g * Hh:(g + 1) * Hh], p, lr=g < ng_lr)
                 for g in range(pk)]
        disp, valid, best = (torch.cat(q) for q in zip(*parts))
    else:
        disp, valid, best = _kernel_search(left, right, p, strips=pk, lr_rows=ng_lr * Hh,
                                           cl=cl_pre, cr=cr_pre)
    return disp[:H], valid[:H], best[:H]


def _compute_full(left, right, p: SGMParams, cl_pre=None, cr_pre=None):
    """Full-search pipeline; returns (disp, valid, best aggregated cost)."""
    left = left.to(torch.float32).contiguous()
    right = right.to(torch.float32).contiguous()
    impl = _resolve_impl(p.impl)
    with annotate("sgm.search"):
        if p.pack > 1:
            if p.pack not in (2, 4) or p.num_disparities > 128 // p.pack:
                raise ValueError(
                    "lane packing needs pack ∈ {2, 4} and num_disparities ≤ 128/pack")
            disp, valid, best = _disparity_core_packed(left, right, p, impl, cl_pre, cr_pre)
        else:
            disp, valid, best = _disparity_core(left, right, p, impl)
    valid = _speckle_suppress(disp, valid, p, impl)
    if p.median_ksize > 1:
        with annotate("sgm.median"):
            disp = _median(disp, p.median_ksize, impl)
    disp = torch.where(valid, disp, float(p.min_disparity) - 1.0)
    return disp, valid, best


def _compute_disparity(left, right, p: SGMParams):
    """compute_disparity on float32 tensors of one device."""
    if p.mode in ("hier", "hier2"):
        if p.num_disparities <= p.refine_range:
            # a full search over ≤ refine_range disparities IS the refine pass
            p = dataclasses.replace(p, mode="full")
        else:
            return _compute_disparity_hier(left, right, p)
    disp, valid, _ = _compute_full(left, right, p)
    if p.fill_invalid:
        # the fill_invalid contract (all-true mask) holds in full mode too
        with annotate("sgm.fill"):
            disp = _nearest4_fill(disp, valid, p)
        valid = torch.ones_like(valid)
    return disp, valid


# ---------------------------------------------------------------------------
# Coarse-to-fine (hier, hier2)
# ---------------------------------------------------------------------------


def _valid_mean(disp, valid):
    """Mean of the valid disparities (+1e-6 in the count), float32. The sum
    is taken in float64 and rounded once: XLA's float32 reduction order is
    its own, and this is the nearest float32 to the exact sum."""
    total = torch.where(valid, disp, 0.0).sum(dtype=torch.float64).to(torch.float32)
    count = valid.sum(dtype=torch.float64).to(torch.float32)
    return total / (count + 1e-6)


def _shift_cols(x, k: int, op):
    """op(x, op(x shifted left by k, x shifted right by k)), replicate
    borders, along axis 1."""
    left_sh = torch.cat([x[:, k:], x[:, -1:].expand(-1, k)], dim=1)
    right_sh = torch.cat([x[:, :1].expand(-1, k), x[:, :-k]], dim=1)
    return op(x, op(left_sh, right_sh))


def _compute_disparity_hier(left, right, p: SGMParams):
    """Coarse-to-fine: full-range SGM at 1/coarse_scale resolution, then
    refine_range windows at full resolution placed by the upsampled coarse
    disparity (the reference's ``_compute_disparity_hier``, step for step)."""
    R = p.refine_range
    H = left.shape[0]
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    impl = _resolve_impl(p.impl)
    with annotate("sgm.coarse"):
        d_up = _coarse_disparity(left, right, p)
    with annotate("sgm.shifts"):
        shift, shift_b = _window_shifts(d_up, p)
    if shift_b is None:
        with annotate("sgm.refine"):
            disp, valid, _ = _refine_with_shift(left, right, shift, p, mask_seams=False,
                                                post=True)
        if p.fill_invalid:
            with annotate("sgm.fill"):
                disp = _nearest4_fill(disp, valid, p)
            valid = torch.ones_like(valid)
        return disp, valid
    if R <= 32 and H % 16 == 0:
        # stacked [A; B] refine; its censuses double as the arbitration's
        with annotate("sgm.census"):
            cl_arb = _census_words_for(left, p, impl)
            cr_arb = _census_words_for(right, p, impl)
        with annotate("sgm.refine"):
            (disp, valid, cost_a), (disp_b, valid_b, cost_b) = _refine_two_windows(
                left, right, shift, shift_b, p, cl1=cl_arb, cr1=cr_arb)
    else:
        cl_pre = None
        if R <= 64:
            # both refine passes census the same (pack-padded) left image
            with annotate("sgm.census"):
                cl_pre = _census_words_for(_pack_pad(left, 4 if R <= 32 else 2), p, impl)
        with annotate("sgm.refine"):
            disp, valid, cost_a = _refine_with_shift(
                left, right, shift, p, mask_seams=True, cl_pre=cl_pre, post=False)
            disp_b, valid_b, cost_b = _refine_with_shift(
                left, right, shift_b, p, mask_seams=True, cl_pre=cl_pre, post=False, lr=False)
        with annotate("sgm.census"):
            cl_arb = cl_pre if cl_pre is not None else _census_words_for(left, p, impl)
            cr_arb = _census_words_for(right, p, impl)

    # merge: census Hamming distance against the original right image at
    # each candidate decides between the windows; the aggregated cost breaks
    # near-ties; census_kill drops candidates with noise-level evidence.
    # Offsets are zeroed where the distance is not consumed (the reference's
    # gather pruning); the result is the same.
    with annotate("sgm.arbitrate"):
        cd_a = _census_distance(cl_arb, cr_arb, torch.where(valid, disp, 0.0), p, impl)
        if p.census_kill > 0:
            valid = valid & (cd_a <= p.census_kill)
        disagree = (disp_b - disp).abs() > 2.0
        need_b = ~valid | disagree
        cd_b = _census_distance(cl_arb, cr_arb, torch.where(need_b, disp_b, 0.0), p, impl)
        if p.census_kill > 0:
            valid_b = valid_b & (cd_b <= p.census_kill)
        better_b = torch.where((cd_b - cd_a).abs() > 1.0, cd_b < cd_a, cost_b < cost_a)
        take_b = valid_b & (~valid | (disagree & better_b))
        disp = torch.where(take_b, disp_b, disp)
        valid = valid | valid_b
    d_up_c = d_up.clamp(p.min_disparity, p.min_disparity + p.num_disparities - 1)
    # one post pass on the merged field
    valid = _speckle_suppress(disp, valid, p, impl)
    if p.fill_invalid:
        # one median over the candidate-filled field serves as the merge's
        # median and the fill's smoothing
        with annotate("sgm.fill"):
            disp = _census_fill(disp, valid, d_up_c, cl_arb, cr_arb, p, impl, median_all=True)
        return disp, torch.ones_like(valid)
    if p.median_ksize > 1:
        with annotate("sgm.median"):
            disp = _median(torch.where(valid, disp, d_up_c), p.median_ksize, impl)
    disp = torch.where(valid, disp, float(p.min_disparity) - 1.0)
    return disp, valid


def _coarse_disparity(left, right, p: SGMParams):
    """The full-range search at 1/coarse_scale resolution (LR check and
    speckle kept, a 3×3 or 5×5 median), its invalid pixels filled
    occlusion-style (the median of the nearest valid value on each side of
    the row and the global mean), a 5×5 median, and the result upsampled to
    (H, W) in full-resolution pixels."""
    s = p.coarse_scale
    H, W = left.shape
    coarse_p = dataclasses.replace(
        p, mode="full", num_disparities=max(16, -(-p.num_disparities // s)),
        fill_invalid=False, min_disparity=p.min_disparity // s,
        median_ksize=3 if p.coarse_paths == 4 else 5, pack=1, paths=p.coarse_paths,
    )
    lc = im.resize(left, (H // s, W // s))
    rc = im.resize(right, (H // s, W // s))
    disp_c, valid_c = _compute_disparity(lc, rc, coarse_p)
    dl, has_l, _ = _last_valid_scan(disp_c, valid_c, 1)
    dr, has_r, _ = _last_valid_scan(disp_c, valid_c, 1, reverse=True)
    fill_g = _valid_mean(disp_c, valid_c)
    med3 = torch.maximum(torch.minimum(dl, dr), torch.minimum(torch.maximum(dl, dr), fill_g))
    fill = torch.where(has_l & has_r, med3,
                       torch.where(has_l, dl, torch.where(has_r, dr, fill_g)))
    with annotate("sgm.median"):
        disp_c = _median(torch.where(valid_c, disp_c, fill), 5, _resolve_impl(p.impl))
    # the exact column ratio (1280/426 = 3.005), not s
    return im.resize(disp_c, (H, W)) * (W / (W // s))


def _window_shifts(d_up, p: SGMParams):
    """The refine windows' integer base shifts from the upsampled coarse
    disparity: window A = the horizontal min-envelope of radius R−1 (hier2:
    then a vertical erosion) minus a margin; with hier2 also window B, whose
    top is the max-envelope of radius 2R−1, vertically dilated, plus the
    margin (None for plain hier). Both clipped to the search range."""
    s = p.coarse_scale
    R = p.refine_range
    margin = 4.0 + s
    v_rad = 2 * s + 2 if p.coarse_paths == 4 else 2 * s + 4
    lo_sh = p.min_disparity
    hi_sh = p.min_disparity + p.num_disparities - R
    env = d_up
    k = 1
    while k < R:
        env = _shift_cols(env, k, torch.minimum)
        k *= 2
    if p.mode != "hier2":
        return torch.round(env - margin).clamp(lo_sh, hi_sh), None
    env = _erode_rows(env, v_rad, torch.minimum)
    shift = torch.round(env - margin).clamp(lo_sh, hi_sh)
    env_hi = d_up
    k = 1
    while k < 2 * R:
        env_hi = _shift_cols(env_hi, k, torch.maximum)
        k *= 2
    env_hi = _erode_rows(env_hi, v_rad, torch.maximum)
    shift_b = (torch.round(env_hi + margin) - (R - 1)).clamp(lo_sh, hi_sh)
    return shift, shift_b


def _erode_rows(x, radius: int, op):
    """Morphological erosion (op=minimum) / dilation (op=maximum) along rows
    (axis 0) by doubling shifts; replicate borders."""
    k = 1
    while k < radius:
        dn = torch.cat([x[k:], x[-1:].expand(k, *x.shape[1:])], dim=0)
        up = torch.cat([x[:1].expand(k, *x.shape[1:]), x[:-k]], dim=0)
        x = op(x, op(dn, up))
        k *= 2
    return x


def _census_words_for(img, p: SGMParams, impl: str):
    """Census of an image in the impl's format: (H, W, nw) on the plain path,
    the kernel's (nw, H, W) words otherwise."""
    if impl == "xla":
        return im.census_transform(img, p.census_ksize, p.census_wsize)
    return sgm_cuda.census_words(img.contiguous(), p.census_ksize, p.census_wsize)


def _census_distance(cl, cr, disp, p: SGMParams, impl: str):
    """Hamming distance between the left census and the right census at each
    pixel's candidate disparity: data evidence against the true right image,
    independent of any warp window. Rows of cl/cr beyond disp's height (pack
    padding) are ignored."""
    H, W = disp.shape
    x = torch.arange(W, device=disp.device)
    md = torch.minimum(torch.round(disp).to(torch.int32).clamp(min=0), x[None, :])
    if impl == "xla":
        crs = cr[:H].gather(1, (x[None, :] - md)[..., None].expand(-1, -1, cr.shape[-1]).long())
        return im.popcount32(cl[:H] ^ crs).to(torch.float32).sum(dim=-1)
    crs = sgm_cuda.shift_gather(cr[:, :H, :W].contiguous(), md.to(torch.int32),
                                p.min_disparity + p.num_disparities)
    dist = None
    for w in range(cl.shape[0]):
        d = im.popcount32(cl[w, :H, :W] ^ crs[w]).to(torch.float32)
        dist = d if dist is None else dist + d
    return dist


def _last_valid_scan(values, valid, axis: int, reverse: bool = False):
    """The nearest preceding (following, with ``reverse``) valid value along
    ``axis``, whether there is one, and its distance (2²⁰ where there is
    none). The reference takes log₂(n) doubling steps for the TPU; a running
    max of the valid indices gives the same values."""
    n = values.shape[axis]
    shape = [1] * values.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=values.device).reshape(shape)
    vs, has, src = sgm_cuda.nearest_valid(values, valid, axis, reverse)
    dist = torch.where(has, (idx - src).abs().to(torch.int32), 1 << 20)
    return vs, has, dist


def _census_distance_multi(cl, cr, disps, p: SGMParams, impl: str):
    """:func:`_census_distance` over k candidate maps in one stacked gather
    (rows are independent, so stacking is exact). Returns the k maps."""
    k = len(disps)
    H = disps[0].shape[0]
    stack = torch.cat(disps, dim=0)
    if impl == "xla":
        cl_k, cr_k = torch.cat([cl[:H]] * k), torch.cat([cr[:H]] * k)
    else:
        cl_k, cr_k = torch.cat([cl[:, :H]] * k, dim=1), torch.cat([cr[:, :H]] * k, dim=1)
    d = _census_distance(cl_k, cr_k, stack, p, impl)
    return [d[i * H:(i + 1) * H] for i in range(k)]


def _census_fill(disp, valid, d_up, cl, cr, p: SGMParams, impl: str, median_all: bool = False):
    """Data-driven inpainting of invalid pixels (hier2's fill_invalid): the
    candidates are the min and max of the 4-direction nearest valid values
    (``d_up`` where a direction has none) and ``d_up``; the one with the best
    census evidence at the pixel wins. Then a 5×5 median (of everything with
    ``median_all``, else of the filled pixels only)."""
    if impl == "xla":
        lo = hi = None
        for axis in (0, 1):
            for reverse in (False, True):
                val, has, _ = _last_valid_scan(disp, valid, axis, reverse)
                val = torch.where(has, val, d_up)
                lo = val if lo is None else torch.minimum(lo, val)
                hi = val if hi is None else torch.maximum(hi, val)
    else:
        lo, hi = sgm_cuda.nearest_valid_lohi(disp, valid, d_up, axis=1)
        lo_v, hi_v = sgm_cuda.nearest_valid_lohi(disp, valid, d_up, axis=0)
        lo = torch.minimum(lo, lo_v)
        hi = torch.maximum(hi, hi_v)
    cands = (lo, hi, d_up)
    masked = [torch.where(valid, 0.0, c) for c in cands]
    best_v = best_cd = None
    for cv, cdv in zip(cands, _census_distance_multi(cl, cr, masked, p, impl)):
        if best_v is None:
            best_v, best_cd = cv, cdv
        else:
            take = cdv < best_cd - 0.5
            best_v = torch.where(take, cv, best_v)
            best_cd = torch.where(take, cdv, best_cd)
    filled = torch.where(valid, disp, best_v)
    if median_all:
        return _median(filled, p.median_ksize, impl) if p.median_ksize > 1 else filled
    return torch.where(valid, disp, _median(filled, 5, impl))


def _nearest4_fill(disp, valid, p: SGMParams):
    """Inpaint invalid pixels from the nearest valid neighbour along the 4
    axis directions (min distance wins; ties prefer the smaller = farther
    disparity), the valid mean where there is none, then smooth the filled
    pixels with a 5×5 median of the filled map."""
    best_val = _valid_mean(disp, valid).expand(disp.shape)
    best_dist = torch.full(disp.shape, 1 << 20, dtype=torch.int32, device=disp.device)
    for axis in (0, 1):
        for reverse in (False, True):
            val, _, dist = _last_valid_scan(disp, valid, axis, reverse)
            take = (dist < best_dist) | ((dist == best_dist) & (val < best_val))
            best_val = torch.where(take, val, best_val)
            best_dist = torch.where(take, dist, best_dist)
    filled = torch.where(valid, disp, best_val)
    return torch.where(valid, disp, _median(filled, 5, _resolve_impl(p.impl)))


def _ramp(shift, p: SGMParams):
    """1.0 where the integer shift field ramps (total variation ≥ 3 over the
    census support ± 1 column, along the row), else 0.0."""
    ds = F.pad((shift[:, 1:] - shift[:, :-1]).abs(), (1, 0))
    r_c = p.census_ksize // 2 + 2
    dsp = torch.cat([ds[:, :1].expand(-1, r_c), ds, ds[:, -1:].expand(-1, r_c)], dim=1)
    W = ds.shape[1]
    var = sum(dsp[:, i:i + W] for i in range(2 * r_c + 1))
    return (var >= 3.0).to(torch.float32)


def _gather_at(src, drr, R: int, impl: str):
    """src[y, x − drr[y, x]] (drr ≤ x, < R): a gather on the plain path,
    ``shift_gather`` on the kernel path."""
    if impl == "xla":
        x = torch.arange(src.shape[1], device=src.device)
        return src.gather(1, (x[None, :] - drr).long())
    return sgm_cuda.shift_gather(src.contiguous(), drr, R)


def _refine_params(p: SGMParams, **kw) -> SGMParams:
    return dataclasses.replace(p, mode="full", num_disparities=p.refine_range,
                               min_disparity=0, **kw)


def _refine_with_shift(left, right, shift, p: SGMParams, mask_seams: bool = False,
                       cl_pre=None, post: bool = True, lr: bool = True):
    """One hier refine pass: warp the right image by the integer ``shift``
    field, run a refine_range-window full search, undo the shift (the shift
    travels with the right image's columns: disp(x) = dr(x) + shift(x −
    dr(x))). ``mask_seams`` invalidates matches whose column sits in a ramp
    of the shift field; ``post`` runs speckle + median; ``lr`` the LR check.
    Returns (disp with invalid = min_disparity − 1, valid, best cost)."""
    R = p.refine_range
    W = left.shape[1]
    xs = torch.arange(W, dtype=torch.int32, device=left.device)[None, :]
    impl = _resolve_impl(p.impl)
    sh = shift.to(torch.int32)
    if impl == "xla":
        warped_right = right.gather(1, (xs - sh).clamp(0, W - 1).long())
    else:
        off = torch.minimum(sh.clamp(min=0), xs)
        warped_right = sgm_cuda.shift_gather(
            right.contiguous(), off, p.min_disparity + p.num_disparities - R + 1)
    refine_p = _refine_params(
        p, pack=4 if R <= 32 else (2 if R <= 64 else 1),
        speckle_window_size=p.speckle_window_size if post else 0,
        median_ksize=p.median_ksize if post else 1,
        lr_max_diff=p.lr_max_diff if lr else -1,
    )
    disp_r, valid, best = _compute_full(left, warped_right, refine_p, cl_pre=cl_pre)
    drr = torch.minimum(torch.round(disp_r).to(torch.int32).clamp(min=0), xs)
    shift_at = _gather_at(shift, drr, R, impl)
    if mask_seams:
        valid = valid & (_gather_at(_ramp(shift, p), drr, R, impl) < 0.5)
    disp = torch.where(valid, disp_r + shift_at, float(p.min_disparity) - 1.0)
    return disp, valid, best


def _refine_two_windows(left, right, shift_a, shift_b, p: SGMParams, cl1=None, cr1=None):
    """Both hier2 refine windows as one stacked search over [A(H); B]: with
    the horizontal path family every row is independent, so the stack gives
    the two sequential passes' numbers. B is every 3rd row when
    ``b_decimate=3`` and H % 24 == 0 (the A/B boundary lands on a strip
    seam), else full height. The warp happens in census space: the right
    census words (``cr1``, also the arbitration's) are gathered by the shift
    field. The LR check runs on window A's rows only. Requires R ≤ 32 and
    H % 16 == 0. Returns ((disp_a, valid_a, best_a), (disp_b, valid_b,
    best_b)), B row-repeated back to H; invalid pixels carry
    min_disparity − 1."""
    R = p.refine_range
    H, W = left.shape
    if not (R <= 32 and H % 16 == 0):
        raise ValueError("the stacked refine needs refine_range ≤ 32 and H % 16 == 0")
    dec = p.b_decimate if (p.b_decimate == 3 and H % 24 == 0) else 1
    impl = _resolve_impl(p.impl)
    xs = torch.arange(W, dtype=torch.int32, device=left.device)[None, :]
    left_b, shift_bd = (left[::3], shift_b[::3]) if dec == 3 else (left, shift_b)
    left2 = torch.cat([left, left_b])
    shift2 = torch.cat([shift_a, shift_bd])
    max_sh = p.min_disparity + p.num_disparities - R + 1
    if cl1 is None:
        cl1 = _census_words_for(left, p, impl)
    if cr1 is None:
        cr1 = _census_words_for(right, p, impl)
    sh2 = shift2.to(torch.int32)
    if impl == "xla":
        cl2 = torch.cat([cl1, cl1[::dec]])
        cr2w = torch.cat([cr1, cr1[::dec]])
        src_x = (xs - sh2).clamp(0, W - 1)
        cr2 = cr2w.gather(1, src_x[..., None].expand(-1, -1, cr2w.shape[-1]).long())
    else:
        cl2 = torch.cat([cl1[:, :H], cl1[:, :H:dec]], dim=1).contiguous()
        cr2w = torch.cat([cr1[:, :H], cr1[:, :H:dec]], dim=1).contiguous()
        # one launch gathers every census word by the shift field
        cr2 = sgm_cuda.shift_gather(cr2w, torch.minimum(sh2.clamp(min=0), xs), max_sh)
    refine_p = _refine_params(p, pack=4, speckle_window_size=0, median_ksize=1,
                              lr_groups=3 if dec == 3 else 2)
    # both censuses are given: the image operands only define the shape
    disp_r2, valid2, best2 = _compute_full(left2, left2, refine_p, cl_pre=cl2, cr_pre=cr2)
    drr2 = torch.minimum(torch.round(disp_r2).to(torch.int32).clamp(min=0), xs)
    ramp = _ramp(shift2, p)
    if impl == "xla":
        shift_at2, ramp_at2 = _gather_at(shift2, drr2, R, impl), _gather_at(ramp, drr2, R, impl)
    else:
        # one batched gather for both lookups (same offsets)
        shift_at2, ramp_at2 = sgm_cuda.shift_gather(torch.stack([shift2, ramp]), drr2, R)
    valid2 = valid2 & (ramp_at2 < 0.5)
    disp2 = torch.where(valid2, disp_r2 + shift_at2, float(p.min_disparity) - 1.0)
    if dec == 1:
        return ((disp2[:H], valid2[:H], best2[:H]), (disp2[H:], valid2[H:], best2[H:]))

    def up(x):  # row-repeat the decimated window B back to H
        return x[H:].repeat_interleave(3, dim=0)[:H]

    return ((disp2[:H], valid2[:H], best2[:H]), (up(disp2), up(valid2), up(best2)))


def exact_speckle_postpass(disp, params: SGMParams, impl: str = "device"):
    """The exact cv2.filterSpeckles post-pass (4-connected components), in
    place of the windowed approximation of :func:`_speckle_suppress`.

    ``disp`` is a finished disparity map (a tensor or an array, float px)
    whose invalid pixels carry ``min_disparity − 1``; returns (disp, valid)
    with the components of at most ``speckle_window_size`` pixels set to
    ``min_disparity − 1`` too. Run the engine with ``speckle_window_size=0``
    to replace the approximation rather than stack the two.

    ``impl="device"``: the connected-component labelling of
    :mod:`stereo.speckle_ccl` on ``disp``'s device. ``impl="native"``: the
    host flood fill of ``native/speckle.cpp`` (:mod:`ops.native`), which
    returns CPU tensors and raises where its library cannot be built."""
    if impl not in ("device", "native"):
        raise ValueError(f"impl must be 'device' or 'native', got {impl!r}")
    sentinel = float(params.min_disparity) - 1.0
    d = torch.as_tensor(disp).to(torch.float32)
    if params.speckle_window_size > 0:
        if impl == "device":
            from stereovision_tpu_torch.stereo.speckle_ccl import filter_speckles_exact

            d, _ = filter_speckles_exact(d, sentinel, params.speckle_window_size,
                                         params.speckle_range)
        else:
            from stereovision_tpu_torch.ops import native

            with annotate("sync.exact_speckle"):
                host = d.cpu()
            d = torch.from_numpy(native.filter_speckles(
                host.numpy(), sentinel, params.speckle_window_size, params.speckle_range)[0])
    return d, d > sentinel


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _as_image(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _disparity_and_confidence(left, right, p: SGMParams):
    disp, valid = _compute_disparity(left, right, p)
    lo = p.min_disparity + 1
    hi = p.min_disparity + p.num_disparities - 1
    return disp, (valid & (disp > lo) & (disp < hi)).to(torch.float32)


def _capture_counted(fn, inputs):
    """:func:`utils.graphs.capture` in an ``sgm.capture`` span; each replay
    in an ``sgm.replay`` span adds the kernel launches that the captured
    call counted to :func:`sgm_cuda.launch_counts`."""
    before = sgm_cuda.launch_counts()
    with annotate("sgm.capture"):
        replay, outputs = graphs.capture(fn, inputs)
    added = {k: n - before.get(k, 0) for k, n in sgm_cuda.launch_counts().items()
             if n != before.get(k, 0)}

    def counted(*args):
        with annotate("sgm.replay"):
            out = replay(*args)
        sgm_cuda.add_launch_counts(added)
        return out

    return counted, outputs


# the public calls' CUDA graphs, by (engine function, shapes, settings,
# device); ``GRAPHS.reset()`` frees them, ``GRAPHS.resize(0)`` runs every
# call eagerly (what a recorder of each call's kernel launches needs)
GRAPHS = graphs.GraphCache(_capture_counted)


def _engine(fn, left, right, p: SGMParams):
    """``fn(left, right, p)`` on float32 images of one device: eagerly on
    the CPU; on a card eagerly the first time its shapes, settings and
    device come, captured into a CUDA graph the second, replayed after."""
    key = None if left.device.type != "cuda" else (fn, left.shape, right.shape, p, left.device)
    return GRAPHS(key, functools.partial(fn, p=p), left, right)


def graph_counts() -> dict[str, int]:
    """The public engine calls since the last ``GRAPHS.reset()``, by how
    they ran: ``eager``, ``captures`` (into a CUDA graph) and ``replays``."""
    return dict(GRAPHS.counts)


def compute_disparity(left, right, params: SGMParams = SGMParams(), device="cuda"):
    """Rectified grayscale pair (H, W) → (disparity float32 px, valid bool),
    on ``device``. Invalid pixels carry ``min_disparity − 1`` (cv2 SGBM
    convention). On a card a call whose shapes and settings recur runs
    from a CUDA graph (:func:`graph_counts`), with the same result."""
    dev = resolve_device(device)
    p = check_params(params)
    return _engine(_compute_disparity, _as_image(left, dev), _as_image(right, dev), p)


def compute_disparity_batch(lefts, rights, params: SGMParams = SGMParams(), device="cuda"):
    """(B, H, W) pairs → batched (disparity, valid); frames run one after
    another so only one frame's volumes are live."""
    outs = [compute_disparity(l, r, params, device) for l, r in zip(lefts, rights)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def disparity_with_confidence(left, right, params: SGMParams = SGMParams(), device="cuda"):
    """Disparity + the reference's confidence contract: 1.0 where disparity is
    strictly inside (min+1, min+num−1) and valid, else 0.0. Runs as
    :func:`compute_disparity` does, the confidence in the same graph."""
    dev = resolve_device(device)
    p = check_params(params)
    return _engine(_disparity_and_confidence, _as_image(left, dev), _as_image(right, dev), p)
