"""The plain reference of the depth pipeline: rectification, the census/SGM
disparity engine (the full search and the coarse-to-fine ``hier2`` mode)
and the depth conversion, in plain PyTorch.

It is a frozen, independent copy of the semantics of the program's plain
path (``impl="xla"``), written again here so that it imports nothing of the
program: the same operations on the same inputs give the same maps. Where
it departs in form, the numbers stay the same:

- the horizontal path scans of the refine strips run as one batch of rows
  (every row's scan is its own, so stacking rows changes nothing);
- the median is ``torch.median`` over the window (the median of an odd
  count is one value, whatever network selects it);
- every path cost is an integer below 2**24, exact in float32 whatever the
  order of the sums.

``dtype`` is the floating type of every real-valued map (images, costs,
sums, disparities, depth): float32, as the configurations state, or a
lower precision for the comparison's control. Indices and census words
stay integers.

    ref = Reference(config, device="cuda")
    disp, conf, depth = ref(left_u8, right_u8)

The comparison that decides ``correct`` is here too (:func:`numbers`):
three numbers a frame, each a share of the frame's pixels, the worst
frame's compared with its limit (``limits/<config>.json``):

- ``conf_mismatch``: the confidence (0 or 1) differs;
- ``disp_off``: confident in both, and the disparities differ by more
  than ``disp_tol_px``;
- ``depth_off``: confident in both, and the depths differ by more than
  ``depth_rtol`` of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.depth_config import Params, calibration

_BIG = 1e9


# ---------------------------------------------------------------------------
# Rectification
# ---------------------------------------------------------------------------


def _distort(xy, dist):
    """Brown-Conrady (+rational) distortion of normalized coords (..., 2);
    ``dist`` is k1 k2 p1 p2 k3 [k4 k5 k6]."""
    d = torch.cat([dist.ravel(), dist.new_zeros(8)])[:8]
    k1, k2, p1, p2, k3, k4, k5, k6 = d.unbind()
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + p2 * xy2
    return torch.stack([xd, yd], dim=-1)


def rectify_maps(K, dist, R, P, size, device):
    """cv2.initUndistortRectifyMap: for each rectified pixel, the source
    pixel in the distorted image, computed in float64, returned float32."""
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    K, dist, R, P = t(K), t(dist), t(R), t(P)
    w, h = size
    u = (torch.arange(w, dtype=f64, device=device) - P[0, 2]) / P[0, 0]
    v = (torch.arange(h, dtype=f64, device=device) - P[1, 2]) / P[1, 1]
    gx, gy = torch.meshgrid(u, v, indexing="xy")
    rays = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    pts = rays @ torch.linalg.inv(R).T
    z = pts[..., 2:]
    xy = pts[..., :2] / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    xyd = _distort(xy, dist)
    return ((xyd[..., 0] * K[0, 0] + K[0, 2]).to(torch.float32),
            (xyd[..., 1] * K[1, 1] + K[1, 2]).to(torch.float32))


def remap(img, map_x, map_y):
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of an (H, W) image; the
    lerp is a·(1−w) + b·w with the first product fused into the add."""
    H, W = img.shape
    map_x, map_y = map_x.to(img.dtype), map_y.to(img.dtype)
    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    wx, wy = map_x - x0, map_y - y0
    x0i = x0.clamp(-1, W).to(torch.int64).clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.clamp(-1, H).to(torch.int64).clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)

    def lerp(a, b, w):
        return torch.addcmul(b * w, a, 1 - w)

    out = lerp(lerp(img[y0i, x0i], img[y0i, x1i], wx), lerp(img[y1i, x0i], img[y1i, x1i], wx), wy)
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


# ---------------------------------------------------------------------------
# Image pieces
# ---------------------------------------------------------------------------


def _linear_taps(n_in, n_out, device):
    """Half-pixel linear resize weights (no antialias) of an axis of n_in
    samples to n_out: (index, weight), each (taps, n_out), from the float64
    weight matrix normalised by column, cast to float32."""
    f64 = torch.float64
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=f64) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    w = (1.0 - (sample[None, :] - torch.arange(n_in, dtype=f64)[:, None]).abs()).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    w = w.to(torch.float32)
    taps = max(1, int((w != 0).sum(dim=0).max()))
    first = torch.where((w != 0).any(dim=0), (w != 0).to(torch.int8).argmax(dim=0), 0)
    idx = (first[None, :] + torch.arange(taps)[:, None]).clamp(max=n_in - 1)
    wt = torch.where(idx == first[None, :] + torch.arange(taps)[:, None], w.gather(0, idx), 0.0)
    return idx.to(device), wt.to(device)


def resize(img, new_hw):
    """Linear resize of (H, W) to new_hw, columns first, each output the
    first tap's product with every further tap fused in, in input order."""
    Ho, Wo = new_hw

    def axis(x, n_out, ax):
        idx, wt = _linear_taps(x.shape[ax], n_out, x.device)
        wt = wt.to(x.dtype)
        xm = x.movedim(ax, -1)
        acc = xm[..., idx[0]] * wt[0]
        for t in range(1, idx.shape[0]):
            acc = torch.addcmul(acc, xm[..., idx[t]], wt[t])
        return acc.movedim(-1, ax)

    if img.shape[1] != Wo:
        img = axis(img, Wo, 1)
    if img.shape[0] != Ho:
        img = axis(img, Ho, 0)
    return img.contiguous()


def _pad_rep(x, pad, ax):
    if pad == 0:
        return x
    n = x.shape[ax]
    reps = [1] * x.ndim
    reps[ax] = pad
    return torch.cat([x.narrow(ax, 0, 1).repeat(reps), x, x.narrow(ax, n - 1, 1).repeat(reps)],
                     dim=ax)


def median_blur(img, k):
    """k×k median with replicate borders (cv2.medianBlur)."""
    pad = k // 2
    H, W = img.shape
    xp = _pad_rep(_pad_rep(img, pad, 1), pad, 0)
    win = torch.stack([xp[dy:dy + H, dx:dx + W] for dy in range(k) for dx in range(k)], dim=-1)
    return win.median(dim=-1).values


def window_sum(img, k):
    """k×k window sum with replicate borders, by two 1-D passes."""
    pad = k // 2

    def sum1d(x, ax):
        xp = _pad_rep(x, pad, ax)
        n = x.shape[ax]
        s = xp.narrow(ax, 0, n)
        for i in range(1, k):
            s = s + xp.narrow(ax, i, n)
        return s

    return sum1d(sum1d(img, 1), 0)


def census(img, ksize, wsize):
    """(H, W) → (H, W, words) int32: a "neighbour < centre" bit for every
    pixel of the ksize-wide, wsize-high window but the centre, row-major,
    32 to a word."""
    py, px = wsize // 2, ksize // 2
    xp = _pad_rep(_pad_rep(img, px, 1), py, 0)
    H, W = img.shape
    n_words = (ksize * wsize - 1 + 31) // 32
    words = [torch.zeros((H, W), dtype=torch.int32, device=img.device) for _ in range(n_words)]
    bit = 0
    for dy in range(wsize):
        for dx in range(ksize):
            if dy == py and dx == px:
                continue
            value = 1 << (bit % 32)
            value = value - (1 << 32) if value >= 1 << 31 else value
            words[bit // 32] = words[bit // 32] | ((xp[dy:dy + H, dx:dx + W] < img).to(torch.int32)
                                                   * value)
            bit += 1
    return torch.stack(words, dim=-1)


def popcount(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def cost_volume(cl, cr, p, dt):
    """(H, W, words) census pair → (H, W, D) Hamming costs: n_bits where
    the match leaves the image."""
    W = cl.shape[1]
    x = torch.arange(W, device=cl.device)
    d = torch.arange(p.num_disparities, device=cl.device) + p.min_disparity
    src = x[None, :] - d[:, None]
    ok = (src >= 0) & (src <= W - 1)
    cr_shift = cr[:, src.clamp(0, W - 1), :].movedim(1, 0)
    cost = popcount(cl[None] ^ cr_shift).sum(dim=-1, dtype=torch.int32).to(dt)
    cost = torch.where(ok[:, None, :], cost, float(p.n_bits))
    return cost.movedim(0, -1).contiguous()


def scan(cost, p, axis, reverse):
    """One SGM path direction along ``axis`` of (H, W, D): L = c at the
    first step, then L = c + min(n, P2, n[d±1] + P1) with n the previous
    L less its minimum over d."""
    c = cost.movedim(axis, 0)
    out = torch.empty_like(c)
    order = range(c.shape[0] - 1, -1, -1) if reverse else range(c.shape[0])
    L = None
    for i in order:
        if L is None:
            L = c[i]
        else:
            n = L - L.amin(dim=-1, keepdim=True)
            nb = F.pad(n, (1, 1), value=_BIG)
            step = torch.minimum(nb[..., :-2], nb[..., 2:]) + p.p1
            L = c[i] + torch.minimum(n.clamp(max=p.p2), step)
        out[i] = L
    return out.movedim(0, axis)


def aggregate(cost, p):
    """Sum of the horizontal pair (paths=2) or of all four directions."""
    s = scan(cost, p, 1, False) + scan(cost, p, 1, True)
    if p.paths == 2:
        return s
    return s + scan(cost, p, 0, False) + scan(cost, p, 0, True)


def wta(s, p):
    """Winner-take-all over the disparity axis with the uniqueness test and
    parabola subpixel: (disp incl. min_disparity, unique, best cost)."""
    D = s.shape[-1]
    best, idx = torch.min(s, dim=-1)
    cm = s.gather(-1, (idx - 1).clamp(min=0)[..., None])[..., 0]
    cp = s.gather(-1, (idx + 1).clamp(max=D - 1)[..., None])[..., 0]
    cm = torch.where(idx > 0, cm, _BIG)
    cp = torch.where(idx < D - 1, cp, _BIG)
    d = torch.arange(D, device=s.device)
    comp = torch.where((d - idx[..., None]).abs() > 1, s, _BIG).amin(dim=-1)
    cm = torch.where(idx == 0, best, cm)
    cp = torch.where(idx >= D - 1, best, cp)
    if p.uniqueness_ratio > 0:
        unique = comp * (100 - p.uniqueness_ratio) >= best * 100
    else:
        unique = torch.ones_like(best, dtype=torch.bool)
    if p.subpixel:
        denom = cm + cp - 2.0 * best
        offset = torch.where(denom > 1e-6, (cm - cp) / (2.0 * denom.clamp(min=1e-6)),
                             0.0).clamp(-0.5, 0.5)
        interior = (idx > 0) & (idx < D - 1)
        disp = idx.to(s.dtype) + torch.where(interior, offset, 0.0)
    else:
        disp = idx.to(s.dtype)
    return disp + p.min_disparity, unique, best


def lr_check(s, disp, p):
    """|dL(x) − dR(x − round dL)| ≤ lr_max_diff, with dR(u) = argmin over
    d of s[y, u + d, d] (ties to the smallest d)."""
    H, W, D = s.shape
    best = torch.full((H, W), _BIG, dtype=s.dtype, device=s.device)
    idx = torch.zeros((H, W), dtype=torch.int32, device=s.device)
    for d in range(min(D, W)):
        v = s[:, d:, d]
        take = v < best[:, :W - d]
        best[:, :W - d] = torch.where(take, v, best[:, :W - d])
        idx[:, :W - d] = torch.where(take, d, idx[:, :W - d])
    disp_r = idx.to(disp.dtype) + p.min_disparity
    x = torch.arange(W, device=disp.device)
    u = (x[None, :] - torch.round(disp).to(torch.int32) + p.min_disparity).clamp(0, W - 1)
    return (disp - disp_r.gather(1, u.to(torch.int64))).abs() <= p.lr_max_diff


def search(cl, cr, p, dt, lr_rows=None):
    """census pair → cost → aggregation → WTA → the LR check on the first
    ``lr_rows`` rows (all by default). Returns (disp, valid, best)."""
    s = aggregate(cost_volume(cl, cr, p, dt), p)
    disp, valid, best = wta(s, p)
    lr_rows = s.shape[0] if lr_rows is None else lr_rows
    if p.lr_max_diff >= 0 and lr_rows > 0:
        ok = lr_check(s[:lr_rows], disp[:lr_rows], p)
        valid = torch.cat([valid[:lr_rows] & ok, valid[lr_rows:]])
    return disp, valid, best


def speckle(disp, valid, p):
    """The windowed speckle filter: a pixel stays valid only where enough
    of its k×k window shares its disparity bin under one of two binnings
    half a bin apart."""
    if p.speckle_window_size <= 0:
        return valid
    k = max(3, int((2 * p.speckle_window_size) ** 0.5) | 1)
    r = float(p.speckle_range)
    nbins = (p.num_disparities + int(r)) // max(1, int(r)) + 2
    dv = torch.where(valid, disp - p.min_disparity, -2.0 * r)
    count = torch.zeros_like(dv)
    for offset in (0.0, 0.5):
        b = torch.floor(dv / r + offset)
        c = torch.zeros_like(dv)
        for bi in range(nbins):
            ind = (b == bi).to(dv.dtype)
            c = c + window_sum(ind, k) * ind
        count = torch.maximum(count, c)
    return valid & (count >= min(p.speckle_window_size, k * k) * 0.25)


def full_search(left, right, p, dt):
    """The full search: (disp with invalid at min_disparity − 1, valid)."""
    cl = census(left, p.census_ksize, p.census_wsize)
    cr = census(right, p.census_ksize, p.census_wsize)
    disp, valid, _ = search(cl, cr, p, dt)
    valid = speckle(disp, valid, p)
    if p.median_ksize > 1:
        disp = median_blur(disp, p.median_ksize)
    return torch.where(valid, disp, float(p.min_disparity) - 1.0), valid


# ---------------------------------------------------------------------------
# Coarse to fine (hier2)
# ---------------------------------------------------------------------------


def nearest_valid(values, valid, axis, reverse=False):
    """The nearest valid value at or before each position along ``axis``
    (at or after with ``reverse``), and whether there is one."""
    n = values.shape[axis]
    if reverse:
        values, valid = values.flip(axis), valid.flip(axis)
    shape = [1] * values.ndim
    shape[axis] = n
    idx = torch.arange(n, device=values.device).reshape(shape).expand(values.shape)
    src = torch.where(valid, idx, -1).cummax(dim=axis).values
    has = src >= 0
    val = torch.where(has, values.gather(axis, src.clamp(min=0)), 0.0)
    if reverse:
        val, has = val.flip(axis), has.flip(axis)
    return val, has


def valid_mean(disp, valid):
    total = torch.where(valid, disp, 0.0).sum(dtype=torch.float64).to(disp.dtype)
    count = valid.sum(dtype=torch.float64).to(disp.dtype)
    return total / (count + 1e-6)


def coarse_disparity(left, right, p, dt):
    """The full-range search at 1/coarse_scale, its holes filled from the
    nearest valid values of the row, a 5×5 median, upsampled to full
    resolution in full-resolution pixels."""
    s = p.coarse_scale
    H, W = left.shape
    cp_ = p.but(mode="full", num_disparities=max(16, -(-p.num_disparities // s)),
                fill_invalid=False, min_disparity=p.min_disparity // s,
                median_ksize=3 if p.coarse_paths == 4 else 5, pack=1, paths=p.coarse_paths)
    lc, rc = resize(left, (H // s, W // s)), resize(right, (H // s, W // s))
    disp_c, valid_c = full_search(lc, rc, cp_, dt)
    dl, has_l = nearest_valid(disp_c, valid_c, 1)
    dr, has_r = nearest_valid(disp_c, valid_c, 1, reverse=True)
    fill_g = valid_mean(disp_c, valid_c)
    med3 = torch.maximum(torch.minimum(dl, dr), torch.minimum(torch.maximum(dl, dr), fill_g))
    fill = torch.where(has_l & has_r, med3, torch.where(has_l, dl, torch.where(has_r, dr, fill_g)))
    disp_c = median_blur(torch.where(valid_c, disp_c, fill), 5)
    return resize(disp_c, (H, W)) * (W / (W // s))


def _shift_cols(x, k, op):
    left = torch.cat([x[:, k:], x[:, -1:].expand(-1, k)], dim=1)
    right = torch.cat([x[:, :1].expand(-1, k), x[:, :-k]], dim=1)
    return op(x, op(left, right))


def _erode_rows(x, radius, op):
    k = 1
    while k < radius:
        dn = torch.cat([x[k:], x[-1:].expand(k, *x.shape[1:])], dim=0)
        up = torch.cat([x[:1].expand(k, *x.shape[1:]), x[:-k]], dim=0)
        x = op(x, op(dn, up))
        k *= 2
    return x


def window_shifts(d_up, p):
    """Integer base shifts of the two refine windows: A under the row's
    min-envelope of radius R−1, B topped by its max-envelope of radius
    2R−1, both spread over rows, less/plus a margin, clipped to the range."""
    s, R = p.coarse_scale, p.refine_range
    margin = 4.0 + s
    v_rad = 2 * s + 2 if p.coarse_paths == 4 else 2 * s + 4
    lo, hi = p.min_disparity, p.min_disparity + p.num_disparities - R
    env, k = d_up, 1
    while k < R:
        env = _shift_cols(env, k, torch.minimum)
        k *= 2
    env = _erode_rows(env, v_rad, torch.minimum)
    env_hi, k = d_up, 1
    while k < 2 * R:
        env_hi = _shift_cols(env_hi, k, torch.maximum)
        k *= 2
    env_hi = _erode_rows(env_hi, v_rad, torch.maximum)
    return (torch.round(env - margin).clamp(lo, hi),
            (torch.round(env_hi + margin) - (R - 1)).clamp(lo, hi))


def _ramp(shift, p, dt):
    ds = F.pad((shift[:, 1:] - shift[:, :-1]).abs(), (1, 0))
    r_c = p.census_ksize // 2 + 2
    dsp = torch.cat([ds[:, :1].expand(-1, r_c), ds, ds[:, -1:].expand(-1, r_c)], dim=1)
    W = ds.shape[1]
    var = sum(dsp[:, i:i + W] for i in range(2 * r_c + 1))
    return (var >= 3.0).to(dt)


def census_distance(cl, cr, disp):
    """Hamming distance of the left census and the right census at each
    pixel's rounded candidate disparity (clipped to the image)."""
    H, W = disp.shape
    x = torch.arange(W, device=disp.device)
    md = torch.minimum(torch.round(disp).to(torch.int32).clamp(min=0), x[None, :])
    crs = cr.gather(1, (x[None, :] - md)[..., None].expand(-1, -1, cr.shape[-1]).to(torch.int64))
    return popcount(cl ^ crs).to(disp.dtype).sum(dim=-1)


def refine_two_windows(left, right, shift_a, shift_b, cl, cr, p, dt):
    """Both refine windows, R disparities each, over the right census
    warped by their shift fields: A on every row (LR-checked), B on every
    third row when H % 24 == 0 (else every row), repeated back to H.
    Returns ((disp, valid, best) of A, the same of B)."""
    R = p.refine_range
    H, W = left.shape
    dec = 3 if (p.b_decimate == 3 and H % 24 == 0) else 1
    xs = torch.arange(W, dtype=torch.int32, device=left.device)[None, :]
    shift2 = torch.cat([shift_a, shift_b[::dec]])
    cl2 = torch.cat([cl, cl[::dec]])
    cr2w = torch.cat([cr, cr[::dec]])
    src_x = (xs - shift2.to(torch.int32)).clamp(0, W - 1)
    cr2 = cr2w.gather(1, src_x[..., None].expand(-1, -1, cr2w.shape[-1]).to(torch.int64))
    rp = p.but(mode="full", num_disparities=R, min_disparity=0)
    # every row's horizontal scans are its own: the pack strips of the
    # program's layout run here as one batch of rows
    disp_r, valid, best = search(cl2, cr2, rp, dt, lr_rows=H)
    disp_r = torch.where(valid, disp_r, -1.0)
    drr = torch.minimum(torch.round(disp_r).to(torch.int32).clamp(min=0), xs)
    src = (xs - drr).to(torch.int64)
    valid = valid & (_ramp(shift2, p, dt).gather(1, src) < 0.5)
    disp2 = torch.where(valid, disp_r + shift2.gather(1, src), float(p.min_disparity) - 1.0)
    if dec == 1:
        return (disp2[:H], valid[:H], best[:H]), (disp2[H:], valid[H:], best[H:])

    def up(x):
        return x[H:].repeat_interleave(3, dim=0)[:H]

    return (disp2[:H], valid[:H], best[:H]), (up(disp2), up(valid), up(best))


def census_fill(disp, valid, d_up, cl, cr, p):
    """hier2's fill: each invalid pixel takes, of the min and the max of the
    four directions' nearest valid values (``d_up`` where a direction has
    none) and ``d_up``, the one with the least census distance (by more
    than half a bit), then a median of the whole field."""
    lo = hi = None
    for axis in (0, 1):
        for reverse in (False, True):
            val, has = nearest_valid(disp, valid, axis, reverse)
            val = torch.where(has, val, d_up)
            lo = val if lo is None else torch.minimum(lo, val)
            hi = val if hi is None else torch.maximum(hi, val)
    best_v = best_cd = None
    for cand in (lo, hi, d_up):
        cd = census_distance(cl, cr, torch.where(valid, 0.0, cand))
        if best_v is None:
            best_v, best_cd = cand, cd
        else:
            take = cd < best_cd - 0.5
            best_v = torch.where(take, cand, best_v)
            best_cd = torch.where(take, cd, best_cd)
    filled = torch.where(valid, disp, best_v)
    return median_blur(filled, p.median_ksize) if p.median_ksize > 1 else filled


def hier2(left, right, p, dt):
    """The coarse-to-fine search with census arbitration, the speckle
    filter and (with ``fill_invalid``) the census fill."""
    H = left.shape[0]
    if not (p.refine_range <= 32 and H % 16 == 0 and p.paths == 2):
        raise NotImplementedError("the reference holds hier2 with R <= 32, H % 16 == 0, paths=2")
    d_up = coarse_disparity(left, right, p, dt)
    shift, shift_b = window_shifts(d_up, p)
    cl = census(left, p.census_ksize, p.census_wsize)
    cr = census(right, p.census_ksize, p.census_wsize)
    (disp, valid, cost_a), (disp_b, valid_b, cost_b) = refine_two_windows(
        left, right, shift, shift_b, cl, cr, p, dt)
    cd_a = census_distance(cl, cr, torch.where(valid, disp, 0.0))
    if p.census_kill > 0:
        valid = valid & (cd_a <= p.census_kill)
    disagree = (disp_b - disp).abs() > 2.0
    cd_b = census_distance(cl, cr, torch.where(~valid | disagree, disp_b, 0.0))
    if p.census_kill > 0:
        valid_b = valid_b & (cd_b <= p.census_kill)
    better_b = torch.where((cd_b - cd_a).abs() > 1.0, cd_b < cd_a, cost_b < cost_a)
    take_b = valid_b & (~valid | (disagree & better_b))
    disp = torch.where(take_b, disp_b, disp)
    valid = valid | valid_b
    d_up_c = d_up.clamp(p.min_disparity, p.min_disparity + p.num_disparities - 1)
    valid = speckle(disp, valid, p)
    if p.fill_invalid:
        return census_fill(disp, valid, d_up_c, cl, cr, p), torch.ones_like(valid)
    if p.median_ksize > 1:
        disp = median_blur(torch.where(valid, disp, d_up_c), p.median_ksize)
    return torch.where(valid, disp, float(p.min_disparity) - 1.0), valid


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class Reference:
    """Rectification maps of a configuration's rig, then :meth:`__call__`
    per pair: uint8 (H, W) left and right → (disparity, confidence, depth
    in m), each (H, W) in ``dtype`` on ``device``."""

    def __init__(self, config, device, dtype=torch.float32):
        pipeline = config["pipeline"]
        cal = calibration(config)
        self.p = Params(**pipeline["params"])
        if self.p.mode not in ("full", "hier2") or self.p.pack != 1 or self.p.agg_wseg != 1:
            raise NotImplementedError(f"the reference holds the full and hier2 searches "
                                      f"without packing or segments, not {pipeline['params']}")
        self.dt, self.device = dtype, torch.device(device)
        self.min_depth, self.max_depth = pipeline["min_depth"], pipeline["max_depth"]
        size = tuple(int(v) for v in cal["img_size"])
        self.maps = (rectify_maps(cal["mtx_left"], cal["dist_left"], cal["R1"], cal["P1"], size,
                                  self.device)
                     + rectify_maps(cal["mtx_right"], cal["dist_right"], cal["R2"], cal["P2"], size,
                                    self.device))
        self.focal = float(cal["P1"][0][0])
        self.baseline_m = abs(float(torch.as_tensor(cal["T"]).ravel()[0])) / 100.0

    @torch.no_grad()
    def __call__(self, left_u8, right_u8):
        p, dt = self.p, self.dt
        left = torch.as_tensor(left_u8, device=self.device).to(dt)
        right = torch.as_tensor(right_u8, device=self.device).to(dt)
        mx1, my1, mx2, my2 = self.maps
        left, right = remap(left, mx1, my1), remap(right, mx2, my2)
        if p.mode == "hier2" and p.num_disparities > p.refine_range:
            disp, valid = hier2(left, right, p, dt)
        else:
            disp, valid = full_search(left, right, p.but(mode="full"), dt)
            if p.fill_invalid:
                raise NotImplementedError("the reference's full search takes no fill")
        lo, hi = p.min_disparity + 1, p.min_disparity + p.num_disparities - 1
        conf = (valid & (disp > lo) & (disp < hi)).to(dt)
        depth = (self.focal * self.baseline_m / (disp + 1e-6)).clamp(self.min_depth, self.max_depth)
        return disp, conf, torch.where(conf > 0, depth, 0.0)


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

NAMES = ("conf_mismatch", "disp_off", "depth_off")


def numbers(got, want, limits: dict) -> dict:
    """``got`` and ``want``: a frame's (disparity, confidence, depth), each
    an (H, W) array."""
    gd, gc, gz = (np.asarray(a, np.float64) for a in got)
    rd, rc, rz = (np.asarray(a, np.float64) for a in want)
    n = gd.size
    both = (gc > 0) & (rc > 0)
    disp_bad = both & ~(np.abs(gd - rd) <= limits["disp_tol_px"])
    depth_bad = both & ~(np.abs(gz - rz) <= limits["depth_rtol"] * np.abs(rz))
    return {
        "conf_mismatch": float(np.count_nonzero(gc != rc) / n),
        "disp_off": float(np.count_nonzero(disp_bad) / n),
        "depth_off": float(np.count_nonzero(depth_bad) / n),
    }
