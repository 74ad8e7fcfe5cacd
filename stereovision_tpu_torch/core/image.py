"""Image operations of the disparity path, as plain PyTorch ops.

Counterpart of ``stereovision_tpu/core/image.py``: the same functions with
the same names, arguments and layouts (channel-last, replicate borders), on
tensors of any device. Here are the pieces of the disparity path and its
apps: the exact remap and its separable form (two passes of the
``shift_gather`` kernel, #7), resize, median, census, Hamming costs and
the colormaps; and the pieces of the fused path: luma, Gaussian, bilateral
and box filters, the occlusion detector's block statistics and histogram,
and the min-max normalization; and the mono apps' percentile
normalization; and the pieces of calibration and the sparse features:
RGB luma, the Sobel gradients, the local contrast normalization, the
Shannon entropy and the one-word Hamming distance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# BT.601 luma weights, cv2.cvtColor(..., COLOR_BGR2GRAY)'s
_BGR_LUMA = (0.114, 0.587, 0.299)


def grayscale_bgr(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR → (..., H, W) luma, cv2 BGR2GRAY's weights."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return _BGR_LUMA[0] * b + _BGR_LUMA[1] * g + _BGR_LUMA[2] * r


def grayscale_rgb(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB → (..., H, W) luma, the same weights."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return _BGR_LUMA[2] * r + _BGR_LUMA[1] * g + _BGR_LUMA[0] * b


def _bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W[, C]) at float coords (x, y) with border
    replication (cv2.remap INTER_LINEAR's interpolation)."""
    H, W = img.shape[0], img.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None] if img.ndim == 3 else (x - x0)
    wy = (y - y0)[..., None] if img.ndim == 3 else (y - y0)
    # clamp before the integer conversion so far-out coordinates cannot
    # overflow it; the index clip below gives the same result either way
    x0i = x0.clamp(-1, W).to(torch.int64).clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.clamp(-1, H).to(torch.int64).clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]

    def lerp(a, b, w):
        # a·(1−w) + b·w with the first product fused into the add: the form
        # XLA compiles the reference's lerp to, so the rectified images equal
        # the jitted reference's bit for bit (a census bit of two near-equal
        # neighbours flips on a 1-ulp difference)
        return torch.addcmul(b * w, a, 1 - w)

    return lerp(lerp(v00, v01, wx), lerp(v10, v11, wx), wy)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR) equivalent: sample img at (map_x, map_y).

    img: (H, W) or (H, W, C); maps: (Ho, Wo). Out-of-bounds samples are zeroed
    (BORDER_CONSTANT 0, cv2's default).
    """
    out = _bilinear_gather(img, map_x, map_y)
    H, W = img.shape[0], img.shape[1]
    valid = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    if img.ndim == 3:
        valid = valid[..., None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def warp_axis_shift(src: torch.Tensor, off: torch.Tensor, R: int) -> torch.Tensor:
    """out[y, x] = lerp(src[y, x + ⌊off⌋], src[y, x + ⌊off⌋ + 1]) along the
    last axis, |off| < R, replicate borders: two launches of
    :func:`ops.sgm_cuda.shift_gather` with offsets below 2R + 1 on the
    edge-padded source (their plain version on CPU tensors). The 1-D step
    of :func:`remap_separable`."""
    from stereovision_tpu_torch.ops import sgm_cuda

    off = off.clamp(-R, R - 1 - 1e-4)
    fl = torch.floor(off)
    frac = off - fl
    P = _pad_replicate(src, R, -1).contiguous()
    offs = (R - fl).to(torch.int32)                     # ∈ [1, 2R]
    offs_full = torch.nn.functional.pad(offs, (2 * R, 0))
    g0 = sgm_cuda.shift_gather(P, offs_full, 2 * R + 1)[:, 2 * R:]
    g1 = sgm_cuda.shift_gather(P, offs_full - 1, 2 * R + 1)[:, 2 * R:]
    # g0·(1 − frac) + g1·frac with the second product fused into the add:
    # the form XLA compiles the reference's lerp to under jit
    return torch.addcmul(g0 * (1.0 - frac), g1, frac)


def remap_separable(img: torch.Tensor, map_x: torch.Tensor, map_y_adj: torch.Tensor,
                    valid: torch.Tensor, range_x: int, range_y: int) -> torch.Tensor:
    """:func:`remap` for smooth fixed maps (stereo rectification) as two
    1-D :func:`warp_axis_shift` passes, down the columns then along the
    rows, instead of the per-element 2-D gather. The Catmull–Smith form:
    the vertical pass reads the adjusted map ``map_y_adj`` (map_y at the
    inverse of map_x along x), so the horizontal pass's source columns
    carry the rows the true map asks for. ``map_y_adj``, ``valid`` (the
    true map's in-image mask; outside it the result is 0, as
    :func:`remap`'s) and the displacement bounds come from
    :func:`prepare_separable_remap`. (H, W) float32 images."""
    H, W = img.shape[:2]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    tmp = warp_axis_shift(img.T.contiguous(), (map_y_adj - ys).T.contiguous(), range_y).T
    out = warp_axis_shift(tmp.contiguous(), map_x - xs, range_x)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def prepare_separable_remap(map_x, map_y, max_range: int = 96):
    """The host's preparation of :func:`remap_separable` from concrete maps
    (tensors or arrays): ``(map_y_adj, valid, range_x, range_y)`` as numpy,
    or None where the decomposition does not apply (map_x decreasing along
    a row, which rectification maps never do, or a displacement bound past
    ``max_range``)."""
    map_x = np.asarray(torch.as_tensor(map_x).cpu())
    map_y = np.asarray(torch.as_tensor(map_y).cpu())
    H, W = map_x.shape
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)[:, None]
    # float32 maps can tie between adjacent columns: only a real decrease
    # refuses, and a negligible ramp breaks ties so each row's inverse is
    # well defined
    if np.diff(map_x, axis=1).min() < -1e-3:
        return None
    my_adj = np.empty_like(map_y)
    tie_break = 1e-4 * xs
    for v in range(H):
        # x' with map_x(v, x') = x (a monotone inverse, clamped at the
        # ends), then the true map's row at that source column
        row = np.maximum.accumulate(map_x[v].astype(np.float64)) + tie_break
        inv = np.interp(xs, row, xs)
        my_adj[v] = np.interp(inv, xs, map_y[v])
    valid = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    if not valid.any():
        return None
    rx = int(np.ceil(np.abs(map_x - xs[None, :])[valid].max())) + 2
    ry = int(np.ceil(np.abs(my_adj - ys).max())) + 2
    if max(rx, ry) > max_range:
        return None
    return my_adj.astype(np.float32), valid, max(rx, 1), max(ry, 1)


@functools.lru_cache(maxsize=None)
def _linear_taps(n_in: int, n_out: int, device: torch.device):
    """The nonzero entries of ``jax.image.resize``'s (n_in, n_out) weight
    matrix for ``method="linear", antialias=False`` (``compute_weight_mat``
    of jax/_src/image/scale.py): the triangle kernel at the half-pixel
    sample positions, each column divided by its sum, zeroed where the
    sample leaves [−0.5, n_in − 0.5]. Computed in float64, as the reference
    does with 64-bit floats enabled, then cast to float32. Returns (index,
    weight), each (taps, n_out), the taps of a column in ascending input
    order (index 0 and weight 0 pad a column with fewer). Cached per sizes
    and device: they are built on the host."""
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
    # the first nonzero row of each column, then the next taps − 1 rows
    first = torch.where((w != 0).any(dim=0), (w != 0).to(torch.int8).argmax(dim=0), 0)
    idx = (first[None, :] + torch.arange(taps)[:, None]).clamp(max=n_in - 1)
    wt = torch.where(idx == first[None, :] + torch.arange(taps)[:, None], w.gather(0, idx), 0.0)
    return idx.to(device), wt.to(device)


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """Contract ``axis`` with the linear resize weights: each output is
    w₀·x₀ with each further tap added as a fused multiply-add
    (``torch.addcmul``), in ascending input order."""
    idx, wt = _linear_taps(x.shape[axis], n_out, x.device)
    xm = x.movedim(axis, -1)
    acc = xm[..., idx[0]] * wt[0]
    for t in range(1, idx.shape[0]):
        acc = torch.addcmul(acc, xm[..., idx[t]], wt[t])
    return acc.movedim(-1, axis)


def resize(img: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Linear resize of (H, W[, C]) to (H', W'): ``jax.image.resize(img,
    method="linear", antialias=False)`` with half-pixel-centred sampling.
    The columns are contracted first, then the rows, each from the nonzero
    taps of the reference's weight matrix. The input comes back as float32
    when the shape is unchanged.

    Against the reference on the CPU this is bit for bit where XLA's dot
    accumulates the taps as a fused chain (the shapes of the engine's
    tests); at other shapes XLA rounds the products apart and the two differ
    by an ulp."""
    Ho, Wo = new_hw
    img = img.to(torch.float32)
    if tuple(img.shape[:2]) == (Ho, Wo):
        return img
    if img.shape[1] != Wo:
        img = _resize_axis(img, Wo, 1)
    if img.shape[0] != Ho:
        img = _resize_axis(img, Ho, 0)
    return img.contiguous()


def _pad_replicate(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    if pad == 0:
        return x
    n = x.shape[axis]
    reps = [1] * x.ndim
    reps[axis] = pad
    first = x.narrow(axis, 0, 1).repeat(reps)
    last = x.narrow(axis, n - 1, 1).repeat(reps)
    return torch.cat([first, x, last], dim=axis)


def _window_stack(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Stack the k×k neighborhood of every pixel: (..., H, W) → (..., H, W, k*k),
    replicate-padded."""
    pad = ksize // 2
    xp = _pad_replicate(_pad_replicate(img, pad, -1), pad, -2)
    H, W = img.shape[-2], img.shape[-1]
    views = [
        xp[..., dy:dy + H, dx:dx + W] for dy in range(ksize) for dx in range(ksize)
    ]
    return torch.stack(views, dim=-1)


@functools.lru_cache(maxsize=None)
def _batcher_pairs(n: int) -> tuple:
    """Compare-exchange pairs of a Batcher odd-even merge sorting network."""
    pairs = []

    def merge(lo, cnt, r):
        step = r * 2
        if step < cnt:
            merge(lo, cnt, step)
            merge(lo + r, cnt, step)
            for i in range(lo + r, lo + cnt - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, cnt):
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, cnt, 1)

    m = 1
    while m < n:
        m *= 2
    sort(0, m)
    return tuple((a, b) for a, b in pairs if a < n and b < n), m


@functools.lru_cache(maxsize=None)
def _median_pairs(n: int) -> tuple:
    """Batcher pairs pruned to the cone of influence of the median output
    (wire n//2): a compare-exchange whose wires cannot reach it never changes
    the selected value (113 of 189 pairs remain for n=25)."""
    pairs, _ = _batcher_pairs(n)
    needed = {n // 2}
    kept = []
    for a, b in reversed(pairs):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    return tuple(reversed(kept))


# cv2 getGaussianKernel's fixed tables for sigma <= 0 and ksize <= 7
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float32)
    if sigma <= 0:  # cv2's rule for sigma auto-derivation
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur on (..., H, W) with replicate borders
    (cv2.GaussianBlur): each pass the weighted sum of the k shifted views."""
    k = _gaussian_kernel1d(ksize, sigma).tolist()
    pad = ksize // 2

    def conv1d(x, axis):
        xp = _pad_replicate(x, pad, axis)
        n = x.shape[axis]
        out = xp.narrow(axis, 0, n) * k[0]
        for i in range(1, ksize):
            out = out + xp.narrow(axis, i, n) * k[i]
        return out

    return conv1d(conv1d(img, -1), -2)


@functools.lru_cache(maxsize=None)
def _bilateral_spatial(ksize: int, sigma_space: float, device: torch.device) -> torch.Tensor:
    """The flattened spatial weights of :func:`bilateral_filter`, 0 outside
    the inscribed circle; made once per device (a copy from the host each
    call would wait for the card)."""
    pad = ksize // 2
    ys, xs = np.mgrid[-pad:pad + 1, -pad:pad + 1]
    mask = np.sqrt(xs**2 + ys**2) <= pad
    spatial = (np.exp(-(xs**2 + ys**2) / (2 * sigma_space**2)) * mask).reshape(-1)
    return torch.as_tensor(spatial.astype(np.float32), device=device)


def bilateral_filter(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """Edge-preserving bilateral filter on (..., H, W), cv2.bilateralFilter's
    weights: the window restricted to its inscribed circle (radius d/2),
    replicate borders."""
    ksize = d if d % 2 == 1 else d + 1
    spatial_w = _bilateral_spatial(ksize, float(sigma_space), img.device).to(img.dtype)
    win = _window_stack(img, ksize)
    diff = win - img[..., None]
    wgt = torch.exp(-(diff * diff) / (2 * sigma_color * sigma_color)) * spatial_w
    return (wgt * win).sum(dim=-1) / (wgt.sum(dim=-1) + 1e-12)


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Mean filter via two 1-D passes (replicate borders)."""
    return window_sum(img, ksize) * (1.0 / (ksize * ksize))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (IEEE's, and XLA's): float32 through
    float64, which rounds exactly back; the CPU's vectorized float32
    ``torch.sqrt`` is off by an ulp for a few inputs in a hundred."""
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 else torch.sqrt(x)


def hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """√(a² + b²) in ``jnp.hypot``'s form: the larger magnitude times
    √(1 + r²), r the ratio of the smaller to it."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = lo / torch.where(hi == 0, 1.0, hi)
    return torch.where(hi == 0, hi, hi * sqrt_rn(1 + r * r))


def local_normalize(img: torch.Tensor, block: int = 33, target_std: float = 48.0,
                    mid: float = 127.5) -> torch.Tensor:
    """Adaptive contrast normalization: subtract the local mean and rescale
    by the local standard deviation over a ``block`` window, clipped to
    [0, 255] (the chessboard detector's retry on low-contrast, unevenly lit
    boards)."""
    x = img.to(torch.float32)
    mu = box_filter(x, block)
    sd = sqrt_rn((box_filter(x * x, block) - mu * mu).clamp(min=0.0))
    # a true division (a Python number over a tensor multiplies by the reciprocal)
    gain = torch.full_like(sd, target_std) / (sd + 2.0)
    return (mid + (x - mu) * gain).clamp(0.0, 255.0)


def sobel(img: torch.Tensor):
    """Sobel dx, dy on (..., H, W) with replicate borders (3×3,
    cv2-compatible): a [1, 2, 1] smoothing pass and a [−1, 0, 1] difference
    pass, each the weighted sum of three shifted views."""
    def conv1d(x, k, axis):
        xp = _pad_replicate(x, 1, axis)
        n = x.shape[axis]
        return (xp.narrow(axis, 0, n) * k[0] + xp.narrow(axis, 1, n) * k[1]
                + xp.narrow(axis, 2, n) * k[2])

    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    gx = conv1d(conv1d(img, smooth, -2), diff, -1)
    gy = conv1d(conv1d(img, diff, -2), smooth, -1)
    return gx, gy


def block_std(img: torch.Tensor, block: int = 48) -> torch.Tensor:
    """Population std over non-overlapping block×block tiles →
    (..., H//block, W//block)."""
    H, W = img.shape[-2], img.shape[-1]
    Hc, Wc = (H // block) * block, (W // block) * block
    x = img[..., :Hc, :Wc]
    x = x.reshape(*x.shape[:-2], Hc // block, block, Wc // block, block)
    return x.std(dim=(-3, -1), correction=0)


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of a [0, 255] image (cv2.calcHist), float32 counts.
    A scatter-add of ones at the truncated values: ``torch.bincount`` on a
    CUDA tensor reads the input's maximum back to the host to size its
    output, a synchronisation in the middle of a frame."""
    q = img.clamp(0, 255).to(torch.int64).reshape(-1)
    counts = torch.zeros(256, dtype=torch.int32, device=img.device)
    counts.scatter_add_(0, q, torch.ones_like(q, dtype=torch.int32))
    return counts.to(torch.float32)


def shannon_entropy(img: torch.Tensor) -> torch.Tensor:
    """The 256-bin Shannon entropy (bits) of a [0, 255] image."""
    h = histogram256(img)
    p = h / (h.sum() + 1e-12)
    return -torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0).sum()


def minmax_normalize(img: torch.Tensor, lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX): (img − min) / (max − min) · (hi − lo) + lo."""
    mn, mx = img.min(), img.max()
    return (img - mn) / torch.where(mx - mn < 1e-12, 1.0, mx - mn) * (hi - lo) + lo


@functools.lru_cache(maxsize=None)
def quantile_q(qs: tuple, device: torch.device) -> torch.Tensor:
    """The quantiles ``qs`` (percent) as a float32 vector on ``device``, made
    once a device: ``torch.quantile`` reads a q on the CPU back for its
    range check, and one copied up each call waits for the copy."""
    return torch.tensor([q / 100.0 for q in qs], dtype=torch.float32, device=device)


def percentile_normalize(img: torch.Tensor, p_lo: float, p_hi: float) -> torch.Tensor:
    """Percentile-windowed normalize to [0, 1]: (img − P[p_lo]) /
    (P[p_hi] − P[p_lo]), clipped, with numpy's linear percentiles (the MONO
    demo's 3/97)."""
    lo, hi = torch.quantile(img.reshape(-1).to(torch.float32),
                            quantile_q((float(p_lo), float(p_hi)), img.device))
    return ((img - lo) / torch.where(hi - lo < 1e-12, 1.0, hi - lo)).clamp(0.0, 1.0)


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Median filter on (..., H, W) with replicate borders (cv2.medianBlur):
    the pruned Batcher network over the k² shifted views."""
    k2 = ksize * ksize
    win = _window_stack(img, ksize)
    vals = [win[..., i] for i in range(k2)]
    for a, b in _median_pairs(k2):
        vals[a], vals[b] = torch.minimum(vals[a], vals[b]), torch.maximum(vals[a], vals[b])
    return vals[k2 // 2]


def window_sum(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Un-normalized k×k window sum via two 1-D passes (replicate borders).
    Integer-valued inputs give exact integer sums."""
    pad = ksize // 2

    def sum1d(x, axis):
        xp = _pad_replicate(x, pad, axis)
        n = x.shape[axis]
        s = xp.narrow(axis, 0, n)
        for i in range(1, ksize):
            s = s + xp.narrow(axis, i, n)
        return s

    return sum1d(sum1d(img, -1), -2)


def _bit_value(bit: int) -> int:
    """1 << bit as the int32 it is stored as (bit 31 is the sign bit)."""
    v = 1 << bit
    return v - (1 << 32) if v >= 1 << 31 else v


def census_transform(img: torch.Tensor, ksize: int = 7, wsize: int = 5) -> torch.Tensor:
    """Census bit-strings per pixel: (..., H, W) → (..., H, W, n_words) int32.

    Each neighbor of the ksize(w)×wsize(h) window (minus the center)
    contributes one "neighbor < center" bit, dy-major then dx, packed into
    as many int32 words as needed.
    """
    pad_y, pad_x = wsize // 2, ksize // 2
    xp = _pad_replicate(_pad_replicate(img, pad_x, -1), pad_y, -2)
    H, W = img.shape[-2], img.shape[-1]
    n_bits = ksize * wsize - 1
    n_words = (n_bits + 31) // 32
    words = [torch.zeros(img.shape, dtype=torch.int32, device=img.device)
             for _ in range(n_words)]
    bit = 0
    for dy in range(wsize):
        for dx in range(ksize):
            if dy == pad_y and dx == pad_x:
                continue
            v = xp[..., dy:dy + H, dx:dx + W]
            w = bit // 32
            words[w] = words[w] | ((v < img).to(torch.int32) * _bit_value(bit % 32))
            bit += 1
    return torch.stack(words, dim=-1)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount on int32 (sign-safe: masks keep every step
    non-negative; the byte counts are added without the overflowing
    multiply)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)


def hamming32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between int32 census words, word by word."""
    return popcount32(a ^ b)


def hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance summed over the trailing word axis (int32)."""
    return popcount32(a ^ b).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Colormaps (turbo and jet lookup tables)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _turbo_lut() -> np.ndarray:
    """256×3 RGB turbo table (Google Turbo, matplotlib's registered map)."""
    import matplotlib

    return (matplotlib.colormaps["turbo"](np.linspace(0, 1, 256))[:, :3] * 255).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jet_lut() -> np.ndarray:
    import matplotlib

    return (matplotlib.colormaps["jet"](np.linspace(0, 1, 256))[:, :3] * 255).astype(np.float32)


def apply_colormap(img_u8: torch.Tensor, cmap: str = "turbo", bgr: bool = True) -> torch.Tensor:
    """uint8 image (H, W) → (H, W, 3) float32 colours of ``cmap`` ("turbo"
    or "jet"), BGR unless ``bgr=False`` (cv2.applyColorMap's role)."""
    lut = torch.from_numpy(_turbo_lut() if cmap == "turbo" else _jet_lut()).to(img_u8.device)
    rgb = lut[img_u8.to(torch.int64).clamp(0, 255)]
    return rgb.flip(-1) if bgr else rgb
