"""Sparse features: Harris corners + HOG descriptors + matching + two-view SfM.

Counterpart of ``stereovision_tpu/mono/features.py``: fixed-size top-K
corner lists, descriptor matching as one product, RANSAC as batched
hypotheses and triangulation as batched 4×4 eigensolves. Every function
takes leading batch dimensions where the reference vmaps it (the corners,
descriptors and matches of a whole frame stack in one call).

Three choices keep the port's results the reference's:

- the top-K is ``torch.topk`` over int64 keys that order by response, then
  by the lower flat index (``jax.lax.top_k``'s tie order), so that the
  dead slots (all −inf) hold the same points;
- the HOG histogram is a one-hot reduction a cell, whose order is fixed
  (a scatter-add of CUDA atomics adds in a different order each run);
- the RANSAC draws come from one function, :func:`draw_samples`, from a
  ``torch.Generator``; the parity tests replace it by the reference's
  ``jax.random.choice`` draws.

On a card, ``eigh``, ``svd`` and ``det`` read their error codes back to the
host: a RANSAC call synchronises a few times (``chip_smoke.py`` counts
them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.core.geometry import _matmul
from stereovision_tpu_torch.utils.backend import resolve_device, upload


# ---------------------------------------------------------------------------
# Harris corners (fixed-size top-K)
# ---------------------------------------------------------------------------


def _top_k(flat: torch.Tensor, k: int):
    """(…, N) float32 → (values, indices) of the k largest, descending, ties
    (and the −inf tail) in ascending index order: ``jax.lax.top_k``'s."""
    bits = (flat + 0.0).contiguous().view(torch.int32)     # + 0.0: −0 → +0
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)            # monotone in the float
    idx = torch.arange(flat.shape[-1], dtype=torch.int64, device=flat.device)
    key = ordered.to(torch.int64) * (1 << 32) + (0xFFFFFFFF - idx)
    pos = torch.topk(key, k, dim=-1).indices
    return flat.gather(-1, pos), pos


def harris_corners(gray, max_corners: int = 512, k: float = 0.04, nms_radius: int = 4):
    """(…, H, W) → (pts (…, K, 2) float32 xy, scores (…, K)); weak entries
    get score 0.

    The Harris response det(M) − k·trace(M)², non-maximum suppression over
    the (2r+1)² window, a 12-pixel border cut, then the global top-K (a
    fixed K keeps every later shape static). Runs on ``gray``'s device."""
    g = gray.to(torch.float32)
    gx, gy = im.sobel(im.gaussian_blur(g, 3))
    sxx = im.gaussian_blur(gx * gx, 5, 1.5)
    syy = im.gaussian_blur(gy * gy, 5, 1.5)
    sxy = im.gaussian_blur(gx * gy, 5, 1.5)
    tr = sxx + syy
    resp = sxx * syy - sxy * sxy - k * (tr * tr)
    H, W = g.shape[-2], g.shape[-1]
    # the window's maximum: max-pooling pads with −inf, which for a maximum
    # equals the reference's replicate padding
    r = nms_radius
    win_max = F.max_pool2d(resp.reshape(-1, 1, H, W), 2 * r + 1, stride=1,
                           padding=r).reshape(resp.shape)
    resp = torch.where(resp >= win_max, resp, -math.inf)
    margin = 12
    ys = torch.arange(H, device=g.device)[:, None]
    xs = torch.arange(W, device=g.device)[None, :]
    inside = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    resp = torch.where(inside, resp, -math.inf)
    scores, idx = _top_k(resp.reshape(*resp.shape[:-2], H * W), max_corners)
    pts = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    valid = torch.isfinite(scores) & (scores > 0)
    return pts, torch.where(valid, scores, 0.0)


# ---------------------------------------------------------------------------
# HOG-style descriptors
# ---------------------------------------------------------------------------


def hog_descriptors(gray, pts, patch: int = 16, cells: int = 4, bins: int = 8):
    """(…, K, 2) keypoints of (…, H, W) images → (…, K, cells²·bins)
    L2-normalized HOG descriptors: a (patch × patch) window at each point,
    its gradient magnitudes histogrammed by orientation, cell by cell."""
    g = gray.to(torch.float32)
    H, W = g.shape[-2], g.shape[-1]
    dev = g.device
    gx, gy = im.sobel(g)
    mag = im.hypot(gx, gy)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    two_pi = torch.full((), 2 * math.pi, dtype=torch.float32, device=dev)  # a true division
    bin_idx = torch.floor((ang + math.pi) / two_pi * bins).to(torch.int64) % bins

    half = patch // 2
    off = torch.arange(patch, dtype=torch.float32, device=dev) - half
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    px = (pts[..., 0, None, None] + dx).to(torch.int64).clamp(0, W - 1)  # (…, K, p, p)
    py = (pts[..., 1, None, None] + dy).to(torch.int64).clamp(0, H - 1)
    lead = pts.shape[:-2]
    flat_idx = (py * W + px).reshape(*lead, -1)
    m = mag.reshape(*lead, H * W).gather(-1, flat_idx).reshape(px.shape)
    b = bin_idx.reshape(*lead, H * W).gather(-1, flat_idx).reshape(px.shape)
    cell = patch // cells

    def by_cell(x):  # (…, K, p, p) → (…, K, cells·cells, cell·cell), row-major in each
        x = x.reshape(*x.shape[:-2], cells, cell, cells, cell).transpose(-3, -2)
        return x.reshape(*x.shape[:-4], cells * cells, cell * cell)

    onehot = by_cell(b)[..., None] == torch.arange(bins, device=dev)
    hist = torch.where(onehot, by_cell(m)[..., None], 0.0).sum(dim=-2)   # (…, K, c², bins)
    hist = hist.reshape(*hist.shape[:-2], cells * cells * bins)
    return hist / (torch.linalg.vector_norm(hist, dim=-1, keepdim=True) + 1e-6)


# ---------------------------------------------------------------------------
# Matching (one product) + two-view reconstruction
# ---------------------------------------------------------------------------


def match_descriptors(d1, d2, s1, s2, ratio: float = 0.8):
    """Mutual-nearest matching with Lowe's ratio test.

    d1, d2 (…, K, F) L2-normalized; the scores gate dead slots. Returns
    (idx2_for_1 (…, K), valid (…, K)): descriptor i of view 1 matches
    idx2_for_1[i] of view 2. The cosine similarities are one float64
    product rounded to float32 (no TF32 whatever the matmul setting)."""
    sim = (d1.double() @ d2.double().transpose(-1, -2)).to(torch.float32)   # (…, K, K)
    dead = (s1[..., :, None] <= 0) | (s2[..., None, :] <= 0)
    sim = torch.where(dead, -2.0, sim)
    top, best2 = sim.max(dim=-1)
    n2 = sim.shape[-1]
    own = best2[..., None] == torch.arange(n2, device=sim.device)
    second = torch.where(own, -2.0, sim).max(dim=-1).values
    # cosine → distance ratio test: dist1 < ratio·dist2
    d_top = im.sqrt_rn((2.0 - 2.0 * top).clamp(min=0.0))
    d_second = im.sqrt_rn((2.0 - 2.0 * second).clamp(min=0.0))
    back = sim.argmax(dim=-2)                                           # (…, K)
    mutual = back.gather(-1, best2) == torch.arange(sim.shape[-2], device=sim.device)
    return best2, mutual & (d_top < ratio * d_second) & (s1 > 0)


def _essential_from_8pt(x1n, x2n, weights=None):
    """Normalized 8-point: x1n/x2n (…, N, 2) normalized coords → E (…, 3, 3),
    projected onto the essential manifold (singular values 1, 1, 0)."""
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    dim=-1)                                             # (…, N, 9)
    if weights is not None:
        A = A * weights[..., None]
    _, V = torch.linalg.eigh(_matmul(A.transpose(-1, -2), A))
    E = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    U, s, Vt = torch.linalg.svd(E)
    s2 = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return _matmul(U, s2[:, None] * Vt)


def draw_samples(generator: torch.Generator, probs: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """(n_hyp, 8) int64 indices drawn with replacement with probabilities
    ``probs`` (K,), from ``generator`` on its device, on ``probs``' device.
    A ``probs`` of all zeros draws uniformly (no slot can be an inlier)."""
    p = probs.to(generator.device)
    p = torch.where(p.sum() > 0, p, 1.0)
    idx = torch.multinomial(p, n_hyp * 8, replacement=True, generator=generator)
    return idx.reshape(n_hyp, 8).to(probs.device)


def _sampson(E, x1n, x2n):
    """Sampson errors of (…, 3, 3) hypotheses over the K correspondences →
    (…, K)."""
    one = torch.ones_like(x1n[..., :1])
    x1h, x2h = torch.cat([x1n, one], dim=-1), torch.cat([x2n, one], dim=-1)
    Ex1 = _matmul(x1h, E.transpose(-1, -2))
    Etx2 = _matmul(x2h, E)
    num = (x2h * Ex1).sum(dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-12)


def ransac_essential(x1n, x2n, valid, generator: torch.Generator, threshold: float = 2e-3,
                     n_hyp: int = 256):
    """Batched-RANSAC essential matrix on normalized coords (K, 2): ``n_hyp``
    8-point hypotheses drawn among the valid slots, the one with the most
    inliers (the first of equals), then two all-inlier least-squares
    refits. The Sampson threshold is in normalized units (~ px / focal).
    Returns (E, inlier_mask)."""
    w = valid.to(torch.float32)
    probs = w / (w.sum() + 1e-6)
    idx = draw_samples(generator, probs, n_hyp)
    Es = _essential_from_8pt(x1n[idx], x2n[idx])                       # (n_hyp, 3, 3)
    t2 = threshold * threshold
    inl = (_sampson(Es, x1n[None], x2n[None]) < t2) & valid[None, :]
    # index_select: indexing by a tensor scalar reads it back to the host
    best = inl.sum(dim=-1).argmax().reshape(1)
    E, mask = Es.index_select(0, best)[0], inl.index_select(0, best)[0]
    for _ in range(2):
        E = _essential_from_8pt(x1n, x2n, weights=mask.to(x1n.dtype))
        mask = (_sampson(E, x1n, x2n) < t2) & valid
    return E, mask


def recover_pose_and_triangulate(E, x1n, x2n, inliers):
    """Decompose E → (R, t) by the cheirality test (the most inliers in
    front of both cameras, the first of equals); triangulate every slot.

    Returns (R, t_unit, points3d (K, 3), depth_valid (K,)); the scale is
    unobservable from two views (t has unit norm)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    U = U * torch.where(d < 0, -1.0, 1.0).to(U.dtype)
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                      device=E.device)
    Ra, Rb = _matmul(_matmul(U, Wm), Vt), _matmul(_matmul(U, Wm.T), Vt)
    # the candidates in the reference's order: (Ra, +t), (Ra, −t), (Rb, +t), (Rb, −t)
    Rs = torch.stack([Ra, Ra, Rb, Rb])
    ts = torch.stack([U[:, 2], -U[:, 2], U[:, 2], -U[:, 2]])
    eye34 = torch.eye(3, 4, dtype=E.dtype, device=E.device)
    P2 = torch.cat([Rs, ts[:, :, None]], dim=2)                        # (4, 3, 4)
    X = geom.triangulate(eye34, P2[:, None], x1n[None], x2n[None])      # (4, K, 3)
    z2 = (_matmul(X, Rs.transpose(-1, -2)) + ts[:, None, :])[..., 2]
    front = (X[..., 2] > 0) & (z2 > 0) & inliers[None]
    bi = front.sum(dim=-1).argmax().reshape(1)
    R, t = Rs.index_select(0, bi)[0], ts.index_select(0, bi)[0]
    return R, t, X.index_select(0, bi)[0], front.index_select(0, bi)[0]


def sparse_motion_depth(prev_gray, gray, K_cam, generator: torch.Generator,
                        max_corners: int = 512, device="cuda"):
    """The whole sparse pipeline: corners → descriptors → match → E-RANSAC →
    pose + triangulated sparse depth (up to the monocular scale).

    Returns dict(pts_prev, pts_curr, points3d, depth (K,), valid (K,), R,
    t_unit)."""
    dev = resolve_device(device)
    frames = upload(torch.stack([torch.as_tensor(prev_gray), torch.as_tensor(gray)]), dev)
    K_cam = torch.as_tensor(K_cam, device=dev)
    pts, scores = harris_corners(frames, max_corners)
    desc = hog_descriptors(frames, pts)
    midx, mvalid = match_descriptors(desc[0], desc[1], scores[0], scores[1])
    p1, q2 = pts[0], pts[1][midx]

    def normalized(p):
        p = p.to(K_cam.dtype)  # the reference promotes to K's dtype
        inv = torch.ones_like(K_cam[0, :2]) / K_cam.diagonal()[:2]   # a true division
        return torch.stack([(p[:, 0] - K_cam[0, 2]) * inv[0],
                            (p[:, 1] - K_cam[1, 2]) * inv[1]], dim=-1)

    x1n, x2n = normalized(p1), normalized(q2)
    E, inl = ransac_essential(x1n, x2n, mvalid, generator)
    R, t, X, good = recover_pose_and_triangulate(E, x1n, x2n, inl)
    return {"pts_prev": p1, "pts_curr": q2, "points3d": X, "depth": X[:, 2], "valid": good,
            "R": R, "t_unit": t}
