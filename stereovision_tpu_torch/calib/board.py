"""Chessboard detection: saddle-point response → NMS → subpixel → grid order.

Counterpart of ``stereovision_tpu/calib/board.py`` (the replacement of
``cv2.findChessboardCorners`` + ``cv2.cornerSubPix``). The response and the
subpixel refinement run on the device; the refinement is one batched
tensor loop over every corner of the board. The peak picking, the ring
filter and the combinatorial grid ordering run on the host in numpy, on
the few hundred candidates, as in the reference: one copy of the response
map down a detection (two where the retry on a normalized image runs).
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.utils.backend import resolve_device, upload


# ---------------------------------------------------------------------------
# Saddle response (device) + NMS (host)
# ---------------------------------------------------------------------------


def corner_response(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Chessboard-corner (saddle-point) response: −det(Hessian) of the
    smoothed image, positive at X-junctions, ~0 elsewhere. (..., H, W) →
    the same shape."""
    g = im.gaussian_blur(gray, int(2 * round(3 * sigma) + 1), sigma)
    gx, gy = im.sobel(g)
    gxx, gxy = im.sobel(gx)
    _, gyy = im.sobel(gy)
    return -(gxx * gyy - gxy * gxy)


def _nms_candidates(resp: np.ndarray, max_corners: int, radius: int = 5):
    """Peak picking with radius suppression, strongest first."""
    H, W = resp.shape
    r = np.asarray(resp)
    thresh = r.max() * 0.02
    peak = ((r >= np.roll(r, 1, 0)) & (r >= np.roll(r, -1, 0))
            & (r >= np.roll(r, 1, 1)) & (r >= np.roll(r, -1, 1)) & (r > thresh))
    ys, xs = np.nonzero(peak)
    order = np.argsort(-r[ys, xs])
    chosen = []
    taken = np.zeros((H, W), bool)
    for i in order:
        y, x = ys[i], xs[i]
        if taken[max(0, y - radius):y + radius + 1, max(0, x - radius):x + radius + 1].any():
            continue
        taken[y, x] = True
        chosen.append((x, y))
        if len(chosen) >= max_corners:
            break
    return np.asarray(chosen, np.float64).reshape(-1, 2)


def _ring_filter(gray: np.ndarray, cands: np.ndarray, radius: float = 4.5):
    """Keep only X-junction candidates: on a ring around a chessboard inner
    corner the intensity is 180°-symmetric and far from 90°-symmetric;
    board-edge junctions and texture corners fail (a ChESS-style score)."""
    if len(cands) == 0:
        return cands
    n = 16
    ang = np.arange(n) * (2 * np.pi / n)
    H, W = gray.shape
    xs = np.clip(cands[:, 0:1] + radius * np.cos(ang)[None, :], 0, W - 1.001)
    ys = np.clip(cands[:, 1:2] + radius * np.sin(ang)[None, :], 0, H - 1.001)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = xs - x0, ys - y0
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    g = gray.astype(np.float64)
    s = (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x1] * fx * (1 - fy)
         + g[y1, x0] * (1 - fx) * fy + g[y1, x1] * fx * fy)
    sym = np.abs(s - np.roll(s, n // 2, axis=1)).sum(axis=1)
    anti = np.abs(s - np.roll(s, n // 4, axis=1)).sum(axis=1)
    return cands[anti - 2.0 * sym > 0.25 * np.median(anti)]


# ---------------------------------------------------------------------------
# Subpixel refinement (device, batched over corners): cornerSubPix's model
# ---------------------------------------------------------------------------


def refine_corners_subpix(gray: torch.Tensor, corners: torch.Tensor, win: int = 11,
                          iters: int = 30, eps: float = 1e-3) -> torch.Tensor:
    """Gradient-orthogonality subpixel refinement, cv2.cornerSubPix's
    model: at the true corner c, ∇I(p) ⊥ (p − c) for every window point p;
    solve Σ w ∇I∇Iᵀ · c = Σ w (∇I∇Iᵀ) p with a Gaussian window, ``iters``
    times, each step clamped to the window.

    gray: (H, W); corners: (N, 2) float pixel coordinates on gray's device.
    The window is cv2's winSize=(win, win): a (2·win+1)² neighbourhood.
    Every corner steps at once: one (N, side, side) sampling a step. ``eps``
    is the reference's, which runs every iteration as well."""
    gray = gray.to(torch.float32)
    gx, gy = im.sobel(gray)
    side = 2 * win + 1
    off = torch.arange(side, dtype=torch.float32, device=gray.device) - win
    ys, xs = torch.meshgrid(off, off, indexing="ij")
    w = torch.exp(-(xs ** 2 + ys ** 2) / (2 * (win / 2.0) ** 2))
    c = corners.to(torch.float32)
    for _ in range(iters):
        cx, cy = c[:, 0, None, None], c[:, 1, None, None]
        px, py = cx + xs, cy + ys                        # (N, side, side)
        sgx = im._bilinear_gather(gx, px, py)
        sgy = im._bilinear_gather(gy, px, py)
        a = (w * sgx * sgx).sum(dim=(-2, -1))
        b = (w * sgx * sgy).sum(dim=(-2, -1))
        d = (w * sgy * sgy).sum(dim=(-2, -1))
        bx = (w * (sgx * sgx * px + sgx * sgy * py)).sum(dim=(-2, -1))
        by = (w * (sgx * sgy * px + sgy * sgy * py)).sum(dim=(-2, -1))
        det = a * d - b * b
        ok = det.abs() > 1e-12
        safe = torch.where(ok, det, 1.0)
        cx, cy = c[:, 0], c[:, 1]
        nx = torch.where(ok, (d * bx - b * by) / safe, cx)
        ny = torch.where(ok, (a * by - b * bx) / safe, cy)
        c = torch.stack([torch.minimum(torch.maximum(nx, cx - win), cx + win),
                         torch.minimum(torch.maximum(ny, cy - win), cy + win)], dim=-1)
    return c


# ---------------------------------------------------------------------------
# Grid ordering (host, combinatorial)
# ---------------------------------------------------------------------------


def _order_grid(cands: np.ndarray, pattern: tuple[int, int]):
    """Order candidates into a (h, w) grid through the homography that maps
    the four extreme candidates onto the unit grid's corners: every
    candidate projected, snapped to integers, every cell filled once.
    Returns (w*h, 2) in row-major order (cv2's: left→right within a row,
    top→bottom) or None."""
    w, h = pattern
    if len(cands) < w * h:
        return None

    def try_assign(corners4):
        dst = np.asarray([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64)
        Hm = _homography_np(np.asarray(corners4, np.float64), dst)
        if Hm is None:
            return None
        pts = np.concatenate([cands, np.ones((len(cands), 1))], axis=1) @ Hm.T
        g = pts[:, :2] / pts[:, 2:]
        snapped = np.round(g).astype(int)
        err = np.abs(g - snapped).max(axis=1)
        grid = -np.ones((h, w), int)
        for i in np.argsort(err):
            gx, gy = snapped[i]
            if 0 <= gx < w and 0 <= gy < h and grid[gy, gx] < 0 and err[i] < 0.3:
                grid[gy, gx] = i
        if (grid < 0).any():
            return None
        return cands[grid.reshape(-1)]

    # the extreme corners by rotated projections (robust to tilt); each
    # also in the transposed orientation
    for ang in (0.0, np.pi / 8, -np.pi / 8):
        ca, sa = np.cos(ang), np.sin(ang)
        u = cands[:, 0] * ca + cands[:, 1] * sa
        v = -cands[:, 0] * sa + cands[:, 1] * ca
        tl, tr = cands[np.argmin(u + v)], cands[np.argmax(u - v)]
        br, bl = cands[np.argmax(u + v)], cands[np.argmin(u - v)]
        for four in ([tl, tr, br, bl], [bl, tl, tr, br]):
            out = try_assign(four)
            if out is not None:
                return out
    return None


def _homography_np(src, dst):
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    try:
        _, _, vt = np.linalg.svd(np.asarray(A))
    except np.linalg.LinAlgError:
        return None
    Hm = vt[-1].reshape(3, 3)
    if abs(Hm[2, 2]) < 1e-12:
        return None
    return Hm / Hm[2, 2]


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def detect_chessboard(gray, pattern: tuple[int, int], subpix_win: int = 11,
                      max_extra: int = 16, device="cuda"):
    """Find and order chessboard inner corners.

    gray: (H, W) array-like (float or uint8). pattern: (w, h) inner-corner
    counts, cv2's argument order. Returns (found: bool, corners (w*h, 2)
    float64 numpy, row-major, or None), the order of
    cv2.findChessboardCorners followed by cornerSubPix. Where the plain
    pass fails, it retries on a locally contrast-normalized image (the
    reference's ADAPTIVE_THRESH + NORMALIZE_IMAGE retry); the subpixel
    refinement runs on the original image either way."""
    dev = resolve_device(device)
    gray_np = np.asarray(gray.cpu() if torch.is_tensor(gray) else gray, np.float32)
    gray_t = upload(gray_np, dev)
    w, h = pattern

    def attempt(img_np, img_t):
        resp = corner_response(img_t).cpu().numpy()
        cands = _ring_filter(img_np, _nms_candidates(resp, w * h + max_extra))
        if len(cands) < w * h:
            return None
        return _order_grid(cands, pattern)

    ordered = attempt(gray_np, gray_t)
    if ordered is None:
        norm_t = im.local_normalize(gray_t)
        ordered = attempt(norm_t.cpu().numpy(), norm_t)
    if ordered is None:
        return False, None
    refined = refine_corners_subpix(gray_t, upload(ordered.astype(np.float32), dev),
                                    win=subpix_win)
    return True, refined.cpu().numpy().astype(np.float64)
