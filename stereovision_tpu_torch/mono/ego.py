"""Ego-motion estimation: a batched-RANSAC homography fit to the flow field.

Counterpart of ``stereovision_tpu/mono/ego.py``: all hypotheses' minimal
sets are drawn at once, all 4-point DLTs run as one batched ``eigh``,
inliers are counted by one broadcast, then two weighted refits on the
inlier set. Nothing is read back to the host.

The hypotheses come from :func:`draw_hypotheses`, the one place that
draws: from a ``torch.Generator`` on the frame's device. (The reference
draws with ``jax.random``; its parity tests hand its draws to the port by
replacing this function.)
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.utils.backend import resolve_device


def draw_hypotheses(generator: torch.Generator, n_hyp: int, n: int) -> torch.Tensor:
    """(n_hyp, 4) int64 indices in [0, n), drawn from ``generator`` on its
    device."""
    return torch.randint(0, n, (n_hyp, 4), generator=generator, device=generator.device)


def ransac_homography(src, dst, generator: torch.Generator, threshold: float = 3.0,
                      n_hyp: int = 512, refine_iters: int = 2, device="cuda"):
    """Fit dst ≈ H·src robustly. src/dst: (N, 2).

    Returns (H (3, 3), inlier_mask (N,), n_inliers): ``n_hyp`` hypotheses
    from ``generator``, the one with most inliers (the first of equals),
    then ``refine_iters`` least-squares refits on its inliers."""
    dev = resolve_device(device)
    src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    idx = draw_hypotheses(generator, n_hyp, src.shape[0]).to(dev)
    Hs = geom.homography_dlt(src[idx], dst[idx])                  # (n_hyp, 3, 3)
    proj = geom.apply_homography(Hs, src[None].expand(n_hyp, -1, -1))  # (n_hyp, N, 2)
    t2 = threshold * threshold
    inl = ((proj - dst[None]) ** 2).sum(dim=-1) < t2
    best = inl.sum(dim=-1).argmax().reshape(1)
    # index_select: indexing by a tensor scalar reads it back to the host
    H, mask = Hs.index_select(0, best)[0], inl.index_select(0, best)[0]
    for _ in range(refine_iters):
        H = _weighted_dlt(src, dst, mask.to(src.dtype))
        mask = ((geom.apply_homography(H, src) - dst) ** 2).sum(dim=-1) < t2
    return H, mask, mask.sum()


def _weighted_dlt(src, dst, w):
    """Weighted homography DLT (zero weights drop the outliers)."""
    mean_w = w.sum() + 1e-9

    def norm(p):
        mean = (p * w[:, None]).sum(dim=0) / mean_w
        d = torch.sqrt(((p - mean) ** 2).sum(dim=-1) + 1e-12)
        scale = (2.0 ** 0.5) / ((d * w).sum() / mean_w + 1e-12)
        one, zero = torch.ones_like(scale), torch.zeros_like(scale)
        T = torch.stack([torch.stack([scale, zero, -scale * mean[0]]),
                         torch.stack([zero, scale, -scale * mean[1]]),
                         torch.stack([zero, zero, one])])
        return (p - mean) * scale, T

    sn, Ts = norm(src)
    dn, Td = norm(dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
    _, V = torch.linalg.eigh(geom._matmul(A.T, A))
    Hn = V[:, 0].reshape(3, 3)
    H = geom._matmul(geom._matmul(torch.linalg.inv_ex(Td)[0], Hn), Ts)
    return H / torch.where(H[2, 2].abs() < 1e-12, 1e-12, H[2, 2])


def estimate_ego_motion(flow, generator: torch.Generator, step: int = 16,
                        threshold: float = 3.0, min_inliers: int = 15, n_hyp: int = 512,
                        device="cuda"):
    """Sample the flow on a ``step``-px grid, RANSAC a homography from
    p → p + flow, and densify the predicted ego-flow for every pixel.

    Returns (valid: bool tensor, expected_flow (H, W, 2))."""
    dev = resolve_device(device)
    flow = torch.as_tensor(flow, dtype=torch.float32, device=dev)
    H_img, W_img = flow.shape[0], flow.shape[1]
    ys = torch.arange(step // 2, H_img, step, device=dev)
    xs = torch.arange(step // 2, W_img, step, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    pts = torch.stack([gx, gy], dim=-1).to(flow.dtype)
    Hm, _, n_inl = ransac_homography(pts, pts + flow[gy, gx], generator, threshold, n_hyp,
                                     device=dev)
    valid = n_inl >= min_inliers
    yy = torch.arange(H_img, dtype=flow.dtype, device=dev)[:, None].expand(H_img, W_img)
    xx = torch.arange(W_img, dtype=flow.dtype, device=dev)[None, :].expand(H_img, W_img)
    coords = torch.stack([xx, yy], dim=-1)
    warped = geom.apply_homography(Hm, coords.reshape(-1, 2)).reshape(H_img, W_img, 2)
    return valid, torch.where(valid, warped - coords, 0.0)
