"""Dense pyramidal optical flow (coarse-to-fine iterative Lucas–Kanade).

Counterpart of ``stereovision_tpu/mono/flow.py``: every pixel's 2×2 normal
equations are box filters and an elementwise solve, iterated per pyramid
level with warping. Output (H, W, 2) flow in pixels, prev + flow = curr.

The warp: ``"gather"`` is the exact per-element bilinear gather
(``core.image._bilinear_gather``); ``"shift"`` the separable form, two 1-D
passes of the ``shift_gather`` kernel (#7) through
``core.image.warp_axis_shift``; ``"auto"`` resolves to ``"gather"`` on
every device (on the H100 a per-element gather costs the device no more
than two 1-D passes).
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.utils.backend import resolve_device

# max |displacement| the separable warp samples per axis
WARP_RANGE = 32
WARP_IMPLS = ("auto", "gather", "shift")


def warp_separable(curr: torch.Tensor, flow: torch.Tensor, R: int = WARP_RANGE) -> torch.Tensor:
    """Bilinear backward warp of ``curr`` by ``flow`` (H, W, 2) as a vertical
    then a horizontal 1-D pass (:func:`core.image.warp_axis_shift`, two
    #7 launches a pass). Exactly bilinear where the vertical component is
    locally constant along x; displacements clamp to ±R per axis."""
    tmp = im.warp_axis_shift(curr.T.contiguous(), flow[..., 1].T.contiguous(), R).T
    return im.warp_axis_shift(tmp.contiguous(), flow[..., 0].contiguous(), R)


def _resolve_warp(warp_impl: str) -> str:
    if warp_impl == "shift_interpret":
        raise NotImplementedError(
            "warp_impl='shift_interpret' has no counterpart: the CUDA kernels have no "
            "interpreter; 'shift' on CPU tensors runs the kernel's plain version")
    if warp_impl not in WARP_IMPLS:
        raise ValueError(f"warp_impl must be one of {WARP_IMPLS}, got {warp_impl!r}")
    return "gather" if warp_impl == "auto" else warp_impl


def _lk_refine(prev, curr, flow, win: int, iters: int, eps: float = 1e-3,
               warp_impl: str = "gather"):
    """Iterative LK update at one pyramid level. flow: (H, W, 2)."""
    H, W = prev.shape
    gy, gx = torch.gradient(prev)
    ys = torch.arange(H, dtype=torch.float32, device=prev.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=prev.device)[None, :]

    # the windowed structure tensor depends only on prev's gradients
    a = im.box_filter(gx * gx, win) + eps
    b = im.box_filter(gx * gy, win)
    c = im.box_filter(gy * gy, win) + eps
    det = a * c - b * b

    for _ in range(iters):
        if warp_impl == "gather":
            warped = im._bilinear_gather(curr, xs + flow[..., 0], ys + flow[..., 1])
        else:
            warped = warp_separable(curr, flow)
        it = warped - prev
        bx = im.box_filter(gx * it, win)
        by = im.box_filter(gy * it, win)
        # the update clamped for stability (LK's small-motion assumption)
        du = (-(c * bx - b * by) / det).clamp(-win, win)
        dv = (-(a * by - b * bx) / det).clamp(-win, win)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def dense_flow(prev, curr, levels: int = 3, win: int = 15, iters: int = 3,
               warp_impl: str = "auto", device="cuda") -> torch.Tensor:
    """(H, W) grayscale pair → (H, W, 2) flow with curr[p + flow(p)] ≈ prev[p]
    (Farneback's convention: prev + flow = curr), on ``device``."""
    warp_impl = _resolve_warp(warp_impl)
    dev = resolve_device(device)
    prev, curr = torch.as_tensor(prev, dtype=torch.float32, device=dev), torch.as_tensor(curr, dtype=torch.float32, device=dev)
    pyr = [(prev, curr)]
    for _ in range(levels - 1):
        p, c = pyr[-1]
        h2, w2 = p.shape[0] // 2, p.shape[1] // 2
        pyr.append((im.resize(im.gaussian_blur(p, 5), (h2, w2)),
                    im.resize(im.gaussian_blur(c, 5), (h2, w2))))
    flow = torch.zeros((*pyr[-1][0].shape, 2), dtype=torch.float32, device=dev)
    for lvl in range(levels - 1, -1, -1):
        p, c = pyr[lvl]
        if tuple(flow.shape[:2]) != tuple(p.shape):
            flow = torch.stack([im.resize(flow[..., 0], tuple(p.shape)),
                                im.resize(flow[..., 1], tuple(p.shape))], dim=-1) * 2.0
        flow = _lk_refine(p, c, flow, win, iters, warp_impl=warp_impl)
    return flow
