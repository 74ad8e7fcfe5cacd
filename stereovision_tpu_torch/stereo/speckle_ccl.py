"""Exact cv2.filterSpeckles on the tensor's device: connected-component
labelling by min-label propagation.

Counterpart of ``stereovision_tpu/stereo/speckle_ccl.py``, with the same
semantics as the native flood fill (``native/speckle.cpp``, bound by
``ops.native``):

1. 4-connected components under |d[p] − d[q]| ≤ max_diff, on the original
   disparity values;
2. components of at most ``max_speckle_size`` pixels are set to ``new_val``.

Labelling propagates the smallest linear index of each component to a
fixed point: a round takes the minimum over every run of connected pixels
along the rows, then along the columns, and rounds repeat until one
changes nothing. A run's minimum is exact however it is reduced, so each
round gives the reference's labels; the loop tests for the fixed point on
the host, one sync a round. Real disparity maps settle in a handful of
rounds; a spiral takes O(its length).

Labels are float32 linear indices, exact below 2^24 pixels (a 720p frame
has 921,600).
"""

from __future__ import annotations

import torch

__all__ = ["label_components", "label_components_counted", "component_sizes",
           "filter_speckles_exact"]

_MAX_PIXELS = 1 << 24


def _run_min(lab: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """The minimum of every run along the last axis, given to each of its
    elements; ``conn[..., i]`` is the edge between elements i − 1 and i
    (False at i = 0, so each line starts a run)."""
    H, W = lab.shape
    run = torch.cumsum(~conn, dim=1, dtype=torch.int64)  # 1 at the first run of a line
    run = run + torch.arange(H, device=lab.device)[:, None] * W
    mins = torch.full((H * W + 1,), float("inf"), dtype=lab.dtype, device=lab.device)
    mins.scatter_reduce_(0, run.ravel(), lab.ravel(), "amin")
    return mins[run]


def _edges(disp: torch.Tensor, max_diff) -> tuple:
    md = torch.as_tensor(max_diff, dtype=disp.dtype, device=disp.device)
    H, W = disp.shape
    ch = torch.zeros((H, W), dtype=torch.bool, device=disp.device)
    cv = torch.zeros((H, W), dtype=torch.bool, device=disp.device)
    ch[:, 1:] = (disp[:, 1:] - disp[:, :-1]).abs() <= md
    cv[1:, :] = (disp[1:, :] - disp[:-1, :]).abs() <= md
    return ch, cv.T.contiguous()


def label_components_counted(disp: torch.Tensor, max_diff):
    """:func:`label_components` and the number of rounds it took (the last
    round is the one that changed nothing)."""
    H, W = disp.shape
    if H * W > _MAX_PIXELS:
        raise ValueError(f"{H}x{W} pixels: float32 labels are exact up to 2^24 pixels")
    ch, cv_t = _edges(disp, max_diff)
    lab = torch.arange(H * W, dtype=torch.float32, device=disp.device).reshape(H, W)

    def round_(lab):
        lab = _run_min(lab, ch)
        return _run_min(lab.T.contiguous(), cv_t).T.contiguous()

    lab = round_(lab)
    rounds = 1
    while True:
        nxt = round_(lab)
        rounds += 1
        if not bool(torch.any(nxt != lab)):
            return nxt, rounds
        lab = nxt


def label_components(disp: torch.Tensor, max_diff) -> torch.Tensor:
    """(H, W) float32 → (H, W) float32 canonical labels: every pixel
    carries the smallest linear index of its 4-connected |Δd| ≤ max_diff
    component (the partition the native flood fill computes)."""
    return label_components_counted(disp, max_diff)[0]


def component_sizes(lab: torch.Tensor) -> torch.Tensor:
    """(H, W) canonical labels → (H, W) int32 pixel count of each pixel's
    component."""
    idx = lab.to(torch.int64).ravel()
    counts = torch.bincount(idx, minlength=lab.numel())
    return counts[idx].to(torch.int32).reshape(lab.shape)


def filter_speckles_exact(disp, new_val, max_speckle_size: int, max_diff):
    """Bit-exact equivalent of the native ``filter_speckles`` /
    cv2.filterSpeckles on ``disp``'s device: components of at most
    ``max_speckle_size`` pixels become ``new_val``. Returns (disp, removed
    count as an int32 scalar tensor)."""
    disp = torch.as_tensor(disp).to(torch.float32)
    sizes = component_sizes(label_components(disp, max_diff))
    kill = sizes <= max_speckle_size
    out = torch.where(kill, torch.as_tensor(new_val, dtype=torch.float32, device=disp.device),
                      disp)
    return out, kill.sum(dtype=torch.int32)
