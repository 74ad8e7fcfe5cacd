"""Cross-method range calibration.

Counterpart of ``stereovision_tpu/fusion/calibrate.py``. Percentiles are
``torch.quantile`` / ``torch.nanquantile`` (linear, numpy's default) with a
vector of q, so each array is sorted once; the q vectors are made once per
device, since a q on the CPU is read back for its range check and one
copied from the host each call waits for the copy.
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.core.image import quantile_q as _q
from stereovision_tpu_torch.utils.backend import resolve_device


def _percentiles(vals, qs):
    return torch.quantile(vals.reshape(-1), _q(qs, vals.device))


def _masked_percentiles(vals, mask, qs):
    nan_vals = torch.where(mask, vals, torch.nan)
    return torch.nanquantile(nan_vals.reshape(-1), _q(qs, vals.device))


def calibrate_midas_to_stereo(midas_depth, stereo_disparity, stereo_confidence, device="cuda"):
    """Map MiDaS relative depth into the stereo disparity range.

    With ≥ 100 stereo anchors (conf > 0.7), a robust linear fit through the
    10/90 percentiles of the anchored sets; otherwise a 5/95 percentile
    min-max mapping of the full maps. Both are computed and one is taken
    by ``torch.where``: the anchor count never leaves the device."""
    dev = resolve_device(device)
    midas = torch.as_tensor(midas_depth, dtype=torch.float32, device=dev)
    stereo = torch.as_tensor(stereo_disparity, dtype=torch.float32, device=dev)
    reliable = torch.as_tensor(stereo_confidence, device=dev) > 0.7
    n_rel = reliable.sum()

    s10, s90 = _masked_percentiles(stereo, reliable, (10.0, 90.0))
    m10, m90 = _masked_percentiles(midas, reliable, (10.0, 90.0))
    scale = torch.where(m90 - m10 < 1e-6, 1.0, (s90 - s10) / (m90 - m10 + 1e-8))
    robust = midas * scale + (s10 - m10 * scale)

    m5, m95 = _percentiles(midas, (5.0, 95.0))
    s5, s95 = _percentiles(stereo, (5.0, 95.0))
    flat = ((s5 + s95) / 2.0).expand_as(midas)
    mapped = s5 + (midas - m5) / (m95 - m5 + 1e-8) * (s95 - s5)
    minmax = torch.where(m95 - m5 < 1e-6, flat, mapped)
    return torch.where(n_rel >= 100, robust, minmax)


def normalize_to_stereo_range(depth_map, stereo_disparity, invert: bool = True, device="cuda"):
    """Map a relative depth map into the stereo 5/95-percentile range;
    ``invert`` flips to the near=large convention first (the flow path's
    255 − x before fusing)."""
    dev = resolve_device(device)
    d = torch.as_tensor(depth_map, dtype=torch.float32, device=dev)
    lo, hi = _percentiles(d, (5.0, 95.0))
    norm = ((d - lo) / (hi - lo + 1e-8)).clamp(0.0, 1.0) * 255.0
    if invert:
        norm = 255.0 - norm
    s5, s95 = _percentiles(torch.as_tensor(stereo_disparity, dtype=torch.float32, device=dev), (5.0, 95.0))
    return s5 + norm / 255.0 * (s95 - s5)
