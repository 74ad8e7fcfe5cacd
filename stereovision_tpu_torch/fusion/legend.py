"""Metric depth of the fused map.

Counterpart of ``stereovision_tpu/fusion/legend.py``: the fused value maps
linearly onto the disparity range, and depth is f·B/d from the
calibration, with ``compat_scale`` to reproduce the original tool's
displayed numbers (it multiplies by 3.75).
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.utils.backend import resolve_device


def fused_to_meters(fused_u8, focal_px, baseline_cm, min_disparity: float = 0.0,
                    num_disparities: float = 128.0, compat_scale: float = 1.0, device="cuda"):
    """Fused value v ∈ [0, 255] → depth in meters: disparity = min_d +
    v/255·num_d, depth = f·B/disparity · ``compat_scale``, clamped to
    [0.05, 30] m."""
    dev = resolve_device(device)
    disp = min_disparity + torch.as_tensor(fused_u8, dtype=torch.float32, device=dev) / 255.0 * num_disparities
    depth = focal_px * (baseline_cm / 100.0) / (disp + 1e-6) * compat_scale
    return depth.clamp(0.05, 30.0)
