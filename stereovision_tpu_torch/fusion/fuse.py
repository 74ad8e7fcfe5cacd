"""Confidence-weighted depth fusion.

Counterpart of ``stereovision_tpu/fusion/fuse.py``: the stereo-base,
MiDaS-base and flow-base scenarios, the masked blends applied everywhere
(blending with an empty mask is the identity), and the final bilateral
smooth. Which methods take part is the caller's (Python) choice; whether
the camera moves is a tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Live-tunable fusion knobs (the original tool's fusion weights,
    thresholds and smoothing)."""

    stereo_weight: float = 0.8
    midas_fill_weight: float = 0.9
    flow_fill_weight: float = 0.5
    stereo_conf_threshold: float = 0.5
    flow_hole_threshold: float = 15.0
    midas_blend_radius: int = 15
    bilateral_d: int = 9
    bilateral_sigma: float = 75.0
    use_midas_fill: bool = True
    use_flow_fill: bool = True


def fuse_depth_maps(stereo_depth, stereo_conf, midas_calibrated, midas_conf, flow_normalized,
                    camera_moving, params: FusionParams = FusionParams(),
                    have_stereo: bool = True, have_midas: bool = True, have_flow: bool = True,
                    device="cuda"):
    """Returns (fused [0, 255] float32, fused_conf [0, 1], mode_code int32).

    Mode codes: 0 none, 1 stereo-base, 2 midas-base, 3 flow-base
    (:func:`mode_text` turns a code into the display string). Flow takes
    part only while ``camera_moving`` (a bool tensor) holds."""
    p = params
    if not (have_stereo or have_midas or have_flow):
        raise ValueError("fusion needs at least one method")
    dev = resolve_device(device)

    def f32(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)

    stereo_depth, stereo_conf, midas_calibrated, midas_conf, flow_normalized = (
        f32(x) for x in (stereo_depth, stereo_conf, midas_calibrated, midas_conf,
                         flow_normalized))
    shape = (stereo_depth.shape if have_stereo
             else (midas_calibrated.shape if have_midas else flow_normalized.shape))
    flow_ok = (torch.as_tensor(camera_moving, dtype=torch.bool, device=dev) if have_flow
               else torch.zeros((), dtype=torch.bool, device=dev))

    def flow_fill(fused, conf, floor):
        holes = ((fused < p.flow_hole_threshold) | (fused == 0)) & flow_ok
        fw = p.flow_fill_weight
        fused = torch.where(holes, fused * (1 - fw) + flow_normalized * fw, fused)
        return fused, torch.where(holes, conf.clamp(min=floor), conf)

    if have_stereo:
        fused = stereo_depth * p.stereo_weight
        conf = stereo_conf if stereo_conf is not None else torch.ones(shape, device=dev)
        mode = torch.full((), 1, dtype=torch.int32, device=dev)
        if have_midas and p.use_midas_fill:
            low_conf = conf < p.stereo_conf_threshold
            fill_w = (1.0 - conf) * p.midas_fill_weight
            fill_w = im.gaussian_blur(fill_w, p.midas_blend_radius).clamp(0.0, 1.0)
            mask = low_conf & (fill_w > 0.1)
            fused = torch.where(mask, fused * (1 - fill_w) + midas_calibrated * fill_w, fused)
            conf = torch.where(mask, conf.clamp(min=0.8), conf)
        if have_flow and p.use_flow_fill:
            fused, conf = flow_fill(fused, conf, 0.6)
    elif have_midas:
        fused = midas_calibrated
        conf = midas_conf if midas_conf is not None else torch.full(shape, 0.8, device=dev)
        mode = torch.full((), 2, dtype=torch.int32, device=dev)
        if have_flow and p.use_flow_fill:
            fused, conf = flow_fill(fused, conf, 0.7)
    else:
        fused = torch.where(flow_ok, flow_normalized, 0.0)
        conf = torch.full(shape, 0.7, device=dev)
        mode = torch.where(flow_ok, 3, 0).to(torch.int32)

    # the final edge-preserving smooth where the map carries real signal
    smoothed = im.bilateral_filter(fused, p.bilateral_d, p.bilateral_sigma, p.bilateral_sigma)
    fused = torch.where(fused.max() > 10.0, smoothed, fused)
    return fused.clamp(0.0, 255.0), conf, mode


def mode_text(mode_code: int, params: FusionParams, midas_filled=True, flow_filled=True) -> str:
    """The display string of a mode code."""
    if mode_code == 1:
        parts = [f"Stereo×{params.stereo_weight:.1f}"]
        if midas_filled and params.use_midas_fill:
            parts.append(f"MiDaS_fill×{params.midas_fill_weight:.1f}")
        if flow_filled and params.use_flow_fill:
            parts.append(f"Flow_fill×{params.flow_fill_weight:.1f}")
        return " + ".join(parts)
    if mode_code == 2:
        return "MiDaS_base"
    if mode_code == 3:
        return "Flow_base"
    return "NO DATA"
