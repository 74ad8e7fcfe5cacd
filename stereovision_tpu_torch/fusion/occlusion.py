"""Camera-occlusion detection, the fused engine's sensor-fault guard.

Counterpart of ``stereovision_tpu/fusion/occlusion.py``: five image-quality
metrics per camera, additive penalty scores, the none/left/right/both
decision with the 0.6× asymmetry guard, and the 5-frame hysteresis, both
as host logic (:class:`OcclusionHysteresis`) and as int32 tensors
(:func:`hysteresis_update`, the on-device form that
``FusedPipeline.stream`` carries).
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.utils.backend import resolve_device

# the reference detector's absolute thresholds
STD_THRESHOLD = 28.0
LOW_VAR_THRESHOLD = 0.55
CONTRAST_RATIO = 2.2
ENTROPY_RATIO = 1.6
BRIGHTNESS_DIFF = 45.0


def _metrics(gray):
    bs = im.block_std(gray, 48)
    avg_std = bs.mean()
    low_var_ratio = (bs < 12.0).to(torch.float32).mean()
    contrast = gray.std(correction=0)  # the population std, as jnp.std
    # every bin gets 1e-10 before normalizing, as in the reference
    hist = im.histogram256(gray) + 1e-10
    p = hist / hist.sum()
    entropy = -(p * torch.log2(p + 1e-10)).sum()
    brightness = gray.mean()
    return avg_std, low_var_ratio, contrast, entropy, brightness


def occlusion_scores(left_gray, right_gray, device="cuda"):
    """(H, W) grayscale pair → (left_score, right_score), float32 scalars on
    ``device``."""
    dev = resolve_device(device)
    l_std, l_lvr, l_con, l_ent, l_bri = _metrics(torch.as_tensor(left_gray, dtype=torch.float32, device=dev))
    r_std, r_lvr, r_con, r_ent, r_bri = _metrics(torch.as_tensor(right_gray, dtype=torch.float32, device=dev))

    def score(std, lvr, con, ent, bri, o_con, o_ent, o_bri):
        s = torch.where(std < STD_THRESHOLD * 0.8, 0.35, 0.0)
        s = s + torch.where(lvr > LOW_VAR_THRESHOLD, 0.35, 0.0)
        s = s + torch.where((con < o_con / CONTRAST_RATIO) & (o_con > 15.0), 0.25, 0.0)
        s = s + torch.where((ent < o_ent / ENTROPY_RATIO) & (o_ent > 5.0), 0.25, 0.0)
        s = s + torch.where(((bri - o_bri).abs() > BRIGHTNESS_DIFF) & (bri < 80.0), 0.2, 0.0)
        return s

    left = score(l_std, l_lvr, l_con, l_ent, l_bri, r_con, r_ent, r_bri)
    right = score(r_std, r_lvr, r_con, r_ent, r_bri, l_con, l_ent, l_bri)
    return left, right


# state codes of the tensor decision and hysteresis, and their host strings:
# 0 none, 1 left, 2 right, 3 both
OCCLUSION_CODES = ("none", "left", "right", "both")


def classify_occlusion_code(left_score, right_score, threshold: float = 0.45,
                            device="cuda") -> torch.Tensor:
    """Tensor form of :func:`classify_occlusion` → an int32 state code."""
    dev = resolve_device(device)
    ls, rs = torch.as_tensor(left_score, dtype=torch.float32, device=dev), torch.as_tensor(right_score, dtype=torch.float32, device=dev)
    # the threshold and its 0.6 share in float32 arithmetic, as the reference
    t = np.float32(threshold)
    t6 = float(t * np.float32(0.6))
    t = float(t)
    left = (ls > t) & (rs < t6)
    right = (rs > t) & (ls < t6)
    both = (ls > t) & (rs > t)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    code = torch.where(both, zero + 3, zero)
    code = torch.where(right, zero + 2, code)
    return torch.where(left, zero + 1, code)


def hysteresis_init(state_code: int = 0, device="cuda"):
    """The (state, pending, count) int32 carry of :func:`hysteresis_update`."""
    dev = resolve_device(device)
    # filled on the device: no host-to-device copy
    return tuple(torch.full((), v, dtype=torch.int32, device=dev)
                 for v in (state_code, state_code, 0))


def hysteresis_update(carry, detected, confirm_frames: int = 5):
    """One step of :meth:`OcclusionHysteresis.update` on int32 tensors: the
    same state machine over codes, with no host round trip."""
    state, pending, count = carry
    same = detected == state
    matches_pending = detected == pending
    new_pending = torch.where(same, state, torch.where(matches_pending, pending, detected))
    new_count = torch.where(same, torch.zeros_like(count),
                            torch.where(matches_pending, count + 1, torch.ones_like(count)))
    flip = new_count >= confirm_frames
    new_state = torch.where(same, state, torch.where(flip, new_pending, state))
    new_count = torch.where(flip, torch.zeros_like(new_count), new_count)
    return (new_state.to(torch.int32), new_pending.to(torch.int32), new_count.to(torch.int32))


def classify_occlusion(left_score: float, right_score: float, threshold: float = 0.45) -> str:
    """'none' / 'left' / 'right' / 'both' from host scores."""
    if left_score > threshold and right_score < threshold * 0.6:
        return "left"
    if right_score > threshold and left_score < threshold * 0.6:
        return "right"
    if left_score > threshold and right_score > threshold:
        return "both"
    return "none"


class OcclusionHysteresis:
    """Five consecutive frames of confirmation before the occlusion state
    flips: the automatic stereo-off/on guard."""

    def __init__(self, confirm_frames: int = 5):
        self.confirm_frames = confirm_frames
        self.state = "none"
        self._pending = "none"
        self._count = 0

    def update(self, detected: str) -> str:
        if detected == self.state:
            self._pending, self._count = self.state, 0
            return self.state
        if detected == self._pending:
            self._count += 1
        else:
            self._pending, self._count = detected, 1
        if self._count >= self.confirm_frames:
            self.state = self._pending
            self._count = 0
        return self.state

    @property
    def stereo_enabled(self) -> bool:
        return self.state == "none"
