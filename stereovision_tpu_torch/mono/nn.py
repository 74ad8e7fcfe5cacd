"""Neural mono-depth: the MiDaS-class estimator.

Counterpart of ``stereovision_tpu/mono/nn.py``. The pre- and post-processing
contract: BGR frame → RGB in [0, 1], linearly resized to the network's size;
forward; resized back to the frame's size; min-max normalized to [0, 255];
confidence = the normalized |gray − GaussianBlur(gray, 5)| local contrast.
"""

from __future__ import annotations

from pathlib import Path

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.models.midas import MidasSmall
from stereovision_tpu_torch.utils.backend import resolve_device

# the bundled synthetic-pretrained weights, a flax checkpoint in the JAX
# package's data, read by path
PRETRAINED = (Path(__file__).resolve().parents[2] / "stereovision_tpu" / "models"
              / "pretrained" / "midas_synthetic.msgpack")


def create_model(arch: str = "small", pretrained: bool = True, device="cuda",
                 seed: int = 0) -> MidasSmall:
    """The mono-depth network on ``device``, in eval mode.

    ``arch="small"``: ``MidasSmall`` with the bundled synthetic-pretrained
    weights (``PRETRAINED``, carried across by
    ``convert.midas_small_from_flax``); a missing file raises. With
    ``pretrained=False``, PyTorch's default initialization from ``seed``.
    The exact MiDaS v2.1 small and DPT-Large architectures are not ported
    yet (ROADMAP.md queue 1 item 10)."""
    if arch in ("midas_v21_small", "dpt_large"):
        raise NotImplementedError(
            f"arch '{arch}' is not ported yet (ROADMAP.md queue 1 item 10)")
    if arch != "small":
        raise ValueError(f"unknown mono-depth arch '{arch}'")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MidasSmall()
    if pretrained:
        from stereovision_tpu_torch.convert import midas_small_from_flax
        from stereovision_tpu_torch.models.checkpoint import load_variables

        model.load_state_dict(midas_small_from_flax(load_variables(PRETRAINED)))
    return model.to(dev).eval()


def estimate_depth(model: torch.nn.Module, frame_bgr, net_hw=(256, 256), device="cuda"):
    """(H, W, 3) BGR frame (uint8 or float, 0-255) → (depth_norm [0, 255]
    (H, W), conf [0, 1] (H, W)) on ``device``, where ``model`` must be."""
    dev = resolve_device(device)
    frame = torch.as_tensor(frame_bgr, dtype=torch.float32, device=dev)
    H, W = frame.shape[0], frame.shape[1]
    rgb = frame.flip(-1) / 255.0
    small = im.resize(rgb, tuple(net_hw))
    with torch.no_grad():
        pred = model(small[None])[0]
    depth = im.resize(pred, (H, W))
    depth_norm = im.minmax_normalize(depth, 0.0, 255.0)
    gray = im.grayscale_bgr(frame)
    conf = im.minmax_normalize((gray - im.gaussian_blur(gray, 5)).abs(), 0.0, 1.0)
    return depth_norm, conf
