"""Neural mono-depth: the MiDaS-class estimator.

Counterpart of ``stereovision_tpu/mono/nn.py``. The pre- and post-processing
contract: BGR frame → RGB in [0, 1], linearly resized to the network's size;
forward; resized back to the frame's size; min-max normalized to [0, 255];
confidence = the normalized |gray − GaussianBlur(gray, 5)| local contrast.
"""

from __future__ import annotations

import contextlib
import functools
from pathlib import Path

import numpy as np
import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.models.midas import MidasSmall
from stereovision_tpu_torch.utils.backend import resolve_device
from stereovision_tpu_torch.utils.profiling import annotate

# the bundled synthetic-pretrained weights, a flax checkpoint in the JAX
# package's data, read by path
PRETRAINED = (Path(__file__).resolve().parents[2] / "stereovision_tpu" / "models"
              / "pretrained" / "midas_synthetic.msgpack")


def _read_state_dict(source):
    """A state_dict mapping, or the path of a ``.pt`` file holding one
    (directly or under ``"state_dict"``)."""
    if isinstance(source, (str, Path)):
        raw = torch.load(source, map_location="cpu", weights_only=True)
        return raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return source


def create_model(arch: str = "small", pretrained: bool = True, device="cuda", seed: int = 0,
                 net_hw=(256, 256), torch_state_dict=None, dpt_cfg=None) -> torch.nn.Module:
    """The mono-depth network on ``device``, in eval mode; it takes (B, H,
    W, 3) RGB in [0, 1] at ``net_hw`` and returns (B, H, W).

    - ``arch="small"``: ``MidasSmall`` with the bundled synthetic-pretrained
      weights (``PRETRAINED``, carried across by
      ``convert.midas_small_from_flax``; a missing file raises), or with
      ``pretrained=False`` PyTorch's default initialization from ``seed``.
    - ``arch="midas_v21_small"``: the exact MiDaS v2.1 small
      (``models.midas_v21``); ``arch="dpt_large"``: the exact DPT-Large
      (``models.dpt``; ``dpt_cfg`` replaces ``DPT_LARGE``). Their weights
      come from ``torch_state_dict``, a hub-format state_dict (a mapping of
      tensors or numpy arrays, or a ``.pt`` path), checked against the
      architecture's manifest and loaded by name; without one, from a
      seeded initialization (``models.midas_v21.seeded``; ``pretrained``
      does not apply: no hub weights are bundled). Either way the module is
      built on the CPU (for DPT-Large 344M parameters, a few seconds), then
      moved to ``device``; a checkpoint is validated before the build, and
      a ``net_hw`` the architecture cannot take raises.

    The global random generator is left as it was. A ``torch_state_dict``
    given for ``"small"`` raises."""
    dev = resolve_device(device)
    if arch == "small":
        if torch_state_dict is not None:
            raise ValueError("torch_state_dict loads the hub architectures "
                             "'midas_v21_small' and 'dpt_large', not 'small'")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MidasSmall()
        if pretrained:
            from stereovision_tpu_torch.convert import midas_small_from_flax
            from stereovision_tpu_torch.models.checkpoint import load_variables

            model.load_state_dict(midas_small_from_flax(load_variables(PRETRAINED)))
    elif arch in ("midas_v21_small", "dpt_large"):
        from stereovision_tpu_torch.models import dpt, midas_v21

        if arch == "midas_v21_small":
            make, multiple = midas_v21.create_v21, 32
            validate = midas_v21.validate_state_dict
        else:
            cfg = dpt.DPT_LARGE if dpt_cfg is None else dpt_cfg
            make, multiple = functools.partial(dpt.create_dpt, cfg=cfg), 2 * cfg.patch_size
            validate = functools.partial(dpt.validate_state_dict, cfg=cfg)
        if net_hw[0] % multiple or net_hw[1] % multiple:
            raise ValueError(f"{arch} takes a net_hw of multiples of {multiple}, "
                             f"got {tuple(net_hw)}")
        state_dict = None
        if torch_state_dict is not None:
            state_dict = _read_state_dict(torch_state_dict)
            validate(state_dict)  # before the seconds a DPT-Large build takes
        model = make(seed)
        if state_dict is not None:
            midas_v21.load_hub_state_dict(model, state_dict)
    else:
        raise ValueError(f"unknown mono-depth arch '{arch}'")
    return model.to(dev).eval()


def estimate_depth(model: torch.nn.Module, frame_bgr, net_hw=(256, 256), device="cuda"):
    """(H, W, 3) BGR frame (uint8 or float, 0-255) → (depth_norm [0, 255]
    (H, W), conf [0, 1] (H, W)) on ``device``, where ``model`` must be.
    ``net_hw`` is the network's input size; it need not be square.

    Spans (``utils.profiling.annotate``): ``mono.upload`` (a host frame
    copied up in its own dtype, a blocking ``sync.upload``), ``mono.resize``
    (to RGB in [0, 1] at ``net_hw``), ``mono.net`` (the forward) and
    ``mono.post`` (the resize back, the normalisation and the
    confidence)."""
    dev = resolve_device(device)
    with annotate("mono.upload"):
        if isinstance(frame_bgr, np.ndarray):  # a reversed view (img[..., ::-1]) has negative strides
            frame_bgr = np.ascontiguousarray(frame_bgr)
        from_host = dev.type == "cuda" and not (torch.is_tensor(frame_bgr) and frame_bgr.is_cuda)
        with annotate("sync.upload") if from_host else contextlib.nullcontext():
            frame = torch.as_tensor(frame_bgr, device=dev)
        frame = frame.to(torch.float32)
    H, W = frame.shape[0], frame.shape[1]
    with annotate("mono.resize"):
        small = im.resize(frame.flip(-1) / 255.0, tuple(net_hw))
    with annotate("mono.net"), torch.no_grad():
        pred = model(small[None])[0]
    with annotate("mono.post"):
        depth_norm = im.minmax_normalize(im.resize(pred, (H, W)), 0.0, 255.0)
        gray = im.grayscale_bgr(frame)
        conf = im.minmax_normalize((gray - im.gaussian_blur(gray, 5)).abs(), 0.0, 1.0)
    return depth_norm, conf
