"""Device resolution.

Every public entry point of the port takes ``device="cuda"`` by default and
resolves it here. A CUDA device that is not present raises: nothing carries
on silently on the CPU. Tests and CPU-only callers pass ``device="cpu"``,
which runs the plain PyTorch version of every kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` → ``torch.device``; raises when it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def upload(x, device: torch.device) -> torch.Tensor:
    """A host frame (array or CPU tensor, any dtype) → a tensor on
    ``device`` without a host wait: copied through pinned memory,
    asynchronously, where ``device`` is a card; a tensor already on
    ``device`` passes through."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
