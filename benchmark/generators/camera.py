"""The generator ``camera``: a traffic mix's scene as one camera's ring of
uint8 BGR frames at a configuration's camera size, drawn from the run's
seed.

Each of the three channels is its own texture (uniform noise under a
``texture_box`` mean filter, stretched by ``contrast`` about mid-grey),
and a box with textures of its own sits in front, placed at pixel
coordinates given for ``at_size`` and scaled to the camera's size. The
camera pans ``pan_px_per_frame`` to the right each frame, over
``ring_frames`` distinct frames that the run then cycles through. Only the
textures come from the seed: every seed gives the same sizes and motion.
Each input is a one-tuple, the system's one call argument.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def layout(config: dict, traffic: dict) -> dict:
    """The scene's integer geometry at the camera's size."""
    s = traffic["scene"]
    W, H = config["camera"]["width"], config["camera"]["height"]
    aw, ah = s["at_size"]
    y0, x0, bh, bw = s["box"]
    return {
        "H": H, "W": W,
        "box": (round(y0 * H / ah), round(x0 * W / aw), round(bh * H / ah), round(bw * W / aw)),
        "pan": int(s["pan_px_per_frame"]),
        "ring": int(s["ring_frames"]),
        "k": int(s["texture_box"]),
        "contrast": float(s["contrast"]),
    }


def _texture(g: torch.Generator, h: int, w: int, k: int, device) -> torch.Tensor:
    """(3, h, w) textures, one a channel."""
    raw = torch.rand((3, 1, h + k - 1, w + k - 1), generator=g, device=device) * 255.0
    return F.avg_pool2d(raw, k, stride=1)[:, 0]


def inputs(config: dict, traffic: dict, seed: int, device) -> list[tuple[np.ndarray]]:
    """The ring of (frame,) uint8 (H, W, 3) BGR host frames of ``seed``:
    drawn on ``device`` in two calls, copied to the host once."""
    L = layout(config, traffic)
    H, W, pan, n, k = L["H"], L["W"], L["pan"], L["ring"], L["k"]
    span = pan * (n - 1)                 # the pan's reach
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    scene = _texture(g, H, W + span, k, device)
    y0, x0, bh, bw = L["box"]
    scene[:, y0:y0 + bh, span + x0:span + x0 + bw] = _texture(g, bh, bw, k, device)
    c = L["contrast"]
    scene = ((scene - 127.5) * c + 127.5).clamp(0, 255).to(torch.uint8)
    scene = scene.permute(1, 2, 0).contiguous().cpu().numpy()
    # frame j shows the scene panned j·pan px to the right
    return [(np.ascontiguousarray(scene[:, span - j * pan:span - j * pan + W]),)
            for j in range(n)]
