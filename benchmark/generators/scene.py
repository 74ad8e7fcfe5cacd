"""The generator ``scene``: a traffic mix's scene as a ring of uint8 frame
pairs at a configuration's rig size, drawn from the run's seed.

A generator module is named by a mix's ``generator`` and found as
``generators/<name>.py``; its ``inputs(config, traffic, seed, device)``
returns the ring of host inputs that the window cycles through, each a
tuple of the system's call arguments.

The scene is a textured background at one disparity and a separately
textured box at another, both as fractions of the search range, the box
placed at pixel coordinates given for ``at_size`` and scaled to the rig's
size; the texture is uniform noise under a ``texture_box`` mean filter,
stretched by ``contrast`` about mid-grey (a webcam's uint8 frame). The
camera pans ``pan_px_per_frame`` to the right each frame, over
``ring_frames`` distinct frames that the run then cycles through. Only the
texture comes from the seed: every seed gives the same sizes, disparities
and motion.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def layout(config: dict, traffic: dict) -> dict:
    """The scene's integer geometry at the rig's size."""
    s = traffic["scene"]
    W, H = config["rig"]["width"], config["rig"]["height"]
    D = config["pipeline"]["params"]["num_disparities"]
    aw, ah = s["at_size"]
    y0, x0, bh, bw = s["box"]
    return {
        "H": H, "W": W,
        "bg_disp": int(round(s["background_disparity"] * D)),
        "box_disp": int(round(s["box_disparity"] * D)),
        "box": (round(y0 * H / ah), round(x0 * W / aw), round(bh * H / ah), round(bw * W / aw)),
        "pan": int(s["pan_px_per_frame"]),
        "ring": int(s["ring_frames"]),
        "k": int(s["texture_box"]),
        "contrast": float(s["contrast"]),
    }


def _texture(g: torch.Generator, h: int, w: int, k: int, device) -> torch.Tensor:
    raw = torch.rand((1, 1, h + k - 1, w + k - 1), generator=g, device=device) * 255.0
    return F.avg_pool2d(raw, k, stride=1)[0, 0]


def inputs(config: dict, traffic: dict, seed: int, device) -> list[tuple[np.ndarray, np.ndarray]]:
    """The ring of (left, right) uint8 (H, W) host frames of ``seed``:
    drawn on ``device`` in two calls, copied to the host once."""
    L = layout(config, traffic)
    H, W, pan, n, k = L["H"], L["W"], L["pan"], L["ring"], L["k"]
    span = pan * (n - 1)                 # the pan's reach
    wide = W + span
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    base = _texture(g, H, wide + L["bg_disp"], k, device)
    left, right = base[:, :wide].clone(), base[:, L["bg_disp"]:L["bg_disp"] + wide].clone()
    y0, x0, bh, bw = L["box"]
    box = _texture(g, bh, bw, k, device)
    left[y0:y0 + bh, span + x0:span + x0 + bw] = box
    right[y0:y0 + bh, span + x0 - L["box_disp"]:span + x0 - L["box_disp"] + bw] = box
    c = L["contrast"]
    pair = torch.stack([left, right])
    pair = ((pair - 127.5) * c + 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    # frame j shows the scene panned j·pan px to the right
    return [(np.ascontiguousarray(pair[0][:, span - j * pan:span - j * pan + W]),
             np.ascontiguousarray(pair[1][:, span - j * pan:span - j * pan + W]))
            for j in range(n)]
