"""Host-side image annotation with PIL: text overlays, the status panel
and the colormap legend bar. Counterpart of
``stereovision_tpu/utils/annotate.py``; rendering text stays on the host.
"""

from __future__ import annotations

import numpy as np


def _font():
    from PIL import ImageFont

    try:
        return ImageFont.truetype("DejaVuSans.ttf", 14)
    except Exception:
        return ImageFont.load_default()


def draw_text(img: np.ndarray, lines, origin=(10, 10), color=(255, 255, 255)) -> np.ndarray:
    """Draw multi-line text onto an (H, W, 3) uint8 image; returns a copy."""
    from PIL import Image, ImageDraw

    if isinstance(lines, str):
        lines = [lines]
    pil = Image.fromarray(np.ascontiguousarray(img.astype(np.uint8)))
    d = ImageDraw.Draw(pil)
    font = _font()
    x, y = origin
    for line in lines:
        # a shadow for readability on busy colormaps
        d.text((x + 1, y + 1), line, fill=(0, 0, 0), font=font)
        d.text((x, y), line, fill=tuple(color), font=font)
        y += 18
    return np.asarray(pil)


def status_panel(entries: dict, width: int = 450, height: int = 280) -> np.ndarray:
    """The fusion parameter/occlusion panel as an image."""
    img = np.full((height, width, 3), 30, np.uint8)
    return draw_text(img, [f"{k}: {v}" for k, v in entries.items()], origin=(12, 12),
                     color=(200, 255, 200))


def depth_legend(height: int = 200, width: int = 60, cmap: str = "jet") -> np.ndarray:
    """Vertical colormap legend bar (its metric labels come from
    ``fusion.legend``)."""
    import torch

    from stereovision_tpu_torch.core import image as im

    ramp = np.linspace(255, 0, height, dtype=np.uint8)[:, None].repeat(width, 1)
    return im.apply_colormap(torch.from_numpy(ramp), cmap, bgr=False).numpy().astype(np.uint8)
