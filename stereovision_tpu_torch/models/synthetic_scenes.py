"""Procedural (image, inverse-depth) scene generator for offline pretraining.

The port's own copy of ``stereovision_tpu/models/synthetic_scenes.py``
(numpy only): for the same ``np.random.Generator`` state it returns the same
arrays bit for bit.

The reference downloads MiDaS weights from torch-hub at runtime
(fused_depth_map.py:1091-1098); this deployment is offline, so the bundled
weights are trained here on procedurally generated layered scenes. The
generator provides real monocular cues: texture density scales with depth
(perspective foreshortening), objects occlude what is behind them, and
brightness/contrast are randomized independently of depth so the network
cannot shortcut on intensity.
"""

from __future__ import annotations

import numpy as np


def make_scene(rng: np.random.Generator, size: int = 128):
    """Returns (image (S, S, 3) float32 0..255, inv_depth (S, S) float32)."""
    S = size
    depth = np.empty((S, S), np.float32)
    img = np.empty((S, S, 3), np.float32)

    def textured(region_hw, d):
        """Texture whose spatial frequency scales with depth (farther = finer)."""
        h, w = region_hw
        # base texture tile at a resolution ∝ 1/d — then upsampled
        scale = float(np.clip(8.0 / d, 0.15, 4.0))
        th = max(2, int(h * scale))
        tw = max(2, int(w * scale))
        base = rng.uniform(0, 1, (th, tw))
        ys = (np.arange(h) * th / h).astype(int)
        xs = (np.arange(w) * tw / w).astype(int)
        tex = base[np.ix_(ys, xs)]
        lo, hi = sorted(rng.uniform(0, 255, 2))
        if hi - lo < 40:
            hi = lo + 40
        rgb = lo + tex[..., None] * (hi - lo)
        tint = rng.uniform(0.6, 1.0, 3)
        return (rgb * tint).astype(np.float32)

    scene_type = rng.choice(
        ["layered", "ground", "layered", "ground", "slabs"]
    )
    bg_d = rng.uniform(8.0, 24.0)
    if scene_type == "ground":
        # perspective ground plane: near at the bottom, receding to a far
        # horizon band — the dominant monocular cue in real imagery. Objects
        # STAND on the plane: their depth equals the plane's at their base
        # row (the size-from-position cue the layered scenes cannot teach).
        horizon = rng.uniform(0.15, 0.45)
        yy = np.arange(S, dtype=np.float32)[:, None]
        t = np.clip((yy / S - horizon) / (1 - horizon), 1e-3, 1.0)
        near_d = rng.uniform(1.5, 4.0)
        plane = near_d / t  # ∝ 1/(rows below horizon): perspective falloff
        depth[:] = np.minimum(np.broadcast_to(plane, (S, S)), bg_d)
        img[:] = textured((S, S), float(np.median(depth)))
        # texture density varies with the local depth: re-texture in bands
        for b in range(4):
            r0, r1 = b * S // 4, (b + 1) * S // 4
            img[r0:r1] = textured((r1 - r0, S), float(np.median(depth[r0:r1])))
        n_obj = rng.integers(2, 6)
        for _ in range(n_obj):
            base_y = rng.integers(int(S * horizon) + 4, S - 4)
            d = float(depth[base_y, 0])
            ext = int(np.clip(S * rng.uniform(0.5, 1.2) / d, 6, S * 0.5))
            h = ext
            w = int(ext * rng.uniform(0.5, 1.4))
            y0 = max(0, base_y - h)
            x0 = rng.integers(0, max(1, S - w))
            patch = textured((base_y - y0, min(w, S - x0)), d)
            img[y0:base_y, x0 : x0 + patch.shape[1]] = patch
            depth[y0:base_y, x0 : x0 + patch.shape[1]] = d
    else:
        depth[:] = bg_d
        img[:] = textured((S, S), bg_d)
        # layered objects, far → near (painter's algorithm)
        n_obj = rng.integers(3, 9)
        ds = np.sort(rng.uniform(1.5, bg_d * 0.9, n_obj))[::-1]
        for d in ds:
            # nearer objects are bigger on average (weak size cue)
            ext = int(np.clip(rng.uniform(0.15, 0.5) * S * (3.0 / d) ** 0.3, 8, S * 0.7))
            y0 = rng.integers(0, S - ext)
            x0 = rng.integers(0, S - ext)
            h = ext
            w = int(ext * rng.uniform(0.6, 1.6))
            w = min(w, S - x0)
            patch = textured((h, w), d)
            if rng.uniform() < 0.4:
                # elliptical mask
                yy, xx = np.mgrid[0:h, 0:w]
                mask = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2 <= 1
            else:
                mask = np.ones((h, w), bool)
            region = np.s_[y0 : y0 + h, x0 : x0 + w]
            if scene_type == "slabs":
                # slanted surface: depth varies linearly across the patch
                gy, gx = rng.uniform(-0.4, 0.4, 2) * d
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                dd = np.clip(d + gy * (yy / h - 0.5) + gx * (xx / w - 0.5),
                             1.0, bg_d)
            else:
                dd = np.full((h, w), d, np.float32)
            img[region][mask] = patch[mask]
            depth[region][mask] = dd[mask]

    # global photometric jitter independent of depth, plus an optional
    # lighting gradient / vignette so intensity cannot proxy for depth
    gain = rng.uniform(0.6, 1.3)
    bias = rng.uniform(-20, 30)
    img = np.clip(img * gain + bias, 0, 255)
    if rng.uniform() < 0.5:
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        grad = (np.cos(ang) * xx + np.sin(ang) * yy) / S
        img = np.clip(img * (1.0 + rng.uniform(-0.35, 0.35) * grad)[..., None], 0, 255)
    noise = rng.normal(0, rng.uniform(0.5, 3.0), img.shape)
    img = np.clip(img + noise, 0, 255).astype(np.float32)
    return img, (1.0 / depth).astype(np.float32)


def batch(rng: np.random.Generator, n: int, size: int = 128):
    imgs = np.empty((n, size, size, 3), np.float32)
    invd = np.empty((n, size, size), np.float32)
    for i in range(n):
        imgs[i], invd[i] = make_scene(rng, size)
    return imgs, invd
