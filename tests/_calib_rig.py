"""The calibration tests' synthetic rig: ``tests/test_apps.py``'s stereo
pairs of a 9x6 board (distortion-free cameras, cv2 warps, noise, blur)
from its seed, as JPEG captures or as the port's detections."""

import imageio.v2 as iio
import jax.numpy as jnp
import numpy as np

import test_apps as ref_apps
from stereovision_tpu.core import geometry as jgeom

K1 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
K2 = np.array([[305.0, 0, 158], [0, 304.0, 122], [0, 0, 1]])
T = np.array([-5.0, 0.02, 0.05])


def render_pairs(n_pairs):
    """(n_pairs [(left, right)] uint8 320x240, (K1, K2, R, T))."""
    rng = np.random.default_rng(8)
    R = np.asarray(jgeom.rodrigues(jnp.asarray([0.005, 0.02, -0.003])))
    r_rel = np.asarray(jgeom.inverse_rodrigues(jnp.asarray(R)))
    pairs = []
    while len(pairs) < n_pairs:
        rvec = rng.uniform(-0.2, 0.2, 3)
        tvec = np.array([rng.uniform(-2, 2) - 10, rng.uniform(-1.5, 1.5) - 6,
                         rng.uniform(28, 40)])
        li = ref_apps.render_board_view(K1, rvec, tvec, rng)
        rr, tr = jgeom.se3_compose(jnp.asarray(rvec), jnp.asarray(tvec), jnp.asarray(r_rel),
                                   jnp.asarray(T))
        ri = ref_apps.render_board_view(K2, np.asarray(rr), np.asarray(tr), rng)
        if li is not None and ri is not None:
            pairs.append((li, ri))
    return pairs, (K1, K2, R, T)


def write_captures(root, n_pairs=10):
    """``n_pairs`` left_/right_ JPEG pairs under ``root``; returns (root,
    (K1, K2, R, T))."""
    pairs, truth = render_pairs(n_pairs)
    for n, (li, ri) in enumerate(pairs):
        iio.imwrite(root / f"left_{n:03d}.jpg", li)
        iio.imwrite(root / f"right_{n:03d}.jpg", ri)
    return root, truth


def detected_rig(n_pairs=12):
    """The pairs detected by the port: (obj (54, 3), corners left (V, 54,
    2), right, (K1, K2, R, T), the pairs)."""
    from stereovision_tpu_torch.calib import detect_chessboard

    pairs, truth = render_pairs(n_pairs)
    found = [detect_chessboard(img, ref_apps.BOARD, device="cpu") for p in pairs for img in p]
    assert all(f for f, _ in found)
    corners = np.asarray([c for _, c in found]).reshape(n_pairs, 2, 54, 2)
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() * ref_apps.SQ, ys.ravel() * ref_apps.SQ, np.zeros(54)], -1)
    return obj, corners[:, 0], corners[:, 1], truth, pairs
