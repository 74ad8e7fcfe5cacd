"""What a depth configuration file states, read alike by the program's
side and by the plain reference: the rig's calibration and the engine's
settings. Neither is made by the program."""

from __future__ import annotations

import numpy as np


def calibration(config: dict) -> dict:
    """The rig's stereo calibration (the keys of the program's calibration
    store): identity rectification, focal length ``focal_px``, baseline
    ``tx_cm`` along x, no distortion."""
    rig = config["rig"]
    W, H, f, tx = rig["width"], rig["height"], float(rig["focal_px"]), float(rig["tx_cm"])
    K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]])
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = P1.copy()
    P2[0, 3] = tx * f
    Q = np.array([[1, 0, 0, -K[0, 2]], [0, 1, 0, -K[1, 2]], [0, 0, 0, f], [0, 0, -1 / tx, 0]])
    return {
        "mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5), "dist_right": np.zeros(5),
        "R": np.eye(3), "T": np.array([[tx], [0.0], [0.0]]),
        "R1": np.eye(3), "R2": np.eye(3), "P1": P1, "P2": P2, "Q": Q,
        "img_size": np.array([W, H]),
    }


class Params:
    """The engine's settings from a configuration's ``params`` (the
    program's ``SGMParams`` fields), with the same defaults."""

    DEFAULTS = dict(min_disparity=0, num_disparities=128, census_ksize=5, census_wsize=5,
                    p1=8.0, p2=96.0, uniqueness_ratio=10, lr_max_diff=1,
                    speckle_window_size=100, speckle_range=32.0, median_ksize=5,
                    subpixel=True, mode="full", coarse_scale=4, coarse_paths=4,
                    census_kill=6.0, fill_invalid=False, refine_range=32, pack=1, paths=4,
                    b_decimate=1, lr_groups=0, agg_wseg=1)

    def __init__(self, **kw):
        merged = dict(self.DEFAULTS)
        merged.update({k: v for k, v in kw.items() if k in self.DEFAULTS})
        self.__dict__.update(merged)

    def but(self, **kw):
        out = Params(**self.__dict__)
        out.__dict__.update(kw)
        return out

    @property
    def n_bits(self):
        return self.census_ksize * self.census_wsize - 1
