"""The generator: the same seed gives the same frames, and only the
texture comes from the seed."""

import numpy as np
import torch

from benchmark.depth_config import calibration


def parts(tiny, cell):
    c = tiny.cell(cell)
    return tiny.config(c["config"]), tiny.traffic(c["traffic"])


def gen(tiny, traffic):
    return tiny.module("generators", traffic["generator"])


def test_same_seed_same_frames(tiny):
    config, traffic = parts(tiny, "tiny-prod-cam20")
    scene = gen(tiny, traffic)
    a = scene.inputs(config, traffic, 2**31 + 11, torch.device("cpu"))
    b = scene.inputs(config, traffic, 2**31 + 11, torch.device("cpu"))
    c = scene.inputs(config, traffic, 2**31 + 12, torch.device("cpu"))
    assert len(a) == traffic["scene"]["ring_frames"]
    for (al, ar), (bl, br) in zip(a, b):
        assert al.dtype == np.uint8 and al.shape == (96, 256) and al.flags.c_contiguous
        assert np.array_equal(al, bl) and np.array_equal(ar, br)
    assert not np.array_equal(a[0][0], c[0][0])


def test_geometry_is_the_seeds_alike(tiny):
    config, traffic = parts(tiny, "tiny-prod-cam20")
    scene = gen(tiny, traffic)
    L = scene.layout(config, traffic)
    assert L["bg_disp"] == 8 and L["box_disp"] == 40      # 0.125 and 0.625 of D=64
    assert L["box"] == (27, 120, 43, 80)                  # scaled from 1280x720
    for seed in (1, 2**31 + 3):
        left, right = scene.inputs(config, traffic, seed, torch.device("cpu"))[1]
        # the background row above the box: the right view is the left
        # shifted by the background's disparity
        assert np.array_equal(left[5, 30:200], right[5, 30 - 8:200 - 8])
        y0, x0, bh, bw = L["box"]
        x = x0 + 1  # frame 1: panned one pixel to the right
        assert np.array_equal(left[y0 + 3, x:x + bw], right[y0 + 3, x - 40:x - 40 + bw])


def test_pan_moves_one_pixel_a_frame(tiny):
    config, traffic = parts(tiny, "tiny-full-replay")
    f = gen(tiny, traffic).inputs(config, traffic, 5, torch.device("cpu"))
    assert np.array_equal(f[1][0][:, 1:], f[0][0][:, :-1])


def test_calibration_is_the_rig(tiny):
    config, _ = parts(tiny, "tiny-full-replay")
    cal = calibration(config)
    assert cal["P1"][0, 0] == 700.0 and cal["T"][0, 0] == -6.0
    assert tuple(cal["img_size"]) == (256, 96)
