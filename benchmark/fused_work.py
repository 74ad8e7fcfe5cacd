"""The least work of one fused frame, stage by stage of the algorithm, at a
fused configuration's shapes: the processing size (w, h) from the rig and
the scale, the stereo search's D, R and coarse scale, the network's input
size, the flow's levels, window and iterations, RANSAC's hypotheses.

A stage's bytes are float32 maps (4 bytes a value) and masks (a bit a
pixel) read once and written once; its operations are the adds,
multiplies, compares and transcendental functions of the algorithm, as in
``work.py``. The network's operations are those of its products (two a
multiply-add of every convolution, as ``torch.utils.flop_counter`` counts
them), its bytes each layer's input, weights and output (the batch norms
folded into the convolutions before them; the activations and residual
adds folded into the products, their bytes counted). A window
sum counts as running sums (two adds a pixel an axis), a percentile as a
selection over its values (an operation a value),
an eigen-solve of an n×n symmetric matrix as 9n³ operations (Jacobi's
sweeps, a constant of the solver's class). The count depends on the
shapes alone, never on how the program computes a stage.

The fused frame's share of the card's float32 peak (``mfu.fused``) reads
:func:`ops`; ``work.least_seconds`` takes :func:`stages` for a roofline.
"""

from __future__ import annotations

import dataclasses
import math

from benchmark import work
from benchmark.depth_config import Params
from benchmark.references.fused_frame import FEATURES, _blocks
from benchmark.work import BIT, F32, Stage


def processing_size(config: dict) -> tuple[int, int]:
    """(w, h): max(32, ⌊size·scale⌋) rounded down to even, per axis."""
    s = config["fused"]["scale"]
    W, H = config["rig"]["width"], config["rig"]["height"]
    return max(32, int(W * s)) // 2 * 2, max(32, int(H * s)) // 2 * 2


def _map(name: str, n_px: int, maps_in: int, maps_out: int, ops_per_px: float) -> Stage:
    return Stage(name, n_px * F32 * (maps_in + maps_out), n_px * ops_per_px)


def _conv(name: str, cin: int, cout: int, k: int, hw_in: int, hw_out: int, groups: int = 1,
          bias: bool = False, extra_in: int = 0) -> Stage:
    values = cin * hw_in + cout * (cin // groups) * k * k + (cout if bias else 0) + cout * hw_out
    return Stage(name, F32 * (values + extra_in), 2 * hw_out * cout * (cin // groups) * k * k)


def net_stages(net_hw) -> list[Stage]:
    """MiDaS v2.1 small's forward at ``net_hw`` (multiples of 32), batch 1:
    the EfficientNet-Lite3 encoder, the ``layerN_rn`` convolutions, the
    four fusion blocks and the head."""
    H, W = net_hw
    out = [_conv("stem", 3, 32, 3, H * W, (H // 2) * (W // 2))]
    h, w, taps = H // 2, W // 2, []
    blocks = _blocks()
    for j, (pre, kind, k, stride, ci, mid, co) in enumerate(blocks):
        ho, wo = -(-h // stride), -(-w // stride)
        residual = ci * ho * wo if stride == 1 and ci == co else 0
        if kind == "ds":
            out.append(_conv(pre + "depthwise", ci, ci, k, h * w, ho * wo, groups=ci))
        else:
            out.append(_conv(pre + "expand", ci, mid, 1, h * w, h * w))
            out.append(_conv(pre + "depthwise", mid, mid, k, h * w, ho * wo, groups=mid))
        out.append(_conv(pre + "project", mid, co, 1, ho * wo, ho * wo, extra_in=residual))
        h, w = ho, wo
        if j + 1 == len(blocks) or blocks[j + 1][0].split(".")[1] != pre.split(".")[1]:
            taps.append((co, h * w))
    widths = [FEATURES << i for i in range(4)]
    for i, (c, n) in enumerate(taps):
        out.append(_conv(f"layer{i + 1}_rn", c, widths[i], 3, n, n))

    def rcu(name, f, n):
        return [_conv(f"{name} conv1", f, f, 3, n, n, bias=True),
                _conv(f"{name} conv2", f, f, 3, n, n, bias=True, extra_in=f * n)]

    for i in (4, 3, 2, 1):
        f, n = widths[i - 1], taps[i - 1][1]
        if i < 4:
            out += rcu(f"refinenet{i} skip", f, n) + [Stage(f"refinenet{i} add", F32 * 3 * f * n,
                                                            0)]
        out += rcu(f"refinenet{i} unit", f, n)
        out.append(Stage(f"refinenet{i} upsample", F32 * 5 * f * n, 0))
        out.append(_conv(f"refinenet{i} out", f, f // 2 if i > 1 else f, 1, 4 * n, 4 * n,
                         bias=True))
    n = taps[0][1] * 4  # the head at half the input's size, then the input's
    out.append(_conv("head 0", FEATURES, FEATURES // 2, 3, n, n, bias=True))
    out.append(Stage("head upsample", F32 * 5 * (FEATURES // 2) * n, 0))
    out += [_conv("head 2", FEATURES // 2, 32, 3, 4 * n, 4 * n, bias=True),
            _conv("head 4", 32, 1, 1, 4 * n, 4 * n, bias=True)]
    return out


def net_flops(net_hw) -> float:
    """The network's floating-point operations: its products'."""
    return sum(s.ops for s in net_stages(net_hw))


def stereo_stages(p: Params, H: int, W: int) -> list[Stage]:
    """hier: the coarse full search at 1/s over ⌈D/s⌉ disparities on the
    coarse paths, its fill and medians, the upsampling, window A's shift
    (the row's min-envelope), the right image warped by it, the refine
    full search over R disparities on the fine paths (LR check, speckle,
    median), the shift added back, the confidence."""
    D, R, s = p.num_disparities, p.refine_range, p.coarse_scale
    n_px = H * W
    out = []
    if D > R:
        h, w = H // s, W // s
        n_c = h * w
        out.append(Stage("downscale", 2 * (n_px + n_c) * F32, 2 * n_c * 8))
        out += [dataclasses.replace(st, name=f"coarse {st.name}") for st in work.full_search(
            p, h, w, max(16, -(-D // s)), p.coarse_paths, 3 if p.coarse_paths == 4 else 5)]
        out += [Stage("coarse fill", n_c * (F32 + BIT) + n_c * F32, n_c * 8),
                work.median(n_c, 5, "coarse fill median"),
                Stage("upsample", (n_c + n_px) * F32, n_px * 8),
                Stage("window shift", n_px * (F32 + 2), n_px * (2 * math.ceil(math.log2(R)) + 3)),
                Stage("warp right", n_px * (F32 + 2 + F32), n_px * 2)]
        D_fine = R
    else:
        D_fine = D
    out += [dataclasses.replace(st, name=f"refine {st.name}")
            for st in work.full_search(p, H, W, D_fine, p.paths, p.median_ksize)]
    if D > R:
        out.append(Stage("unshift", n_px * (2 * F32 + BIT + 2 + F32), n_px * 6))
    out.append(work.select(n_px, "confidence"))
    return out


def flow_stages(config: dict, H: int, W: int) -> list[Stage]:
    """Both images' pyramids, then per level the gradients, the structure
    tensor's three windowed sums and per iteration the warp, the two
    windowed sums and the 2×2 solve; the flow's upsampling between levels."""
    f = config["flow"]
    levels, iters = f["flow_levels"], f["flow_iters"]
    out, h, w = [], H, W
    sizes = [(h, w)]
    for lv in range(levels - 1):
        n_in = h * w
        h, w = h // 2, w // 2
        out.append(Stage(f"pyramid {lv + 1}", 2 * F32 * (n_in + h * w),
                         2 * (n_in * 20 + h * w * 8)))
        sizes.append((h, w))
    for lv, (h, w) in reversed(list(enumerate(sizes))):
        n = h * w
        out.append(_map(f"level {lv} structure", n, 1, 4, 4 + 3 + 3 * 5 + 4))
        out.append(Stage(f"level {lv} iterations", iters * n * F32 * (2 + 5 + 2 + 2),
                         iters * n * (12 + 1 + 2 + 2 * 5 + 10 + 4 + 2)))
        if lv:
            out.append(_map(f"level {lv} upsample", n * 4, 0, 2, 8 * 2 + 2))
    return out


def ego_stages(config: dict, H: int, W: int) -> list[Stage]:
    """RANSAC's hypotheses (a 4-point DLT each: the 8×9 system, its 9×9
    normal matrix, the eigen-solve, the denormalisation), their inliers over
    the grid, two weighted refits over the grid, the dense ego-flow."""
    step, n_hyp = config["flow"]["grid_step"], config["ransac"]["hypotheses"]
    N = len(range(step // 2, H, step)) * len(range(step // 2, W, step))
    dlt = 4 * 12 + 8 * 9 * 9 * 2 + 9 * 9 ** 3 + 3 * 27 * 2 + 9

    def fit(n):
        return n * 12 + 2 * n * 9 * 9 * 2 + 9 * 9 ** 3 + 3 * 27 * 2 + 9

    return [Stage("hypotheses", F32 * (N * 4 + n_hyp * 9), n_hyp * dlt),
            Stage("inliers", F32 * (N * 4 + n_hyp * 9) + n_hyp * N * BIT, n_hyp * N * (15 + 3)),
            Stage("refits", config["ransac"]["refits"] * F32 * N * 4,
                  config["ransac"]["refits"] * (fit(N) + N * 18)),
            _map("ego-flow", H * W, 0, 2, 15)]


def stages(config: dict) -> list[Stage]:
    """Every stage of one fused frame with stereo on (the hysteresis at
    ``none``): both uint8 images up, resized, rectified, scored, searched,
    the network's pre-processing, forward and post-processing, MiDaS
    calibrated to stereo, the flow and the ego-motion, the motion depth,
    the flow depth put in the stereo range, the fusion, the metres."""
    w, h = processing_size(config)
    n = h * w
    W, H = config["rig"]["width"], config["rig"]["height"]
    nh, nw = config["fused"]["net_hw"]
    nn_px = nh * nw
    p = Params(**config["sgm"])
    q = config["fusion"]
    bd = q["bilateral_d"] ** 2
    out = [Stage("upload cast", 2 * H * W * (1 + F32), 2 * H * W),
           _map("resize", n, 2 * W * H / n, 2, 2 * 8),
           _map("rectify", n, 2 + 4, 2, 2 * 12),
           _map("occlusion scores", n, 2, 0, 2 * 12)]
    out += stereo_stages(p, h, w)
    out += [Stage("net input", F32 * (n + 3 * nn_px), 3 * nn_px * 8)]
    out += net_stages((nh, nw))
    out += [Stage("net output", F32 * (nn_px + 2 * n), n * 8 + 3 * n),
            _map("mono confidence", n, 1, 1, 5 + 2 * 5 * 2 + 4),
            _map("midas calibration", n, 3, 1, 6 * 1 + 4)]
    out += flow_stages(config, h, w)
    out += ego_stages(config, h, w)
    out += [_map("motion depth", n, 5, 3, 6 + 2 + 5 + 3),
            _map("motion bilateral", n, 1, 1, bd * 8),
            _map("flow to stereo range", n, 2, 1, 4 + 8),
            _map("fusion", n, 4, 2, 1 + 2 + q["midas_blend_radius"] * 2 * 2 + 3 + 4 + 6),
            _map("fusion bilateral", n, 1, 1, bd * 8 + 2),
            _map("metres", n, 1, 1, 5)]
    return out


def ops(config: dict) -> float:
    """A fused frame's operations."""
    return sum(s.ops for s in stages(config))
