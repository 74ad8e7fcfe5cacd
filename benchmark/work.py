"""The least work of the depth engine for one frame, stage by stage of the
algorithm, and the table of the card's peaks.

Each stage reads each of its inputs once and writes each of its outputs
once, in the narrowest type that holds them: float32 maps (4 bytes),
masks at a bit a pixel, census strings at ⌈n_bits/8⌉ bytes, path costs
at a byte (a path cost is at most n_bits + P2) and summed costs at one or
two bytes (the sum of the paths' bounds). Operations are the stage's own
compares, adds and bit operations. The count depends on the
configuration's shapes alone (H, W, D, R, the census window, the paths,
the filters), never on how the program implements a stage: a change that
fuses, splits or replaces kernels changes the time and not the count.

The least time of a frame is the larger of all stages' bytes over the
memory bandwidth and all stages' operations over the operation peak.
"""

from __future__ import annotations

import dataclasses
import math

from benchmark.depth_config import Params

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet (dense, 700 W): HBM3
# bandwidth, and the float32 rate outside the tensor cores, the peak that
# bounds scalar compares, adds and bit operations
PEAKS = {
    "card": "NVIDIA H100 80GB HBM3 (SXM5, 700 W)",
    "hbm_bytes_per_s": 3.35e12,
    "ops_per_s": 67e12,
}

F32 = 4          # a float32 map's bytes a pixel
BIT = 1 / 8      # a mask's bytes a pixel


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    bytes: float
    ops: float


def _census_bytes(p: Params) -> int:
    return math.ceil(p.n_bits / 8)


def _words(p: Params) -> int:
    return math.ceil(p.n_bits / 32)


def _sum_bytes(p: Params, paths: int) -> int:
    return 1 if paths * (p.n_bits + p.p2) <= 255 else 2


def census(p: Params, n_px: int, images: int = 2) -> Stage:
    """Census strings of ``images`` float32 images of ``n_px`` pixels: a
    compare a window pixel."""
    return Stage("census", images * n_px * (F32 + _census_bytes(p)), images * n_px * p.n_bits)


def cost(p: Params, n_px: int, D: int, extra_in: float = 0.0) -> Stage:
    """The (H, W, D) Hamming cost volume from the two census strings
    (``extra_in`` bytes a pixel more read: a shift field): an xor and a
    population count a word."""
    return Stage("cost", n_px * (2 * _census_bytes(p) + extra_in) + n_px * D,
                 n_px * D * 2 * _words(p))


def aggregate(p: Params, n_px: int, D: int, paths: int) -> Stage:
    """The path costs' sum: each direction's recurrence L = c + min(L[d],
    L[d±1] + P1, min L + P2) − min L (six operations an element), and the
    adds of the sum."""
    return Stage("aggregate", n_px * D * (1 + _sum_bytes(p, paths)),
                 n_px * D * (6 * paths + paths - 1))


def wta(p: Params, n_px: int, D: int, paths: int) -> Stage:
    """Winner, competitor and parabola: the summed volume in; disparity,
    mask and best cost out."""
    return Stage("wta", n_px * D * _sum_bytes(p, paths) + n_px * (2 * F32 + BIT),
                 n_px * D * 3 + n_px * 12)


def lr(p: Params, rows: int, W: int, D: int, paths: int) -> Stage:
    """The right view's disparity from the summed volume's diagonals (only
    s[y, u + d, d] with u + d < W) and the consistency test."""
    dv = min(D, W)
    diag = rows * (W * dv - dv * (dv - 1) // 2)
    n_px = rows * W
    return Stage("lr", diag * _sum_bytes(p, paths) + n_px * (F32 + 2 * BIT),
                 2 * diag + 4 * n_px)


def speckle(p: Params, n_px: int, D: int) -> Stage:
    """The windowed speckle filter: per binning, a bin a pixel and per bin
    an indicator and a separable running window sum."""
    r = max(1, int(p.speckle_range))
    nbins = (D + r) // r + 2
    return Stage("speckle", n_px * (F32 + 2 * BIT), n_px * (2 * (2 + 5 * nbins) + 1))


def median(n_px: int, k: int, name: str = "median") -> Stage:
    return Stage(name, n_px * 2 * F32, n_px * k * k)


def select(n_px: int, name: str = "select") -> Stage:
    """Invalid pixels set to the sentinel (or, for the confidence, the
    range test): disparity and mask in, a map out."""
    return Stage(name, n_px * (2 * F32 + BIT), n_px * 3)


def full_search(p: Params, H: int, W: int, D: int, paths: int, median_k: int) -> list[Stage]:
    n_px = H * W
    out = [census(p, n_px), cost(p, n_px, D), aggregate(p, n_px, D, paths), wta(p, n_px, D, paths)]
    if p.lr_max_diff >= 0:
        out.append(lr(p, H, W, D, paths))
    if p.speckle_window_size > 0:
        out.append(speckle(p, n_px, D))
    if median_k > 1:
        out.append(median(n_px, median_k))
    out.append(select(n_px))
    return out


def hier2(p: Params, H: int, W: int) -> list[Stage]:
    D, R, s = p.num_disparities, p.refine_range, p.coarse_scale
    h, w = H // s, W // s
    n_px, n_c = H * W, h * w
    out = [Stage("downscale", 2 * (n_px + n_c) * F32, 2 * n_c * 8)]
    coarse = [dataclasses.replace(st, name=f"coarse {st.name}") for st in full_search(
        p, h, w, max(16, -(-D // s)), p.coarse_paths, 3 if p.coarse_paths == 4 else 5)]
    out += coarse
    out += [
        Stage("coarse fill", n_c * (F32 + BIT) + n_c * F32, n_c * 8),
        median(n_c, 5, "coarse fill median"),
        Stage("upsample", (n_c + n_px) * F32, n_px * 8),
        # two int16 shift fields from the envelopes: doubling min/max
        # steps along the row, then along the column
        Stage("window shifts", n_px * (F32 + 2 * 2),
              n_px * 4 * (math.ceil(math.log2(R)) + math.ceil(math.log2(2 * R))
                          + 2 * math.ceil(math.log2(2 * s + 4)))),
        census(p, n_px),
    ]
    dec = 3 if (p.b_decimate == 3 and H % 24 == 0) else 1
    rows = H + -(-H // dec)
    n_r = rows * W
    out += [dataclasses.replace(st, name=f"refine {st.name}") for st in (
        cost(p, n_r, R, extra_in=2), aggregate(p, n_r, R, p.paths), wta(p, n_r, R, p.paths),
        lr(p, H, W, R, p.paths))]
    out += [
        # the shift and the ramp at the matched column; disparity, mask,
        # shift in, disparity and mask out
        Stage("refine unshift", n_r * (2 * F32 + 2 * BIT + 2), n_r * 15),
        # both windows' disparity, mask and cost in, the census at two
        # candidates, the merged disparity and mask out
        Stage("arbitration", n_px * (2 * (2 * F32 + BIT) + 3 * _census_bytes(p) + F32 + BIT),
              n_px * (2 * (2 * _words(p) + 1) + 12)),
    ]
    if p.speckle_window_size > 0:
        out.append(speckle(p, n_px, D))
    if p.fill_invalid:
        out += [
            Stage("fill nearest", 2 * n_px * (2 * F32 + BIT) + 2 * n_px * 2 * F32, n_px * 16),
            Stage("fill census", n_px * (4 * _census_bytes(p) + 3 * F32 + BIT + F32),
                  n_px * (3 * (2 * _words(p) + 1) + 6)),
            median(n_px, p.median_ksize, "fill median"),
        ]
    else:
        out += [median(n_px, p.median_ksize), select(n_px)]
    return out


def engine_stages(config: dict) -> list[Stage]:
    """The engine's stages for one frame of a configuration: rectified
    float32 pair in; disparity and confidence out."""
    p = Params(**config["pipeline"]["params"])
    H, W = config["rig"]["height"], config["rig"]["width"]
    if p.mode == "hier2" and p.num_disparities > p.refine_range:
        stages = hier2(p, H, W)
    elif p.mode == "full" or p.num_disparities <= p.refine_range:
        stages = full_search(p, H, W, p.num_disparities, p.paths, p.median_ksize)
    else:
        raise KeyError(f"no count of the {p.mode!r} search")
    return stages + [select(H * W, "confidence")]


def least_seconds(stages: list[Stage], peaks: dict = PEAKS) -> float:
    """The larger of all bytes over the bandwidth and all operations over
    the operation peak."""
    return max(sum(s.bytes for s in stages) / peaks["hbm_bytes_per_s"],
               sum(s.ops for s in stages) / peaks["ops_per_s"])
