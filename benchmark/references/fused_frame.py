"""The plain reference of one frame of the fused pipeline, computed from a
state: resize and rectification, the occlusion scores and their
hysteresis, the coarse-to-fine stereo search (``hier``), MiDaS v2.1 small's
forward, the calibration of MiDaS against stereo, dense pyramidal LK flow,
the RANSAC homography of the ego-motion, the motion depth's EMA and
bilateral, the normalisation of the flow depth, the fusion and the metres,
in plain PyTorch.

It is written from the equations of the JAX package's fused path
(``pipeline.FusedPipeline``, ``mono``, ``fusion``) and imports nothing of
the program. The stereo pieces are ``depth_maps.py``'s. The network is the
hub's MiDaS v2.1 small, written again from its layers as functions of a
hub-format state_dict, whose weights are drawn here from the
configuration's ``weights_seed`` (:func:`weights`); the system under test
loads the same tensors through its hub-checkpoint path.

The RANSAC hypotheses are drawn from a ``torch.Generator`` restored from
the state's generator state, on the same device and with the same call as
the state's owner draws them, so both sides draw the same indices. Its DLT
is the JAX package's matrix products. RANSAC keeps the first hypothesis
with the most inliers; a 4-point DLT in float32 is ill-conditioned enough
that another order of its sums moves a count by a few points, so the first
of the most is rounding's choice among near-ties. The reference takes every
hypothesis within ``tie_points`` of the most through the refits and, given
the program's next state, continues from the near-tie whose EMA depth
lies nearest it (the first of the most where none is given); ``ties``
records, frame by frame, how many near-ties there were and whether the one
taken was another than the reference's own first (:meth:`_flow_depth`).
A pick outside the near-ties, a wrong EMA or a wrong flag still reads as a
gap of the state.

``dtype`` is the floating type of every real-valued map: float32, as the
configuration states (both TF32 flags are set off while a frame is
computed), ``"tf32"`` (float32 with both TF32 flags on, a control), or a
lower precision for a control. The eigen-solves and the percentiles run in
float32 where ``dtype`` is lower (PyTorch has no bfloat16 form of either).

    ref = Reference(config, device="cuda")
    outputs, next_state = ref.step(state, left_u8, right_u8)

A state is a dict: the flow state (``prev_gray``, ``stable_depth``,
``has_prev``, ``has_stable``, ``last_move_time``, ``rng_state``), the
hysteresis (state, pending, count), ``pending_scores`` (the last odd frame's
two occlusion scores, or None), ``frame`` (the pipeline's frame counter)
and ``clock`` (the call's index k: it runs at t = k / camera_fps).

The comparison is here too (:func:`numbers`): the worst frame's numbers
against their limits (``limits/<config>.json``). The fusion thresholds its
inputs (a stereo hole below 15, a fill weight above 0.1, a map whose
largest value passes 10), so a rounding-level difference upstream can flip
a pixel's branch and move it by many levels; the maps' numbers are
therefore shares of the frame's pixels that differ by more than a
tolerance:

- ``fused_off``: |got − want| of the fused map above ``fused_tol`` (in its
  0-255 levels); 1, every pixel, where the mode code (which methods the map
  was fused from) or the motion flag (whether flow took part) differs;
- ``conf_off``: |got − want| of the confidence above ``conf_tol``;
- ``meters_off``: |got − want| / want of the metres above ``meters_rtol``,
  over the pixels strictly inside the clamp (0.05, 30) m in both (of all
  the frame's pixels);
- ``state_err``: the largest of the next state's gaps: the previous image's
  over 255, the EMA depth's over its largest value, the pending scores';
  1 where a flag, the clock of the last motion, the generator's state, the
  hysteresis, the frame counter or the clock differs. The state before the
  first frame is compared the same way (:func:`start_numbers`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.depth_config import Params, calibration
from benchmark.references import depth_maps as dm

# RANSAC's near-ties: the hypotheses within this many inliers of the most
# (see the module's notes): twice the largest shortfall of the program's
# outcome read on the card, 7 of ~390 grid points over 168 frames (PERF.md)
TIE_POINTS = 16

# the occlusion detector's thresholds (the reference app's, fused_depth_map.py)
STD_THRESHOLD = 28.0
LOW_VAR_THRESHOLD = 0.55
CONTRAST_RATIO = 2.2
ENTROPY_RATIO = 1.6
BRIGHTNESS_DIFF = 45.0


# ---------------------------------------------------------------------------
# MiDaS v2.1 small: the hub's names and shapes, the seeded weights, the forward
# ---------------------------------------------------------------------------

# EfficientNet-Lite3's stages (gen-efficientnet ``tf_efficientnet_lite3``:
# width 1.2, depth 1.4, no squeeze-excitation): (blocks, kernel, first stride,
# expansion, input channels, output channels); stage 0 is depthwise-separable
LITE3 = ((1, 3, 1, 1, 32, 24), (3, 3, 2, 6, 24, 32), (3, 5, 2, 6, 32, 48),
         (5, 3, 2, 6, 48, 96), (5, 5, 1, 6, 96, 136), (6, 5, 2, 6, 136, 232),
         (1, 3, 1, 6, 232, 384))
# the hub's ``pretrained.layerN``: the stem and stages 0-1, stage 2, stages
# 3-4, stages 5-6; tapped after each (strides 4, 8, 16, 32)
LAYERS = ((0, 1), (2,), (3, 4), (5, 6))
FEATURES = 64  # MidasNet_small, expand=True: the scratch at 64/128/256/512
TAPS = (32, 48, 136, 384)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BN_EPS = 1e-3  # the tf_ variants'
_LAST = "scratch.output_conv.4.weight"  # drawn non-negative (see weights)


def _blocks():
    """(hub prefix, kind, kernel, stride, input, expanded, output channels)
    of every block of the encoder, in order."""
    out = []
    for layer, stages in enumerate(LAYERS, start=1):
        for j, st in enumerate(stages):
            n, k, stride, expand, cin, cout = LITE3[st]
            # layer 1 holds the stem at 0 (its batch norm at 1, ReLU6 at 2)
            slot = j + 3 if layer == 1 else j
            for b in range(n):
                ci = cin if b == 0 else cout
                out.append((f"pretrained.layer{layer}.{slot}.{b}.", "ds" if expand == 1 else "ir",
                            k, stride if b == 0 else 1, ci, ci * expand, cout))
    return out


def manifest() -> list[tuple[str, tuple[int, ...]]]:
    """The hub MiDaS_small checkpoint's (name, shape) pairs in its order
    (``num_batches_tracked`` left out): the encoder, the four ``layerN_rn``
    convolutions, the fusion blocks 4 to 1, the head."""
    def bn(name, c):
        return [(f"{name}.{leaf}", (c,)) for leaf in ("weight", "bias", "running_mean",
                                                       "running_var")]

    out = [("pretrained.layer1.0.weight", (32, 3, 3, 3))] + bn("pretrained.layer1.1", 32)
    for pre, kind, k, _, ci, mid, co in _blocks():
        if kind == "ds":
            out += [(pre + "conv_dw.weight", (ci, 1, k, k))] + bn(pre + "bn1", ci)
            out += [(pre + "conv_pw.weight", (co, ci, 1, 1))] + bn(pre + "bn2", co)
        else:
            out += [(pre + "conv_pw.weight", (mid, ci, 1, 1))] + bn(pre + "bn1", mid)
            out += [(pre + "conv_dw.weight", (mid, 1, k, k))] + bn(pre + "bn2", mid)
            out += [(pre + "conv_pwl.weight", (co, mid, 1, 1))] + bn(pre + "bn3", co)
    widths = [FEATURES << i for i in range(4)]
    out += [(f"scratch.layer{i + 1}_rn.weight", (widths[i], TAPS[i], 3, 3)) for i in range(4)]
    for i in (4, 3, 2, 1):
        f = widths[i - 1]
        r = f"scratch.refinenet{i}."
        out += [(r + "out_conv.weight", (f // 2 if i > 1 else f, f, 1, 1)),
                (r + "out_conv.bias", (f // 2 if i > 1 else f,))]
        for unit in (1, 2):
            for conv in (1, 2):
                u = f"{r}resConfUnit{unit}.conv{conv}."
                out += [(u + "weight", (f, f, 3, 3)), (u + "bias", (f,))]
    h = "scratch.output_conv."
    out += [(h + "0.weight", (FEATURES // 2, FEATURES, 3, 3)), (h + "0.bias", (FEATURES // 2,)),
            (h + "2.weight", (32, FEATURES // 2, 3, 3)), (h + "2.bias", (32,)),
            (h + "4.weight", (1, 32, 1, 1)), (h + "4.bias", (1,))]
    return out


def weights(config: dict, device) -> dict[str, torch.Tensor]:
    """The seeded float32 hub state_dict on ``device``, drawn in
    :func:`manifest`'s order from one generator on the device seeded with
    the configuration's ``weights_seed`` (the same seed and device give the
    same tensors): each convolution's weight normal with std 1/√fan_in (a
    depthwise one's fan-in is its k² taps), biases and batch norms' shifts
    and running means with std 0.02, their scales and running variances at
    1 plus draws of std 0.02. The head's last 1×1 convolution, which sums
    32 rectified features into the depth before the final ReLU, is drawn
    non-negative (the magnitudes of its draws), so that the ReLU does not
    leave a constant map."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(config["fused"]["weights_seed"]))
    out = {}
    for name, shape in manifest():
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        if len(shape) == 4:
            w *= math.prod(shape[1:]) ** -0.5
            if name == _LAST:
                w = w.abs()
        elif name.endswith(("running_var", "weight")):  # a batch norm's scale and variance
            w = 1.0 + 0.02 * w
        else:
            w *= 0.02
        out[name] = w
    return out


def _same(x, w, stride=1, groups=1):
    """TF's SAME convolution (gen-efficientnet's ``Conv2dSame``): the
    padding max((⌈n/s⌉ − 1)·s + k − n, 0) per axis, its smaller half first."""
    k, pads = w.shape[-1], []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride, groups=groups)


class MidasV21:
    """MiDaS v2.1 small's forward (the hub's ``MiDaS_small``:
    ``MidasNet_small(features=64, backbone="efficientnet_lite3",
    exportable=True, non_negative=True, blocks={"expand": True})``) on a
    hub-format state_dict: (H, W, 3) RGB in [0, 1] (H, W multiples of 32)
    → (H, W) relative inverse depth. The ImageNet normalisation; the
    encoder's batch norms on their running statistics,
    (x − mean)/√(var + 1e-3)·scale + shift, ReLU6 after the stem and inside
    the blocks, a residual add where a block keeps its size and width; the
    ``layerN_rn`` 3×3 convolutions to 64/128/256/512; fusion blocks of
    residual conv units (x + conv(relu(conv(relu(x))))), bilinear 2×
    upsampling with aligned corners and a 1×1 convolution; the head."""

    def __init__(self, state_dict: dict, device, dtype):
        self.p = {k: v.to(device=device, dtype=dtype) for k, v in state_dict.items()}
        self.dt, self.device = dtype, torch.device(device)

    def bn(self, x, name):
        p = self.p
        mul = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"] + BN_EPS)
        return ((x - p[name + ".running_mean"][:, None, None]) * mul[:, None, None]
                + p[name + ".bias"][:, None, None])

    def conv(self, x, name, padding=0):
        return F.conv2d(x, self.p[name + ".weight"], self.p.get(name + ".bias"),
                        padding=padding)

    def unit(self, x, name):
        y = self.conv(F.relu(x), name + ".conv1", padding=1)
        return x + self.conv(F.relu(y), name + ".conv2", padding=1)

    def fusion(self, i, x, skip=None):
        r = f"scratch.refinenet{i}"
        if skip is not None:
            x = x + self.unit(skip, r + ".resConfUnit1")
        x = F.interpolate(self.unit(x, r + ".resConfUnit2"), scale_factor=2, mode="bilinear",
                          align_corners=True)
        return self.conv(x, r + ".out_conv")

    @torch.no_grad()
    def __call__(self, rgb):
        p = self.p
        mean = torch.tensor(MEAN, device=self.device).to(self.dt)
        std = torch.tensor(STD, device=self.device).to(self.dt)
        h = ((rgb - mean) / std).permute(2, 0, 1)[None]
        h = self.bn(_same(h, p["pretrained.layer1.0.weight"], 2), "pretrained.layer1.1")
        h = h.clamp(0.0, 6.0)
        taps, blocks = [], _blocks()
        for j, (pre, kind, k, stride, ci, mid, co) in enumerate(blocks):
            if kind == "ds":
                x = self.bn(_same(h, p[pre + "conv_dw.weight"], stride, ci), pre + "bn1")
                x = self.bn(_same(x.clamp(0.0, 6.0), p[pre + "conv_pw.weight"]), pre + "bn2")
            else:
                x = self.bn(_same(h, p[pre + "conv_pw.weight"]), pre + "bn1").clamp(0.0, 6.0)
                x = self.bn(_same(x, p[pre + "conv_dw.weight"], stride, mid), pre + "bn2")
                x = self.bn(_same(x.clamp(0.0, 6.0), p[pre + "conv_pwl.weight"]), pre + "bn3")
            h = x + h if stride == 1 and ci == co else x
            if j + 1 == len(blocks) or blocks[j + 1][0].split(".")[1] != pre.split(".")[1]:
                taps.append(h)  # the last block of a hub layer
        rn = [self.conv(t, f"scratch.layer{i + 1}_rn", padding=1) for i, t in enumerate(taps)]
        path = self.fusion(4, rn[3])
        for i in (3, 2, 1):
            path = self.fusion(i, path, rn[i - 1])
        hd = "scratch.output_conv."
        x = F.interpolate(self.conv(path, hd + "0", padding=1), scale_factor=2, mode="bilinear",
                          align_corners=True)
        x = F.relu(self.conv(x, hd + "2", padding=1))
        return F.relu(self.conv(x, hd + "4"))[0, 0]


# ---------------------------------------------------------------------------
# Image pieces
# ---------------------------------------------------------------------------


def gaussian_taps(k: int) -> list[float]:
    """cv2.getGaussianKernel(k, 0): the fixed table for k ≤ 7, else the
    sampled Gaussian of σ = 0.3·((k − 1)/2 − 1) + 0.8, normalised, as
    float32 values."""
    table = {3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625]}
    if k in table:
        return table[k]
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) / 2
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32).tolist()


def gaussian_blur(img, k):
    """Separable Gaussian of (H, W), replicated borders: along the rows,
    then the columns, each output the weighted views summed in order."""
    taps, pad = gaussian_taps(k), k // 2

    def conv1d(x, ax):
        xp = dm._pad_rep(x, pad, ax)
        n = x.shape[ax]
        out = xp.narrow(ax, 0, n) * taps[0]
        for i in range(1, k):
            out = out + xp.narrow(ax, i, n) * taps[i]
        return out

    return conv1d(conv1d(img, 1), 0)


def bilateral(img, d: int, sigma_color: float, sigma_space: float):
    """cv2.bilateralFilter's weights on (H, W): the d×d window (d odd) cut to
    its inscribed circle, exp(−Δ²/2σc²)·exp(−r²/2σs²), replicated borders."""
    pad = d // 2
    ys, xs = np.mgrid[-pad:pad + 1, -pad:pad + 1]
    space = np.exp(-(xs ** 2 + ys ** 2) / (2 * sigma_space ** 2)) * (np.sqrt(xs ** 2 + ys ** 2)
                                                                    <= pad)
    space = torch.as_tensor(space.reshape(-1).astype(np.float32), device=img.device).to(img.dtype)
    H, W = img.shape
    xp = dm._pad_rep(dm._pad_rep(img, pad, 1), pad, 0)
    win = torch.stack([xp[dy:dy + H, dx:dx + W] for dy in range(d) for dx in range(d)], dim=-1)
    diff = win - img[..., None]
    wgt = torch.exp(-(diff * diff) / (2 * sigma_color * sigma_color)) * space
    return (wgt * win).sum(dim=-1) / (wgt.sum(dim=-1) + 1e-12)


def box(img, k):
    return dm.window_sum(img, k) * (1.0 / (k * k))


def gradient(x):
    """numpy.gradient of (H, W): central differences inside, one-sided at the
    edges; (d/dy, d/dx)."""
    def along(ax):
        n = x.shape[ax]
        inner = (x.narrow(ax, 2, n - 2) - x.narrow(ax, 0, n - 2)) / 2.0
        first = x.narrow(ax, 1, 1) - x.narrow(ax, 0, 1)
        last = x.narrow(ax, n - 1, 1) - x.narrow(ax, n - 2, 1)
        return torch.cat([first, inner, last], dim=ax)

    return along(0), along(1)


def bilinear(img, x, y):
    """img sampled at (x, y), the corners' indices clipped to the image
    (border replication), the lerp a·(1−w) + b·w as ``depth_maps.remap``'s."""
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = x0.clamp(-1, W).to(torch.int64).clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.clamp(-1, H).to(torch.int64).clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)

    def lerp(a, b, w):
        return torch.addcmul(b * w, a, 1 - w)

    return lerp(lerp(img[y0i, x0i], img[y0i, x1i], wx), lerp(img[y1i, x0i], img[y1i, x1i], wx), wy)


def minmax(img, lo, hi):
    mn, mx = img.min(), img.max()
    return (img - mn) / torch.where(mx - mn < 1e-12, 1.0, mx - mn) * (hi - lo) + lo


def percentiles(values, qs, mask=None):
    """numpy's linear percentiles (q in %) of the values (where ``mask``),
    taken in float32 at least; NaN where no value is selected."""
    v = values.reshape(-1)
    v = v.float() if v.dtype not in (torch.float32, torch.float64) else v
    if mask is not None:
        v = v[mask.reshape(-1)]
    n = v.numel()
    if n == 0:
        return [torch.full((), float("nan"), device=values.device)] * len(qs)
    v = torch.sort(v).values
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        out.append((v[lo] + (v[hi] - v[lo]) * (pos - lo)).to(values.dtype))
    return out


# ---------------------------------------------------------------------------
# The rig at the processing size
# ---------------------------------------------------------------------------


def processing_calibration(config: dict) -> tuple[tuple[int, int], dict]:
    """The processing size (w, h): max(32, ⌊size·scale⌋) rounded down to
    even, per axis; the camera matrices scaled to it; the pair rectified
    anew there as cv2.stereoRectify(alpha=0, CALIB_ZERO_DISPARITY) does, in
    float64. Held for an undistorted rig with R = I and the baseline on x
    (the configuration's), where both rectifying rotations are I, the
    shared focal length is fy, the principal point centres the image's
    corners, and alpha 0 scales the focal length so that every rectified
    pixel sees the image."""
    cal = calibration(config)
    scale = config["fused"]["scale"]
    W, H = (int(v) for v in cal["img_size"])
    w, h = max(32, int(W * scale)) // 2 * 2, max(32, int(H * scale)) // 2 * 2
    T = np.asarray(cal["T"], np.float64).ravel()
    if (np.any(cal["dist_left"]) or np.any(cal["dist_right"])
            or not np.array_equal(cal["R"], np.eye(3)) or T[1] != 0 or T[2] != 0):
        raise NotImplementedError("the reference rectifies an undistorted rig with R = I and "
                                  "the baseline on x")
    Ks = []
    for key in ("mtx_left", "mtx_right"):
        K = np.array(cal[key], np.float64)
        K[0] *= w / W
        K[1] *= h / H
        Ks.append(K)
    fc = min(K[1, 1] for K in Ks)
    corners = np.array([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]])
    centre = np.array([(w - 1) * 0.5, (h - 1) * 0.5])

    def normalised(K, pts):  # cv2.undistortPoints without distortion: (u − c)·(1/f)
        return np.stack([(pts[:, 0] - K[0, 2]) * (1.0 / K[0, 0]),
                         (pts[:, 1] - K[1, 2]) * (1.0 / K[1, 1])], -1)

    cc = 0.5 * sum(centre - (normalised(K, corners) * fc).mean(axis=0) for K in Ks)
    cx, cy = cc

    def inner(K):  # the image's extreme rows and columns in the rectified frame
        (x0, y0), (x1, y1) = normalised(K, np.array([[0.0, 0.0], [w - 1.0, h - 1.0]])) * fc + cc
        return x0, y0, x1, y1

    def terms(rect):
        x0, y0, x1, y1 = rect
        return max(cx / (cx - x0), cy / (cy - y0), (w - cx) / (x1 - cx), (h - cy) / (y1 - cy))

    fc = fc * max(terms(inner(K)) for K in Ks)
    P1 = np.array([[fc, 0.0, cx, 0.0], [0.0, fc, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P2 = P1.copy()
    P2[0, 3] = T[0] * fc
    return (w, h), {"K1": Ks[0], "K2": Ks[1], "P1": P1, "P2": P2,
                    "baseline_m": abs(float(T[0])) / 100.0}


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


class Reference:
    """The rig and the network of a fused configuration, then :meth:`step`
    per frame; ``faults`` plants a control's fault: ``"alpha"`` (the EMA's
    moving α off by 0.01), ``"flow_right"`` (flow on the other image),
    ``"rng_ahead"`` (the generator advanced by one draw first)."""

    def __init__(self, config, device, dtype=torch.float32, faults=(), tie_points=TIE_POINTS):
        self.tf32 = dtype == "tf32"
        self.device, self.dt = torch.device(device), torch.float32 if self.tf32 else dtype
        self.faults, self.tie_points, self.ties = set(faults), int(tie_points), []
        self.p = Params(**config["sgm"])
        if self.p.mode != "hier" or self.p.pack != 1 or self.p.paths != 2:
            raise NotImplementedError(f"the reference holds FusedPipeline's hier search, not "
                                      f"{config['sgm']}")
        self.flow, self.fusion, self.occ = config["flow"], config["fusion"], config["occlusion"]
        self.ransac, self.fps = config["ransac"], float(config["camera_fps"])
        self.use = {k: config["fused"][f"use_{k}"] for k in ("stereo", "midas", "flow")}
        self.net_hw = tuple(config["fused"]["net_hw"])
        self.size, cal = processing_calibration(config)
        w, h = self.size
        self.maps = (dm.rectify_maps(cal["K1"], np.zeros(5), np.eye(3), cal["P1"], self.size,
                                     self.device)
                     + dm.rectify_maps(cal["K2"], np.zeros(5), np.eye(3), cal["P2"], self.size,
                                       self.device))
        self.focal, self.baseline_cm = float(cal["P1"][0, 0]), cal["baseline_m"] * 100.0
        self.net = (MidasV21(weights(config, self.device), self.device, self.dt)
                    if self.use["midas"] else None)

    def initial_state(self) -> dict:
        w, h = self.size
        zeros = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        out = {"hysteresis": ("none", "none", 0), "pending_scores": None, "frame": 0, "clock": 0}
        if self.use["flow"]:
            out.update(prev_gray=zeros, stable_depth=zeros.clone(),
                       has_prev=torch.zeros((), dtype=torch.bool, device=self.device),
                       has_stable=torch.zeros((), dtype=torch.bool, device=self.device),
                       last_move_time=torch.full((), -1e9, device=self.device),
                       rng_state=torch.Generator(device=self.device).manual_seed(
                           int(self.ransac["generator_seed"])).get_state())
        return out

    # -- occlusion ----------------------------------------------------------

    def _scores(self, lr, rr):
        def metrics(g):
            g = g.float()
            H, W = g.shape
            b = 48
            x = g[:H // b * b, :W // b * b].reshape(H // b, b, W // b, b)
            m = x.mean(dim=(1, 3), keepdim=True)
            bs = ((x - m) ** 2).mean(dim=(1, 3)).sqrt()
            hist = torch.bincount(g.clamp(0, 255).to(torch.int64).reshape(-1), minlength=256)
            hist = hist.to(torch.float32) + 1e-10
            p = hist / hist.sum()
            return (bs.mean(), (bs < 12.0).float().mean(), ((g - g.mean()) ** 2).mean().sqrt(),
                    -(p * torch.log2(p + 1e-10)).sum(), g.mean())

        (ls, ll, lc, le, lb), (rs, rl, rc, re, rb) = metrics(lr), metrics(rr)

        def score(std, lvr, con, ent, bri, o_con, o_ent, o_bri):
            s = 0.35 * (std < STD_THRESHOLD * 0.8).float()
            s = s + 0.35 * (lvr > LOW_VAR_THRESHOLD).float()
            s = s + 0.25 * ((con < o_con / CONTRAST_RATIO) & (o_con > 15.0)).float()
            s = s + 0.25 * ((ent < o_ent / ENTROPY_RATIO) & (o_ent > 5.0)).float()
            return s + 0.2 * (((bri - o_bri).abs() > BRIGHTNESS_DIFF) & (bri < 80.0)).float()

        return (score(ls, ll, lc, le, lb, rc, re, rb), score(rs, rl, rc, re, rb, lc, le, lb))

    def _classify(self, ls: float, rs: float) -> str:
        t = self.occ["threshold"]
        if ls > t and rs < t * 0.6:
            return "left"
        if rs > t and ls < t * 0.6:
            return "right"
        if ls > t and rs > t:
            return "both"
        return "none"

    def _hysteresis(self, carry, detected):
        state, pending, count = carry
        if detected == state:
            return state, state, 0
        count = count + 1 if detected == pending else 1
        if count >= self.occ["confirm_frames"]:
            return detected, detected, 0
        return state, detected, count

    # -- stereo -------------------------------------------------------------

    def _stereo(self, lr, rr):
        """hier: the coarse search, window A's shift from the row's
        min-envelope of radius R − 1 less a margin, one refine search of R
        disparities over the right image warped by it (LR check, speckle,
        median), the shift added back where valid."""
        p, dt = self.p, self.dt
        D, R, s = p.num_disparities, p.refine_range, p.coarse_scale
        if D <= R:
            disp, valid = dm.full_search(lr, rr, p.but(mode="full"), dt)
        else:
            d_up = dm.coarse_disparity(lr, rr, p, dt)
            env, k = d_up, 1
            while k < R:
                env = dm._shift_cols(env, k, torch.minimum)
                k *= 2
            shift = torch.round(env - (4.0 + s)).clamp(p.min_disparity,
                                                      p.min_disparity + D - R)
            W = lr.shape[1]
            xs = torch.arange(W, device=lr.device)[None, :]
            warped = rr.gather(1, (xs - shift.to(torch.int64)).clamp(0, W - 1))
            disp_r, valid = dm.full_search(lr, warped, p.but(mode="full", num_disparities=R,
                                                             min_disparity=0), dt)
            drr = torch.minimum(torch.round(disp_r).to(torch.int64).clamp(min=0), xs)
            # the shift travels with the right image's columns: d = d_r + shift(x − d_r)
            disp = torch.where(valid, disp_r + shift.gather(1, xs - drr),
                               float(p.min_disparity) - 1.0)
        lo, hi = p.min_disparity + 1, p.min_disparity + D - 1
        conf = (valid & (disp > lo) & (disp < hi)).to(dt)
        return (disp / D * 255.0).clamp(0, 255), conf

    # -- mono depth ---------------------------------------------------------

    def _midas(self, lr):
        H, W = lr.shape
        frame = torch.stack([lr] * 3, dim=-1)
        small = dm.resize(frame.flip(-1) / 255.0, self.net_hw)
        depth = minmax(dm.resize(self.net(small), (H, W)), 0.0, 255.0)
        gray = 0.114 * frame[..., 0] + 0.587 * frame[..., 1] + 0.299 * frame[..., 2]
        return depth, minmax((gray - gaussian_blur(gray, 5)).abs(), 0.0, 1.0)

    def _calibrate_midas(self, md, stereo, sconf):
        reliable = sconf > 0.7
        s10, s90 = percentiles(stereo, (10.0, 90.0), reliable)
        m10, m90 = percentiles(md, (10.0, 90.0), reliable)
        scale = torch.where(m90 - m10 < 1e-6, 1.0, (s90 - s10) / (m90 - m10 + 1e-8))
        robust = md * scale + (s10 - m10 * scale)
        m5, m95 = percentiles(md, (5.0, 95.0))
        s5, s95 = percentiles(stereo, (5.0, 95.0))
        mapped = s5 + (md - m5) / (m95 - m5 + 1e-8) * (s95 - s5)
        minmax_map = torch.where(m95 - m5 < 1e-6, ((s5 + s95) / 2.0).expand_as(md), mapped)
        return torch.where(reliable.sum() >= 100, robust, minmax_map)

    # -- flow depth ---------------------------------------------------------

    def _dense_flow(self, prev, curr):
        f = self.flow
        levels, win, iters = f["flow_levels"], f["flow_win"], f["flow_iters"]
        pyr = [(prev, curr)]
        for _ in range(levels - 1):
            p, c = pyr[-1]
            half = (p.shape[0] // 2, p.shape[1] // 2)
            pyr.append((dm.resize(gaussian_blur(p, 5), half), dm.resize(gaussian_blur(c, 5), half)))
        flow = torch.zeros((*pyr[-1][0].shape, 2), dtype=self.dt, device=prev.device)
        for lvl in range(levels - 1, -1, -1):
            p, c = pyr[lvl]
            if tuple(flow.shape[:2]) != tuple(p.shape):
                flow = torch.stack([dm.resize(flow[..., 0], tuple(p.shape)),
                                    dm.resize(flow[..., 1], tuple(p.shape))], dim=-1) * 2.0
            H, W = p.shape
            gy, gx = gradient(p)
            ys = torch.arange(H, device=p.device)[:, None].to(self.dt)
            xs = torch.arange(W, device=p.device)[None, :].to(self.dt)
            a = box(gx * gx, win) + 1e-3
            b = box(gx * gy, win)
            cc = box(gy * gy, win) + 1e-3
            det = a * cc - b * b
            for _ in range(iters):
                it = bilinear(c, xs + flow[..., 0], ys + flow[..., 1]) - p
                bx, by = box(gx * it, win), box(gy * it, win)
                du = (-(cc * bx - b * by) / det).clamp(-win, win)
                dv = (-(a * by - b * bx) / det).clamp(-win, win)
                flow = flow + torch.stack([du, dv], dim=-1)
        return flow

    @staticmethod
    def _dlt(src, dst):
        """The DLT of dst ≈ H·src (…, N, 2) in Hartley's normalisation
        (each set moved to its mean and scaled to a mean distance of √2):
        the eigenvector of AᵀA of the least eigenvalue, denormalised
        (T_d⁻¹·H·T_s), H[2, 2] = 1; the products are matrix products, as
        the JAX package's ``geometry.homography_dlt`` writes them."""
        def norm(p):
            mean = p.mean(dim=-2, keepdim=True)
            d = torch.sqrt(((p - mean) ** 2).sum(dim=-1, keepdim=True) + 1e-12)
            scale = math.sqrt(2.0) / (d.mean(dim=-2, keepdim=True) + 1e-12)
            s, mx, my = scale[..., 0, 0], mean[..., 0, 0], mean[..., 0, 1]
            one, zero = torch.ones_like(s), torch.zeros_like(s)
            T = torch.stack([torch.stack([s, zero, -s * mx], -1),
                             torch.stack([zero, s, -s * my], -1),
                             torch.stack([zero, zero, one], -1)], -2)
            return (p - mean) * scale, T

        (sn, Ts), (dn, Td) = norm(src), norm(dst)
        return Reference._solve(sn, dn, Ts, Td, None)

    @staticmethod
    def _solve(sn, dn, Ts, Td, w):
        """The normalised DLT's system (its rows scaled by the points'
        weights ``w`` where given), solved and denormalised."""
        x, y, u, v = sn[..., 0], sn[..., 1], dn[..., 0], dn[..., 1]
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
        r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
        if w is not None:
            r1, r2 = r1 * w[..., None], r2 * w[..., None]
        A = torch.cat([r1, r2], dim=-2)
        _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
        h = V[..., :, 0]
        Hm = torch.linalg.inv(Td) @ h.reshape(*h.shape[:-1], 3, 3) @ Ts
        h22 = Hm[..., 2:3, 2:3]
        return Hm / torch.where(h22.abs() < 1e-12, 1e-12, h22)

    @staticmethod
    def _weighted_dlt(src, dst, w):
        """The DLT over (N, 2) with weights ``w`` (…, N) (a batch of weight
        sets fits a homography each): weighted means and scales, each row of
        A scaled by its point's weight."""
        total = w.sum(dim=-1) + 1e-9

        def norm(p):
            mean = (p * w[..., None]).sum(dim=-2) / total[..., None]
            d = torch.sqrt(((p - mean[..., None, :]) ** 2).sum(dim=-1) + 1e-12)
            scale = math.sqrt(2.0) / ((d * w).sum(dim=-1) / total + 1e-12)
            one, zero = torch.ones_like(scale), torch.zeros_like(scale)
            T = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                             torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                             torch.stack([zero, zero, one], -1)], -2)
            return (p - mean[..., None, :]) * scale[..., None, None], T

        (sn, Ts), (dn, Td) = norm(src), norm(dst)
        return Reference._solve(sn, dn, Ts, Td, w)

    @staticmethod
    def _apply(Hm, pts):
        v = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1) @ Hm.transpose(-1, -2)
        return v[..., :2] / torch.where(v[..., 2:3].abs() < 1e-12, 1e-12, v[..., 2:3])

    def _ego(self, flow, generator):
        """RANSAC of the homography p → p + flow on the grid, as the JAX
        package's ``mono.ego`` states it: the hypotheses' 4-point DLTs, the
        first with the most inliers, two weighted refits on the inliers,
        valid with ``min_inliers``, the dense ego-flow.

        Returns the outcomes of the near-ties: every hypothesis whose count is
        within ``tie_points`` of the most, each taken through the refits, as
        (valid, ego-flow, the most that its hypotheses count), the first of the
        most first; an outcome met again is kept once. A 4-point DLT is
        ill-conditioned in float32: another order of its sums moves a
        hypothesis's count by a few points, so which of the near-ties comes
        first is rounding's choice, not the equations'. Their outcomes differ by
        a refit over a few points."""
        f = self.flow
        step, t2 = f["grid_step"], f["ransac_threshold"] ** 2
        H, W = flow.shape[:2]
        gy, gx = torch.meshgrid(torch.arange(step // 2, H, step, device=flow.device),
                                torch.arange(step // 2, W, step, device=flow.device),
                                indexing="ij")
        gy, gx = gy.reshape(-1), gx.reshape(-1)
        src = torch.stack([gx, gy], dim=-1).float()
        dst = src + flow[gy, gx].float()
        idx = torch.randint(0, src.shape[0], (int(self.ransac["hypotheses"]), 4),
                            generator=generator, device=generator.device).to(src.device)
        Hs = self._dlt(src[idx], dst[idx])
        inl = ((self._apply(Hs, src[None].expand(idx.shape[0], -1, -1)) - dst[None]) ** 2
               ).sum(dim=-1) < t2
        counts = inl.sum(dim=-1)
        best = int(counts.argmax())
        near = (counts >= counts[best] - self.tie_points).nonzero().reshape(-1).tolist()
        near = [best] + [i for i in near if i != best]
        Hm, mask = Hs[near], inl[near]
        for _ in range(int(self.ransac["refits"])):
            Hm = self._weighted_dlt(src, dst, mask.float())
            mask = ((self._apply(Hm, src[None]) - dst[None]) ** 2).sum(dim=-1) < t2
        valid = mask.sum(dim=-1) >= f["min_inliers"]
        yy, xx = torch.meshgrid(torch.arange(H, device=flow.device, dtype=torch.float32),
                                torch.arange(W, device=flow.device, dtype=torch.float32),
                                indexing="ij")
        coords = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
        out = []
        for j, i in enumerate(near):
            same = next((o for o in out if torch.equal(o[0], Hm[j])), None)
            if same is not None:
                same[3] = max(same[3], int(counts[i]))
                continue
            out.append([Hm[j], valid[j], None, int(counts[i])])
        for o in out:
            warped = self._apply(o[0], coords).reshape(H, W, 2)
            o[2] = torch.where(o[1], warped - coords.reshape(H, W, 2), 0.0).to(self.dt)
        return [(valid_j, ego, count) for _, valid_j, ego, count in out]

    def _flow_depth(self, s, gray, t, follow=None):
        """The motion depth's step from the flow state ``s``: the flow, the
        ego-motion, the EMA, the bilateral, the next flow state. Of RANSAC's
        near-ties (:meth:`_ego`) the one whose next EMA depth and flags lie
        nearest ``follow`` (the program's next state) is taken, the first of
        the most where none is given; ``self.ties`` records the frame's
        count of near-ties, the taken one's count short of the most and
        whether it is another than the first of the most."""
        f, dt = self.flow, self.dt
        g = torch.Generator(device=self.device)
        g.set_state(s["rng_state"])
        if "rng_ahead" in self.faults:
            torch.randint(0, 2, (1,), generator=g, device=g.device)
        prev, stable_old = s["prev_gray"].to(dt), s["stable_depth"].to(dt)
        flow = self._dense_flow(prev, gray)
        moving_before = (t - s["last_move_time"]) < f["motion_timeout"]
        a_moving = f["alpha_moving"] + (0.01 if "alpha" in self.faults else 0.0)
        t32 = torch.full((), t, dtype=torch.float32, device=self.device)

        def outcome(ego_valid, expected):
            ego = ego_valid & s["has_prev"]
            current = 1.0 / (torch.hypot(flow[..., 0] - expected[..., 0],
                                         flow[..., 1] - expected[..., 1]) + 0.5)
            moving = ego | moving_before
            alpha = torch.where(moving, a_moving, f["alpha_static"]).to(dt)
            stable = torch.where(s["has_stable"], alpha * stable_old + (1 - alpha) * current,
                                 current)
            nxt = {"stable_depth": torch.where(ego, stable, stable_old),
                   "has_stable": s["has_stable"] | ego,
                   "last_move_time": torch.where(ego, t32, s["last_move_time"])}
            return ego, current, moving, nxt

        outcomes = self._ego(flow, g)
        taken = 0
        if follow is not None and len(outcomes) > 1:
            scale = max(float(follow["stable_depth"].float().abs().max()), 1e-12)

            def distance(o):
                nxt = outcome(o[0], o[1])[3]
                flags = any(not torch.equal(nxt[k].cpu(), follow[k].cpu())
                            for k in ("has_stable", "last_move_time"))
                gap = float((nxt["stable_depth"].float() - follow["stable_depth"].float()
                             ).abs().max()) / scale
                return (flags, gap)

            taken = min(range(len(outcomes)), key=lambda j: distance(outcomes[j]))
        most = outcomes[0][2]
        self.ties.append({"near": len(outcomes), "short": most - outcomes[taken][2],
                          "other": taken != 0})
        ego, current, moving, nxt = outcome(*outcomes[taken][:2])
        depth = bilateral(torch.where(ego, current, stable_old), 9, 75.0, 75.0)
        has_depth = ego | (moving & s["has_stable"])
        nxt.update(prev_gray=gray, has_prev=torch.ones((), dtype=torch.bool, device=self.device),
                   rng_state=g.get_state())
        return nxt, depth, has_depth, moving

    @staticmethod
    def _to_range(d, ref):
        lo, hi = percentiles(d, (5.0, 95.0))
        norm = 255.0 - ((d - lo) / (hi - lo + 1e-8)).clamp(0.0, 1.0) * 255.0
        s5, s95 = percentiles(ref, (5.0, 95.0))
        return s5 + norm / 255.0 * (s95 - s5)

    # -- fusion -------------------------------------------------------------

    def _fuse(self, stereo, sconf, midas, mconf, flow, moving):
        q, dt = self.fusion, self.dt
        like = next(x for x in (stereo, midas, flow) if x is not None)
        flow_ok = moving if flow is not None else torch.zeros((), dtype=torch.bool,
                                                              device=self.device)

        def flow_fill(fused, conf, floor):
            holes = ((fused < q["flow_hole_threshold"]) | (fused == 0)) & flow_ok
            fw = q["flow_fill_weight"]
            fused = torch.where(holes, fused * (1 - fw) + flow * fw, fused)
            return fused, torch.where(holes, conf.clamp(min=floor), conf)

        if stereo is not None:
            fused, conf, mode = stereo * q["stereo_weight"], sconf, 1
            if midas is not None and q["use_midas_fill"]:
                fill = gaussian_blur((1.0 - conf) * q["midas_fill_weight"],
                                     q["midas_blend_radius"]).clamp(0.0, 1.0)
                mask = (conf < q["stereo_conf_threshold"]) & (fill > 0.1)
                fused = torch.where(mask, fused * (1 - fill) + midas * fill, fused)
                conf = torch.where(mask, conf.clamp(min=0.8), conf)
            if flow is not None and q["use_flow_fill"]:
                fused, conf = flow_fill(fused, conf, 0.6)
            mode = torch.full((), mode, dtype=torch.int32, device=self.device)
        elif midas is not None:
            fused, conf = midas, mconf
            mode = torch.full((), 2, dtype=torch.int32, device=self.device)
            if flow is not None and q["use_flow_fill"]:
                fused, conf = flow_fill(fused, conf, 0.7)
        else:
            fused = torch.where(flow_ok, flow, 0.0)
            conf = torch.full(like.shape, 0.7, dtype=dt, device=self.device)
            mode = torch.where(flow_ok, 3, 0).to(torch.int32)
        smooth = bilateral(fused, q["bilateral_d"], q["bilateral_sigma"], q["bilateral_sigma"])
        fused = torch.where(fused.max() > 10.0, smooth, fused)
        return fused.clamp(0.0, 255.0), conf, mode

    # -- one frame ------------------------------------------------------------

    @torch.no_grad()
    def step(self, state: dict, left_u8, right_u8, follow=None):
        """One frame from ``state``: ((fused, confidence, metres, mode,
        camera moving), the next state). ``follow``, the program's state
        after the frame, only chooses among RANSAC's near-ties
        (:meth:`_flow_depth`)."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            return self._frame(state, left_u8, right_u8, follow)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def _frame(self, state, left_u8, right_u8, follow):
        dt, dev = self.dt, self.device
        hyst, frame = tuple(state["hysteresis"]), int(state["frame"])
        if frame % self.occ["checked_every"] == 0 and state["pending_scores"] is not None:
            ls, rs = (float(v) for v in state["pending_scores"].float().cpu())
            hyst = self._hysteresis(hyst, self._classify(ls, rs))
        frame += 1
        occluded = hyst[0]
        t = float(np.float32(int(state["clock"]) / self.fps))

        w, h = self.size
        mx1, my1, mx2, my2 = self.maps
        left = torch.as_tensor(left_u8, device=dev).to(dt)
        right = torch.as_tensor(right_u8, device=dev).to(dt)
        lr = dm.remap(dm.resize(left, (h, w)), mx1, my1)
        rr = dm.remap(dm.resize(right, (h, w)), mx2, my2)
        scores = self._scores(lr, rr)
        stereo = sconf = None
        if self.use["stereo"] and occluded == "none":
            stereo, sconf = self._stereo(lr, rr)
        midas = mconf = None
        if self.use["midas"]:
            md, mconf = self._midas(lr)
            midas = self._calibrate_midas(md, stereo, sconf) if stereo is not None else md
        flow = None
        moving = torch.zeros((), dtype=torch.bool, device=dev)
        nxt = {}
        if self.use["flow"]:
            src = rr if (occluded == "left") != ("flow_right" in self.faults) else lr
            nxt, fd, has, mv = self._flow_depth(state, src, t, follow)
            flow = self._to_range(fd, stereo if stereo is not None else fd)
            moving = mv & has
        fused, conf, mode = self._fuse(stereo, sconf, midas, mconf, flow, moving)
        meters = (self.focal * (self.baseline_cm / 100.0) / (fused / 255.0 * self.p.num_disparities
                                                             + 1e-6)).clamp(0.05, 30.0)
        pending = state["pending_scores"]
        if frame % self.occ["checked_every"] == 1:
            pending = torch.stack(scores).float()
        nxt.update(hysteresis=hyst, pending_scores=pending, frame=frame,
                   clock=int(state["clock"]) + 1)
        return (fused, conf, meters, mode, moving), nxt


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

NAMES = ("fused_off", "conf_off", "meters_off", "state_err")
FLAGS = ("has_prev", "has_stable", "last_move_time")


def state_error(got: dict, want: dict) -> float:
    """The largest gap of two states (see the module's notes)."""
    def gap(a, b, scale=1.0):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max()) / scale

    errs = []
    for key in ("hysteresis", "frame", "clock"):
        errs.append(float(tuple(got[key]) != tuple(want[key]) if key == "hysteresis"
                          else got[key] != want[key]))
    a, b = got["pending_scores"], want["pending_scores"]
    errs.append(float(a is not b) if a is None or b is None else gap(a, b))
    if "prev_gray" in want:
        errs.append(gap(got["prev_gray"], want["prev_gray"], 255.0))
        ref = float(want["stable_depth"].float().abs().max())
        errs.append(gap(got["stable_depth"], want["stable_depth"], max(ref, 1e-12)))
        errs += [float(not torch.equal(got[k].cpu(), want[k].cpu())) for k in FLAGS]
        errs.append(float(not torch.equal(got["rng_state"].cpu(), want["rng_state"].cpu())))
    return max(errs)


def numbers(got, want, limits: dict, got_next=None, want_next=None) -> dict:
    """``got`` and ``want``: a frame's (fused, confidence, metres, mode,
    camera moving) as arrays; ``got_next``, ``want_next``: the states after
    it."""
    gf, gc, gm, gmode, gmov = (np.asarray(a, np.float64) for a in got)
    rf, rc, rm, rmode, rmov = (np.asarray(a, np.float64) for a in want)
    n = gf.size
    inside = (gm > 0.05) & (gm < 30.0) & (rm > 0.05) & (rm < 30.0)
    meters_bad = inside & ~(np.abs(gm - rm) <= limits["meters_rtol"] * np.abs(rm))
    fused_bad = np.count_nonzero(~(np.abs(gf - rf) <= limits["fused_tol"])) / n
    return {
        "fused_off": 1.0 if gmode != rmode or bool(gmov) != bool(rmov) else float(fused_bad),
        "conf_off": float(np.count_nonzero(~(np.abs(gc - rc) <= limits["conf_tol"])) / n),
        "meters_off": float(np.count_nonzero(meters_bad) / n),
        "state_err": state_error(got_next, want_next) if want_next is not None else 0.0,
    }


def gaps(got, want) -> dict:
    """The largest gaps of a frame's maps, the numbers the tolerances bound:
    the fused map's and the confidence's |got − want|, the metres' relative
    one over the pixels inside the clamp in both."""
    gf, gc, gm = (np.asarray(a, np.float64) for a in got[:3])
    rf, rc, rm = (np.asarray(a, np.float64) for a in want[:3])
    inside = (gm > 0.05) & (gm < 30.0) & (rm > 0.05) & (rm < 30.0)
    rel = np.abs(gm - rm)[inside] / rm[inside]
    return {"fused": float(np.abs(gf - rf).max()), "conf": float(np.abs(gc - rc).max()),
            "meters_rel": float(rel.max()) if rel.size else 0.0}


def notes(ref: Reference) -> list[str]:
    """A line on RANSAC's near-ties over the frames ``ref`` computed: in
    how many the program's outcome was another than the reference's own
    first of the most, how many near-ties there were, and how far the
    taken one's count fell short of the most."""
    if not ref.ties:
        return []
    other = sum(t["other"] for t in ref.ties)
    return [f"ransac: {other} of {len(ref.ties)} frames took another near-tie than the "
            f"reference's first; near-ties {[t['near'] for t in ref.ties]}, short by "
            f"{[t['short'] for t in ref.ties]} inliers (within {ref.tie_points})"]


def start_numbers(got: dict, want: dict, limits: dict) -> dict:
    """The state before the first frame against the reference's initial
    state, as a frame whose outputs agree."""
    return dict({k: 0.0 for k in NAMES}, state_err=state_error(got, want))
