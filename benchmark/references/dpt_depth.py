"""The plain reference of the mono-depth path with DPT-Large: the
pre-processing, the network and the post-processing of
``mono.nn.estimate_depth``, in plain float32 PyTorch.

It is written again here from the paper (Ranftl, Bochkovskiy and Koltun,
"Vision Transformers for Dense Prediction", arXiv:2103.13413) and the
MiDaS hub's layers (``DPT_Large``: ``DPTDepthModel(backbone="vitl16_384",
non_negative=True)``, ``readout="project"``), as functions of a state_dict
in the hub's names, and imports nothing of the program:

- the ViT-L/16 encoder: a 16×16 patch convolution, the cls token, the
  position embedding resized bilinearly from its 24×24 grid (the hub's
  ``_resize_pos_embed``), pre-norm blocks (LayerNorm eps 1e-6; q·kᵀ, the
  scale, softmax over the keys, ·v; an MLP with exact GELU), the tokens
  tapped after the blocks the configuration's ``hooks`` name;
- per tap the "project" readout ([patch tokens, cls token] → Linear 2C→C →
  GELU), the token grid, a 1×1 convolution and the resampling (4×4/4 and
  2×2/2 transposed convolutions, identity, a 3×3/2 convolution), then the
  3×3 ``layerN_rn`` convolution to the features;
- four fusion blocks (residual conv units, bilinear 2× upsampling with
  aligned corners, a 1×1 convolution) and the non-negative head.

Departures from the hub, each the program's contract rather than the
hub's (the configuration's ``assumed``): the input and the output are
resized linearly with half-pixel centres (the hub's transform resizes
bicubically), the depth is min-max normalised to [0, 255], and the
confidence is the min-max normalised |gray − GaussianBlur(gray, 5)| with
replicated borders. The resizes and the blur here are products with a
weight matrix per axis; the program's are chains of multiply-adds.

The weights are drawn from the configuration's ``weights_seed`` in the
hub state_dict's names and shapes (:func:`manifest`, :func:`weights`):
each convolution's and linear layer's weight normal with std 1/√fan_in
(PyTorch's default draws would make a random DPT-Large return zeros), the
cls token and the position embedding with std 0.02, biases with std 0.02,
LayerNorms at 1 and 0 plus draws of std 0.02, the head's last weights
non-negative. The system under test loads
the same tensors through its hub-checkpoint path.

``dtype`` is the precision of the network's products: float32, as the
configuration states, with TF32 off; ``"tf32"``, float32 with both TF32
flags on (the comparison's control on a card); or a lower floating type
(bfloat16), the network's weights and activations in it.

    ref = Reference(config, device="cuda")
    depth_norm, conf = ref(frame_bgr_u8)

The comparison that decides ``correct`` is here too (:func:`numbers`), two
numbers a frame, the worst frame's compared with its limit
(``limits/<config>.json``): ``depth_err``, the largest |got − want| of the
normalised depth over 255 (1 where the reference's map is constant: a dead
network proves nothing), and ``conf_err``, the largest |got − want| of the
confidence.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NAMES = ("depth_err", "conf_err")
WORST = 1.0  # each number's reading where the frame cannot be compared

_LAST = "scratch.output_conv.4.weight"  # drawn non-negative (see weights)
_TRANSPOSED = ("pretrained.act_postprocess1.4.weight", "pretrained.act_postprocess2.4.weight")
_GAUSS5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # cv2's 5-tap kernel for sigma 0
_LUMA_BGR = (0.114, 0.587, 0.299)


# ---------------------------------------------------------------------------
# The hub's names and shapes, and the seeded weights
# ---------------------------------------------------------------------------


def manifest(dpt: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The hub DPT checkpoint's (name, shape) pairs in its order, for the
    widths ``dpt`` (a configuration's ``dpt``): the timm ViT (its ``norm``
    and ``head`` are in the checkpoint though the forward never computes
    them), the four ``act_postprocess`` stacks, then the scratch. Conv
    weights are (out, in, kh, kw), transposed ones (in, out, kh, kw),
    linear ones (out, in)."""
    C, P, f = dpt["embed_dim"], dpt["patch_size"], dpt["features"]
    hidden, post = dpt["mlp_ratio"] * C, dpt["post_channels"]
    gs = dpt["img_size"] // P
    vit = "pretrained.model."
    out = [(vit + "cls_token", (1, 1, C)), (vit + "pos_embed", (1, 1 + gs * gs, C)),
           (vit + "patch_embed.proj.weight", (C, 3, P, P)), (vit + "patch_embed.proj.bias", (C,))]
    for i in range(dpt["depth"]):
        b = f"{vit}blocks.{i}."
        out += [(b + "norm1.weight", (C,)), (b + "norm1.bias", (C,)),
                (b + "attn.qkv.weight", (3 * C, C)), (b + "attn.qkv.bias", (3 * C,)),
                (b + "attn.proj.weight", (C, C)), (b + "attn.proj.bias", (C,)),
                (b + "norm2.weight", (C,)), (b + "norm2.bias", (C,)),
                (b + "mlp.fc1.weight", (hidden, C)), (b + "mlp.fc1.bias", (hidden,)),
                (b + "mlp.fc2.weight", (C, hidden)), (b + "mlp.fc2.bias", (C,))]
    out += [(vit + "norm.weight", (C,)), (vit + "norm.bias", (C,)),
            (vit + "head.weight", (dpt["num_classes"], C)), (vit + "head.bias", (dpt["num_classes"],))]
    resample = {0: (4, 4), 1: (2, 2), 3: (3, 3)}  # tap 2 is an identity
    for k, o in enumerate(post):
        a = f"pretrained.act_postprocess{k + 1}."
        out += [(a + "0.project.0.weight", (C, 2 * C)), (a + "0.project.0.bias", (C,)),
                (a + "3.weight", (o, C, 1, 1)), (a + "3.bias", (o,))]
        if k in resample:
            out += [(a + "4.weight", (o, o, *resample[k])), (a + "4.bias", (o,))]
    out += [(f"scratch.layer{k + 1}_rn.weight", (f, o, 3, 3)) for k, o in enumerate(post)]
    for k in (1, 2, 3, 4):
        r = f"scratch.refinenet{k}."
        out += [(r + "out_conv.weight", (f, f, 1, 1)), (r + "out_conv.bias", (f,))]
        for unit in (1, 2):
            for conv in (1, 2):
                u = f"{r}resConfUnit{unit}.conv{conv}."
                out += [(u + "weight", (f, f, 3, 3)), (u + "bias", (f,))]
    h = "scratch.output_conv."
    out += [(h + "0.weight", (f // 2, f, 3, 3)), (h + "0.bias", (f // 2,)),
            (h + "2.weight", (32, f // 2, 3, 3)), (h + "2.bias", (32,)),
            (h + "4.weight", (1, 32, 1, 1)), (h + "4.bias", (1,))]
    return out


def weights(config: dict, device) -> dict[str, torch.Tensor]:
    """The seeded float32 state_dict of ``config`` on ``device``, drawn in
    :func:`manifest`'s order from one generator seeded with
    ``weights_seed`` (the same seed and device give the same tensors).

    The head's last 1×1 convolution, which sums 32 rectified features into
    the depth before the final ReLU, is drawn non-negative (the magnitudes
    of its normal draws): with signed draws its output is negative over
    whole maps often enough that the final ReLU leaves a constant map, a
    dead network that would prove nothing."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(config["weights_seed"]))
    out = {}
    for name, shape in manifest(config["dpt"]):
        w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        leaf = name.rsplit(".", 2)[-2]
        if len(shape) >= 2 and not name.endswith(("cls_token", "pos_embed")):
            fan_in = shape[0] if name in _TRANSPOSED else math.prod(shape[1:])
            w *= fan_in ** -0.5
            if name == _LAST:
                w = w.abs()
        elif leaf.startswith("norm") and name.endswith(".weight"):
            w = 1.0 + 0.02 * w
        else:
            w *= 0.02
        out[name] = w
    return out


# ---------------------------------------------------------------------------
# Pre- and post-processing
# ---------------------------------------------------------------------------


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of a linear resize with half-pixel centres and
    no antialiasing: the triangle of width one input pixel at each output
    sample, each row divided by its sum, zero where the sample leaves
    [−0.5, n_in − 0.5]. Computed in float64, returned float32."""
    f64 = torch.float64
    sample = (torch.arange(n_out, dtype=f64) + 0.5) * (n_in / n_out) - 0.5
    w = (1.0 - (sample[:, None] - torch.arange(n_in, dtype=f64)[None, :]).abs()).clamp(min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total > 0, w / torch.where(total > 0, total, 1.0), 0.0)
    w[(sample < -0.5) | (sample > n_in - 0.5)] = 0.0
    return w.to(torch.float32).to(device)


def resize(img: torch.Tensor, hw) -> torch.Tensor:
    """Linear resize of (h, w[, c]) float32 to (H, W[, c])."""
    Mh = _resize_matrix(img.shape[0], hw[0], img.device)
    Mw = _resize_matrix(img.shape[1], hw[1], img.device)
    if img.ndim == 2:
        return Mh @ img @ Mw.T
    return torch.einsum("Hh,hwc,Ww->HWc", Mh, img, Mw)


def minmax(img: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """(img − min) / (max − min) · (hi − lo) + lo; a constant map gives lo."""
    mn, mx = img.min(), img.max()
    rng = mx - mn
    return (img - mn) / torch.where(rng < 1e-12, 1.0, rng) * (hi - lo) + lo


def _blur_matrix(n: int, device) -> torch.Tensor:
    """(n, n) weights of cv2's 5-tap Gaussian of sigma 0 ([1 4 6 4 1]/16)
    along an axis of n pixels, the borders replicated (a tap that falls
    outside lands on the edge pixel)."""
    w = torch.zeros(n, n, dtype=torch.float64)
    rows = torch.arange(n)
    for tap, weight in enumerate(_GAUSS5):
        w.index_put_((rows, (rows + tap - 2).clamp(0, n - 1)), torch.tensor(weight, dtype=torch.float64),
                     accumulate=True)
    return w.to(torch.float32).to(device)


def blur5(gray: torch.Tensor) -> torch.Tensor:
    """The 5×5 Gaussian of sigma 0 on (H, W): a product with a weight
    matrix per axis."""
    return _blur_matrix(gray.shape[0], gray.device) @ gray @ _blur_matrix(gray.shape[1],
                                                                          gray.device).T


def confidence(frame: torch.Tensor) -> torch.Tensor:
    b, g, r = frame.unbind(-1)
    gray = _LUMA_BGR[0] * b + _LUMA_BGR[1] * g + _LUMA_BGR[2] * r
    return minmax((gray - blur5(gray)).abs(), 0.0, 1.0)


# ---------------------------------------------------------------------------
# DPT-Large
# ---------------------------------------------------------------------------


def _linear(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _conv(p, name, x, stride=1, padding=0):
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"), stride=stride, padding=padding)


def _norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps=1e-6)


def encoder(p, dpt: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """(1, 3, H, W) normalised image → the tokens after each hooked block,
    each (1, 1 + gh·gw, C)."""
    vit = "pretrained.model."
    tokens = _conv(p, vit + "patch_embed.proj", x, stride=dpt["patch_size"])
    B, C, gh, gw = tokens.shape
    tokens = tokens.flatten(2).transpose(1, 2)
    pos = p[vit + "pos_embed"]
    gs = dpt["img_size"] // dpt["patch_size"]
    grid = pos[0, 1:].reshape(1, gs, gs, C).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
    pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, C)], dim=1)
    h = torch.cat([p[vit + "cls_token"].expand(B, -1, -1), tokens], dim=1) + pos
    heads = dpt["num_heads"]
    hd = C // heads
    taps = []
    for i in range(dpt["depth"]):
        b = f"{vit}blocks.{i}."
        N = h.shape[1]
        qkv = _linear(p, b + "attn.qkv", _norm(p, b + "norm1", h))
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        h = h + _linear(p, b + "attn.proj", (att @ v).transpose(1, 2).reshape(B, N, C))
        mlp = F.gelu(_linear(p, b + "mlp.fc1", _norm(p, b + "norm2", h)), approximate="none")
        h = h + _linear(p, b + "mlp.fc2", mlp)
        if i in dpt["hooks"]:
            taps.append(h)
    return taps


def reassemble(p, dpt: dict, taps, grid_hw) -> list[torch.Tensor]:
    """Each tap → the readout, the token grid, the 1×1 convolution, the
    resampling and the ``layerN_rn`` convolution to the features."""
    out = []
    for k, h in enumerate(taps):
        a = f"pretrained.act_postprocess{k + 1}."
        patches = h[:, 1:]
        read = torch.cat([patches, h[:, :1].expand_as(patches)], dim=-1)
        x = F.gelu(_linear(p, a + "0.project.0", read), approximate="none")
        x = x.transpose(1, 2).reshape(x.shape[0], x.shape[2], *grid_hw)
        x = _conv(p, a + "3", x)
        if k == 0:
            x = F.conv_transpose2d(x, p[a + "4.weight"], p[a + "4.bias"], stride=4)
        elif k == 1:
            x = F.conv_transpose2d(x, p[a + "4.weight"], p[a + "4.bias"], stride=2)
        elif k == 3:
            x = _conv(p, a + "4", x, stride=2, padding=1)
        out.append(_conv(p, f"scratch.layer{k + 1}_rn", x, padding=1))
    return out


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def _unit(p, name, x):
    """A residual conv unit: x + conv2(relu(conv1(relu(x))))."""
    y = _conv(p, name + ".conv1", F.relu(x), padding=1)
    return x + _conv(p, name + ".conv2", F.relu(y), padding=1)


def _fusion(p, k, x, skip=None):
    r = f"scratch.refinenet{k}"
    if skip is not None:
        x = x + _unit(p, r + ".resConfUnit1", skip)
    return _conv(p, r + ".out_conv", _up2(_unit(p, r + ".resConfUnit2", x)))


def decoder(p, layers) -> torch.Tensor:
    """The four fusion blocks and the non-negative head → (1, H, W)."""
    path = _fusion(p, 4, layers[3])
    path = _fusion(p, 3, path, layers[2])
    path = _fusion(p, 2, path, layers[1])
    path = _fusion(p, 1, path, layers[0])
    h = "scratch.output_conv."
    x = _up2(_conv(p, h + "0", path, padding=1))
    x = F.relu(_conv(p, h + "2", x, padding=1))
    return F.relu(_conv(p, h + "4", x))[:, 0]


def dpt_forward(p, dpt: dict, rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] → (H, W) relative inverse depth; H and W
    multiples of twice the patch."""
    P = dpt["patch_size"]
    x = ((rgb - 0.5) / 0.5).permute(2, 0, 1)[None]
    grid_hw = (rgb.shape[0] // P, rgb.shape[1] // P)
    return decoder(p, reassemble(p, dpt, encoder(p, dpt, x), grid_hw))[0]


@contextlib.contextmanager
def _tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """``estimate_depth`` of a configuration's network, plainly, on
    ``device``: ``(frame_bgr,)`` → (depth_norm, conf)."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dpt, self.net_hw = config["dpt"], tuple(config["net_hw"])
        self.tf32 = dtype == "tf32"
        self.dtype = torch.float32 if self.tf32 else dtype
        self.p = {k: v.to(self.dtype) for k, v in weights(config, self.device).items()}

    @torch.no_grad()
    def __call__(self, frame_bgr):
        frame = torch.as_tensor(np.ascontiguousarray(frame_bgr), device=self.device)
        frame = frame.to(torch.float32)
        with _tf32(self.tf32):
            rgb = resize(frame.flip(-1) / 255.0, self.net_hw)
            pred = dpt_forward(self.p, self.dpt, rgb.to(self.dtype)).to(torch.float32)
            depth = minmax(resize(pred, frame.shape[:2]), 0.0, 255.0)
            conf = confidence(frame)
        return depth, conf


def _largest_gap(got, want):
    if got.shape != want.shape or not np.isfinite(got).all():
        return None
    return float(np.abs(got.astype(np.float64) - want).max())


def numbers(got, want, limits: dict) -> dict:
    """One frame's ``depth_err`` and ``conf_err`` (see the module's
    docstring); ``WORST`` for a map of another shape or one not finite."""
    (gd, gc), (wd, wc) = got, want
    depth, conf = _largest_gap(gd, wd), _largest_gap(gc, wc)
    flat = float(wd.max() - wd.min()) < 1.0  # the reference's map is constant
    return {"depth_err": WORST if depth is None or flat else min(WORST, depth / 255.0),
            "conf_err": WORST if conf is None else min(WORST, conf)}
