"""MiDaS v2.1 small, the exact torch-hub architecture, as a ``torch.nn.Module``.

Counterpart of ``stereovision_tpu/models/midas_v21.py``: the
``torch.hub.load("intel-isl/MiDaS", "MiDaS_small")`` network, an
EfficientNet-Lite3 encoder (gen-efficientnet ``tf_efficientnet_lite3``:
width 1.2, depth 1.4, no squeeze-excitation, ReLU6, TF-SAME padding, batch
norms with eps 1e-3) tapped at strides 4/8/16/32, and the MidasNet_small
RefineNet decoder (64 features, ``expand=True``: scratch channels
64/128/256/512; bilinear align-corners 2× upsampling; a non-negative head).

The submodules carry the hub checkpoint's names, so ``state_dict()`` has its
keys, in its order, with its shapes (:func:`expected_manifest`), and a hub
checkpoint loads by ``load_state_dict(strict=True)``
(:func:`load_hub_state_dict`) once :func:`validate_state_dict` has named any
difference. ``convert.midas_v21_from_flax`` carries the
JAX package's variables across.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stereovision_tpu_torch.models.midas import SameConv

# EfficientNet-Lite3 stages: (n_blocks, kernel, first_stride, expand_ratio,
# in_ch, out_ch); stage 0 is the depthwise-separable block
LITE3_STAGES = (
    (1, 3, 1, 1, 32, 24),
    (3, 3, 2, 6, 24, 32),
    (3, 5, 2, 6, 32, 48),
    (5, 3, 2, 6, 48, 96),
    (5, 5, 1, 6, 96, 136),
    (6, 5, 2, 6, 136, 232),
    (1, 3, 1, 6, 232, 384),
)
# layer1 = stem + stages 0-1, layer2 = stage 2, layer3 = stages 3-4,
# layer4 = stages 5-6: taps at 32/48/136/384 channels, strides 4/8/16/32
LAYER_STAGES = ((0, 1), (2,), (3, 4), (5, 6))
FEATURES = 64
RN_IN = (32, 48, 136, 384)
RN_OUT = (FEATURES, FEATURES * 2, FEATURES * 4, FEATURES * 8)
BN_EPS = 1e-3  # the tf_ variants' batch-norm epsilon


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class _DepthwiseSeparable(nn.Module):
    """gen-efficientnet ``DepthwiseSeparableConv`` (lite: no SE, no
    activation after the pointwise conv)."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv_dw = SameConv(cin, cin, k, stride=stride, groups=cin, bias=False)
        self.bn1 = _bn(cin)
        self.conv_pw = SameConv(cin, cout, 1, bias=False)
        self.bn2 = _bn(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        return x + h if self.residual else h


class _InvertedResidual(nn.Module):
    """gen-efficientnet ``InvertedResidual`` (lite: no SE, ReLU6)."""

    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_pw = SameConv(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = SameConv(mid, mid, k, stride=stride, groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.conv_pwl = SameConv(mid, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_pw(x)))
        h = F.relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return x + h if self.residual else h


def _stage(n, k, stride, expand, cin, cout) -> nn.Sequential:
    blocks = []
    for b in range(n):
        ci, st = (cin, stride) if b == 0 else (cout, 1)
        blocks.append(_DepthwiseSeparable(ci, cout, k, st) if expand == 1
                      else _InvertedResidual(ci, cout, k, st, expand))
    return nn.Sequential(*blocks)


class ResidualConvUnit(nn.Module):
    """MiDaS ``ResidualConvUnit_custom`` (bn=False): x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Upsample2x(nn.Module):
    """Bilinear 2× upsampling with align_corners=True (a lerp: no product
    that TF32 could round); a single row or column is copied."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class FeatureFusion(nn.Module):
    """MiDaS ``FeatureFusionBlock_custom`` (bn=False, align_corners=True).
    ``resConfUnit1`` is registered on every block, as the hub does, but a
    block given no skip input (refinenet4) never calls it."""

    def __init__(self, f: int, out_f: int):
        super().__init__()
        self.out_conv = nn.Conv2d(f, out_f, 1)
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.up = Upsample2x()

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(self.up(self.resConfUnit2(x)))


def output_head(f: int) -> nn.Sequential:
    """The hub's non-negative head: conv3×3 f→f/2, 2× upsampling, conv3×3
    →32, ReLU, conv1×1 →1, ReLU, Identity (parameters at 0, 2 and 4)."""
    return nn.Sequential(nn.Conv2d(f, f // 2, 3, padding=1), Upsample2x(),
                         nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(32, 1, 1), nn.ReLU(), nn.Identity())


class MidasV21Small(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] → (B, H, W) non-negative relative inverse
    depth. The hub transform's ImageNet normalization is applied here. H
    and W must be multiples of 32."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]), persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]), persistent=False)
        stages = [_stage(*s) for s in LITE3_STAGES]
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            SameConv(3, 32, 3, stride=2, bias=False), _bn(32), nn.ReLU6(), stages[0], stages[1])
        for li, idx in enumerate(LAYER_STAGES[1:], start=2):
            setattr(self.pretrained, f"layer{li}", nn.Sequential(*(stages[s] for s in idx)))
        self.scratch = nn.Module()
        for i in range(4):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(RN_IN[i], RN_OUT[i], 3, padding=1, bias=False))
        for i in (4, 3, 2, 1):  # MidasNet_small's registration order
            f = RN_OUT[i - 1]
            setattr(self.scratch, f"refinenet{i}", FeatureFusion(f, f // 2 if i > 1 else f))
        self.scratch.output_conv = output_head(FEATURES)

    def forward(self, x):
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"MidasV21Small takes H and W multiples of 32, got {tuple(x.shape[1:3])}")
        h = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        p, s = self.pretrained, self.scratch
        layers = []
        for block in (p.layer1, p.layer2, p.layer3, p.layer4):
            h = block(h)
            layers.append(h)
        rn = [getattr(s, f"layer{i + 1}_rn")(layers[i]) for i in range(4)]
        path = s.refinenet4(rn[3])
        path = s.refinenet3(path, rn[2])
        path = s.refinenet2(path, rn[1])
        path = s.refinenet1(path, rn[0])
        return s.output_conv(path)[:, 0]


def manifest_of(make) -> tuple:
    """The ordered (state_dict key, shape) pairs of the module ``make()``
    builds, built on the ``meta`` device (no weight memory);
    ``num_batches_tracked`` left out."""
    with torch.device("meta"):
        module = make()
    return tuple((k, tuple(v.shape)) for k, v in module.state_dict().items()
                 if not k.endswith("num_batches_tracked"))


@functools.lru_cache(maxsize=None)
def expected_manifest() -> tuple:
    """Ordered (key, shape) pairs of the hub MiDaS_small checkpoint (conv
    weights OIHW); ``num_batches_tracked`` left out."""
    return manifest_of(MidasV21Small)


def check_state_dict(state_dict, want, what: str) -> None:
    """Raise ``ValueError`` naming the missing keys, unexpected keys and
    shape mismatches (up to 8 of each) of ``state_dict`` (tensors or
    arrays) against the manifest ``want``; ``num_batches_tracked`` is
    ignored. The same keys in another order pass: the load is by name."""
    got = [(k, tuple(v.shape)) for k, v in state_dict.items()
           if not k.endswith("num_batches_tracked")]
    if got == list(want):
        return
    got_d, want_d = dict(got), dict(want)
    missing = [k for k, _ in want if k not in got_d]
    extra = [k for k, _ in got if k not in want_d]
    badshape = [f"{k}: got {got_d[k]} want {want_d[k]}"
                for k in want_d if k in got_d and got_d[k] != want_d[k]]
    msgs = []
    if missing:
        msgs.append(f"missing keys ({len(missing)}): {missing[:8]}")
    if extra:
        msgs.append(f"unexpected keys ({len(extra)}): {extra[:8]}")
    if badshape:
        msgs.append(f"shape mismatches ({len(badshape)}): {badshape[:8]}")
    if msgs:
        raise ValueError(f"state_dict does not match {what}: " + "; ".join(msgs))


def validate_state_dict(state_dict) -> None:
    """Check a hub-format state_dict against :func:`expected_manifest`."""
    check_state_dict(state_dict, expected_manifest(), "MiDaS_small v2.1")


def load_hub_state_dict(model: nn.Module, state_dict) -> nn.Module:
    """``model.load_state_dict(strict=True)`` of a hub-format state_dict
    (tensors or numpy arrays) that its architecture's
    ``validate_state_dict`` passed, as tensors of the model's dtypes; batch
    norms' ``num_batches_tracked`` are filled in where absent."""
    want = model.state_dict()
    sd = {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(want[k].dtype)
          for k, v in state_dict.items() if k in want}
    for k, v in want.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v)
    model.load_state_dict(sd, strict=True)
    return model


def seeded(make, seed: int) -> nn.Module:
    """``make()`` built on the CPU under a generator seeded with ``seed``
    (the global generator is left as it was), then the weight of every
    convolution, transposed convolution and linear layer drawn normal with
    std 1/√fan_in (flax's default scale; PyTorch's default draws a third of
    that variance, under which a random DPT-Large returns zeros and a
    MidasV21Small nearly so) and its bias set to zero; norm layers as
    built."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                    # a transposed conv with stride = kernel feeds each output from its inputs' channels
                    fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5)
                    if m.bias is not None:
                        m.bias.zero_()
    return module


def create_v21(seed: int = 0) -> MidasV21Small:
    """A seeded ``MidasV21Small`` on the CPU (:func:`seeded`)."""
    return seeded(MidasV21Small, seed)
