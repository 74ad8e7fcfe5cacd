"""The MiDaS_small-class monocular relative-depth network as a
``torch.nn.Module``.

Counterpart of ``stereovision_tpu/models/midas.py``: an
EfficientNet-Lite-style inverted-residual encoder tapped at strides
4/8/16/32 and a RefineNet-lite decoder (residual conv units, nearest 2×
upsampling) with a softplus head. The module names follow the reference's
structure; ``convert.midas_small_from_flax`` carries its flax variables
across (kernels HWIO → OIHW, batch statistics into the batch norms'
running buffers).

Convolutions are ``nn.Conv2d`` (cuDNN on a card). flax's ``padding="SAME"``
pads a strided convolution unevenly (total max((⌈n/s⌉ − 1)·s + k − n, 0),
the smaller half before), so the stride-2 convolutions pad explicitly;
stride-1 ones pad k//2 on each side, which is the same. Batch norms run on
their running statistics (eps 1e-5); :func:`mono.nn.create_model` puts the
module in eval mode, and training keeps it there (:class:`BatchNorm`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def _pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax/XLA SAME padding of the two spatial axes of an NCHW tensor."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last axis first
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv(nn.Conv2d):
    """``nn.Conv2d`` with flax's SAME padding for any stride."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True):
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=bias,
                         padding=k // 2 if stride == 1 else 0)

    def forward(self, x):
        if self.stride[0] != 1:
            x = _pad_same(x, self.kernel_size[0], self.stride[0])
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running statistics may be trained. The
    reference's training differentiates its batch statistics like weights
    (every flax BatchNorm runs on its running average), which PyTorch's
    batch norm does not; where the running mean or variance requires grad
    (``models.train_synthetic``), the eval-mode normalisation is written out
    as flax computes it: (x − mean)·(scale·rsqrt(var + eps)) + bias."""

    def forward(self, x):
        if not self.training and (self.running_mean.requires_grad
                                  or self.running_var.requires_grad):
            mul = self.weight * torch.rsqrt(self.running_var + self.eps)
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        return super().forward(x)


def _bn(c: int) -> nn.BatchNorm2d:
    return BatchNorm(c, eps=BN_EPS)


class MBConv(nn.Module):
    """Inverted residual block (EfficientNet-lite: no squeeze-excitation,
    ReLU6)."""

    def __init__(self, in_ch: int, out_ch: int, expand: int = 6, stride: int = 1,
                 kernel: int = 3):
        super().__init__()
        mid = in_ch * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv = SameConv(in_ch, mid, 1, bias=False)
            self.expand_bn = _bn(mid)
        self.dw = SameConv(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self.dw_bn = _bn(mid)
        self.project = SameConv(mid, out_ch, 1, bias=False)
        self.project_bn = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = F.relu6(self.expand_bn(self.expand_conv(h)))
        h = F.relu6(self.dw_bn(self.dw(h)))
        h = self.project_bn(self.project(h))
        return h + x if self.residual else h


class ResidualConvUnit(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv0 = SameConv(ch, ch, 3)
        self.conv1 = SameConv(ch, ch, 3)

    def forward(self, x):
        return x + self.conv1(F.relu(self.conv0(F.relu(x))))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling (each pixel repeated along both axes)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class FeatureFusion(nn.Module):
    def __init__(self, ch: int, with_skip: bool):
        super().__init__()
        self.skip_unit = ResidualConvUnit(ch) if with_skip else None
        self.unit = ResidualConvUnit(ch)
        self.out_conv = SameConv(ch, ch, 1)

    def forward(self, x, skip=None):
        if self.skip_unit is not None:
            x = x + self.skip_unit(skip)
        return self.out_conv(_up2(self.unit(x)))


# the encoder: (channel index into encoder_chs, expand, stride, kernel)
ENCODER = ((0, 1, 1, 3),
           (1, 6, 2, 3), (1, 6, 1, 3),                 # → stride 4
           (2, 6, 2, 5), (2, 6, 1, 5),                 # → stride 8
           (3, 6, 2, 3), (3, 6, 1, 3), (3, 6, 1, 3),   # → stride 16
           (4, 6, 2, 5), (4, 6, 1, 5))                 # → stride 32
TAPS = (2, 4, 7, 9)  # the blocks after which the strides 4, 8, 16, 32 are tapped


class MidasSmall(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] → (B, H, W) relative inverse depth (≥ 0).
    H and W must be multiples of 32."""

    def __init__(self, features: int = 64, encoder_chs: Sequence[int] = (16, 24, 40, 96, 192)):
        super().__init__()
        c = tuple(encoder_chs)
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]), persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]), persistent=False)
        self.stem = SameConv(3, 32, 3, stride=2, bias=False)
        self.stem_bn = _bn(32)
        blocks, cin = [], 32
        for ci, expand, stride, kernel in ENCODER:
            blocks.append(MBConv(cin, c[ci], expand=expand, stride=stride, kernel=kernel))
            cin = c[ci]
        self.blocks = nn.ModuleList(blocks)
        f = features
        # p32, p16, p8, p4: the taps projected to the decoder's width
        self.taps = nn.ModuleList([SameConv(c[4], f, 3, bias=False), SameConv(c[3], f, 3, bias=False),
                                   SameConv(c[2], f, 3, bias=False), SameConv(c[1], f, 3, bias=False)])
        self.top_unit = ResidualConvUnit(f)
        self.fusions = nn.ModuleList([FeatureFusion(f, with_skip=i > 0) for i in range(4)])
        self.head0 = SameConv(f, f // 2, 3)
        self.head1 = SameConv(f // 2, 32, 3)
        self.head2 = SameConv(32, 1, 1)

    def forward(self, x):
        h = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        h = F.relu6(self.stem_bn(self.stem(h)))
        skips = []
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i in TAPS:
                skips.append(h)
        skip4, skip8, skip16, skip32 = skips
        p32, p16, p8, p4 = (conv(s) for conv, s in zip(self.taps, (skip32, skip16, skip8, skip4)))
        d = self.fusions[0](self.top_unit(p32))   # → stride 16
        d = self.fusions[1](d, p16)               # → stride 8
        d = self.fusions[2](d, p8)                # → stride 4
        d = self.fusions[3](d, p4)                # → stride 2
        d = _up2(self.head0(d))                   # → stride 1
        d = self.head2(F.relu(self.head1(d)))
        return F.softplus(d)[:, 0]
