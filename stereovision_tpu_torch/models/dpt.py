"""DPT-Large (MiDaS 3.0), the exact torch-hub architecture, as a
``torch.nn.Module``.

Counterpart of ``stereovision_tpu/models/dpt.py``: the hub's ``DPT_Large``,
``DPTDepthModel(backbone="vitl16_384", non_negative=True)``:

- a timm ``vit_large_patch16_384`` encoder (patch 16, embed 1024, 24 pre-norm
  blocks, 16 heads, MLP ratio 4, LayerNorm eps 1e-6) tapped after blocks
  5/11/17/23;
- per tap an ``act_postprocess`` stack: the "project" readout ([patch
  tokens, cls token] → Linear 2C→C → GELU), the patch grid, a 1×1 conv to
  (256, 512, 1024, 1024) channels, then strides (4, 8, 16, 32): 4×4/4 and
  2×2/2 transposed convolutions, identity, a 3×3/2 convolution;
- the DPT scratch: 3×3 ``layerN_rn`` convolutions to 256 features, four
  RefineNet fusion blocks (no expansion, align-corners upsampling) and the
  256→128→32→1 non-negative head.

The submodules carry the hub checkpoint's names (:func:`expected_manifest`),
including the timm ``norm`` and ``head``, which the hub checkpoint holds and
the forward never computes. :class:`DPTConfig` sizes the network;
:data:`DPT_LARGE` is the shipping one, :data:`DPT_TINY` a small instance
with the same structure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from stereovision_tpu_torch.models.midas_v21 import (FeatureFusion, check_state_dict,
                                                     manifest_of, output_head, seeded)
from stereovision_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 16
    img_size: int = 384  # the pos_embed's native grid is img_size/patch
    hooks: tuple = (5, 11, 17, 23)
    post_channels: tuple = (256, 512, 1024, 1024)
    features: int = 256
    num_classes: int = 1000  # timm head (in the checkpoint; unused by DPT)


DPT_LARGE = DPTConfig()
DPT_TINY = DPTConfig(embed_dim=32, depth=4, num_heads=4, mlp_ratio=2,
                     patch_size=16, img_size=64, hooks=(0, 1, 2, 3),
                     post_channels=(8, 12, 16, 16), features=16,
                     num_classes=10)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        # the reference's order: q·kᵀ, the scale, softmax over the keys, ·v
        att = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(B, N, C))


class _Mlp(nn.Module):
    def __init__(self, dim: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, ratio * dim)
        self.fc2 = nn.Linear(ratio * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class _ViT(nn.Module):
    """timm ``VisionTransformer``: what the checkpoint holds, ``cls_token``
    and ``pos_embed`` first (a module's own parameters precede its
    submodules' in ``state_dict``)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        C, gs = cfg.embed_dim, cfg.img_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.randn(1, 1 + gs * gs, C) * 0.02)
        self.patch_embed = _PatchEmbed(C, cfg.patch_size)
        self.blocks = nn.ModuleList(
            [_Block(C, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(C, eps=1e-6)          # not computed
        self.head = nn.Linear(C, cfg.num_classes)      # not computed


class _ProjectReadout(nn.Module):
    """[patch tokens, cls token broadcast] → Linear 2C→C → exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU(approximate="none"))

    def forward(self, x):
        patches = x[:, 1:]
        return self.project(torch.cat([patches, x[:, :1].expand_as(patches)], dim=-1))


def _post(cfg: DPTConfig, idx: int) -> nn.Sequential:
    """``act_postprocess{idx+1}``: readout at 0, the hub's token reshapes
    (parameter-free) at 1 and 2, the 1×1 conv at 3, the resampling at 4."""
    C, o = cfg.embed_dim, cfg.post_channels[idx]
    resample = (nn.ConvTranspose2d(o, o, 4, stride=4), nn.ConvTranspose2d(o, o, 2, stride=2),
                nn.Identity(), nn.Conv2d(o, o, 3, stride=2, padding=1))[idx]
    return nn.Sequential(_ProjectReadout(C), nn.Identity(), nn.Identity(), nn.Conv2d(C, o, 1),
                         resample)


def resize_pos_embed(pos_embed: torch.Tensor, grid_hw, native_grid: int) -> torch.Tensor:
    """MiDaS ``_resize_pos_embed`` as the reference computes it: the cls
    token kept, the patch grid resized bilinearly (half-pixel centres) with
    antialiasing, which ``jax.image.resize`` applies by default and which
    changes the result where the grid shrinks; nothing is done at the
    native grid."""
    gh, gw = grid_hw
    if (gh, gw) == (native_grid, native_grid):
        return pos_embed
    C = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, native_grid, native_grid, C).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                         antialias=True)
    return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, C)], dim=1)


@contextlib.contextmanager
def _cudnn_off():
    """cuDNN off inside (PyTorch's own im2col and GEMM run each
    convolution), its other settings untouched. In float32 cuDNN's
    heuristic picks, at some input sizes, an FFT algorithm for the head's
    3×3 convolution: 257.6 ms and a 17.5 GB workspace at 384×384 on an
    H100, against 0.81 ms and 0.36 GB with cuDNN off; and slow algorithms
    for the many-channel convolutions on small maps (the 3×3/2 resampling
    of the last tap and ``layer4_rn``: 0.33 and 0.23 ms against 0.14 and
    0.07). im2col's buffer is bounded: in·k²·out_h·out_w values."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


class DPTDepth(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] → (B, H, W) non-negative relative inverse
    depth. H and W must be multiples of 2·patch_size. The hub transform's
    mean/std 0.5 normalization is applied here."""

    def __init__(self, cfg: DPTConfig = DPT_LARGE):
        super().__init__()
        self.cfg = cfg
        self.pretrained = nn.Module()
        self.pretrained.model = _ViT(cfg)
        for idx in range(4):
            setattr(self.pretrained, f"act_postprocess{idx + 1}", _post(cfg, idx))
        f = cfg.features
        self.scratch = nn.Module()
        for i in range(4):
            setattr(self.scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(cfg.post_channels[i], f, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):  # DPT's registration order
            setattr(self.scratch, f"refinenet{i}", FeatureFusion(f, f))
        self.scratch.output_conv = output_head(f)

    @_cudnn_off()
    def forward(self, x):
        """Spans (``utils.profiling.annotate``): ``dpt.embed`` (the patch
        embedding, the cls token and the position embedding),
        ``dpt.blocks`` (the transformer blocks), ``dpt.reassemble`` (the
        readouts, the resampling and the ``layerN_rn`` convolutions),
        ``dpt.fusion`` (the four fusion blocks) and ``dpt.head``. Every
        convolution runs with cuDNN off (:func:`_cudnn_off`)."""
        cfg = self.cfg
        P = cfg.patch_size
        B, H, W, _ = x.shape
        if H % (2 * P) or W % (2 * P):
            raise ValueError(f"DPTDepth takes H and W multiples of {2 * P}, got {(H, W)}")
        gh, gw = H // P, W // P
        m, s = self.pretrained.model, self.scratch
        with annotate("dpt.embed"):
            h = m.patch_embed.proj(((x - 0.5) / 0.5).permute(0, 3, 1, 2))
            h = torch.cat([m.cls_token.expand(B, -1, -1), h.flatten(2).transpose(1, 2)], dim=1)
            h = h + resize_pos_embed(m.pos_embed, (gh, gw), cfg.img_size // P)
        taps = []
        with annotate("dpt.blocks"):
            for i, block in enumerate(m.blocks):
                h = block(h)
                if i in cfg.hooks:
                    taps.append(h)
        with annotate("dpt.reassemble"):
            rn = []
            for idx, a in enumerate(taps):
                seq = getattr(self.pretrained, f"act_postprocess{idx + 1}")
                v = seq[0](a).transpose(1, 2).reshape(B, cfg.embed_dim, gh, gw)
                rn.append(getattr(s, f"layer{idx + 1}_rn")(seq[4](seq[3](v))))
        with annotate("dpt.fusion"):
            path = s.refinenet4(rn[3])
            path = s.refinenet3(path, rn[2])
            path = s.refinenet2(path, rn[1])
            path = s.refinenet1(path, rn[0])
        with annotate("dpt.head"):
            return s.output_conv(path)[:, 0]


@functools.lru_cache(maxsize=None)
def expected_manifest(cfg: DPTConfig = DPT_LARGE) -> tuple:
    """Ordered (key, shape) list of the hub DPT checkpoint of ``cfg`` (conv
    weights OIHW, transposed-conv weights IOHW, Linear weights (out, in))."""
    return manifest_of(lambda: DPTDepth(cfg))


def validate_state_dict(state_dict, cfg: DPTConfig = DPT_LARGE) -> None:
    """Check a hub-format state_dict against :func:`expected_manifest`."""
    check_state_dict(state_dict, expected_manifest(cfg), "DPT_Large")


def create_dpt(seed: int = 0, cfg: DPTConfig = DPT_LARGE) -> DPTDepth:
    """A seeded ``DPTDepth(cfg)`` on the CPU (``models.midas_v21.seeded``;
    ``pos_embed`` normal with std 0.02, ``cls_token`` zeros)."""
    return seeded(lambda: DPTDepth(cfg), seed)
