"""ViTDet: a plain ViT backbone with a simple feature pyramid (Li et al.
2022, "Exploring Plain Vision Transformer Backbones for Object Detection"),
channel-last, as detectron2's ``ViT`` and ``SimpleFeaturePyramid`` compute
it and name their parameters (``backbone.net.blocks.{i}.attn.qkv``,
``backbone.net.pos_embed``, ``backbone.simfp_2.0`` ...), so a converted
ViTDet checkpoint loads with ``load_state_dict``.

The ViT: a 16 x 16 patch embedding (a convolution with bias), the absolute
position table of the pretraining grid (14 x 14 and a class token for 224)
resized to the token grid in every forward as upstream's ``get_abs_pos``
does (``F.interpolate``, bicubic, ``align_corners=False``; the port's
``vit_utils.get_abs_pos`` follows JAX's resize instead), then blocks of
``x + drop_path(attn(norm1(x)))`` and ``x + drop_path(mlp(norm2(x)))``, two
independent DropPath draws a block at rates ``linspace(0, rate, depth)``.
Window blocks partition after ``norm1``, zero-padding the grid up to a
multiple of the window (64 -> 70 at 1024 x 1024): the padded tokens are
keys, unmasked, and ``qkv`` and ``proj`` run on the padded windows, as
upstream. The other blocks attend globally. Both go through
``ops/relpos_attention`` (decomposed relative positions from the unscaled
q), inside the spans ``vit.window_attn`` and ``vit.global_attn``. The norms
run the LayerNorm kernel (#1) and ``norm2`` + MLP the fused LN -> MLP (#2),
as Swin's blocks do; there is no final norm.

The pyramid, inside the span ``vit.sfp``: scale 4 ``ConvT(C -> C/2, 2, 2)``,
channel LayerNorm, GELU, ``ConvT(C/2 -> C/4, 2, 2)``; scale 2 ``ConvT(C ->
C/2, 2, 2)``; scale 1 the identity; scale 1/2 a 2 x 2 max pool; each then a
1 x 1 and a 3 x 3 convolution without bias, each with a channel LayerNorm.
Its outputs p2-p5 are the segmenter's ``res2``-``res5``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.fused_mlp import fused_ln_mlp
from ..ops.relpos_attention import relpos_attention
from .layers import Conv, Dense, normal_, zeros_
from .swin import LN, drop_path
from .vit_utils import PatchEmbed, window_partition, window_unpartition

__all__ = ["ViTDetConfig", "ViTDet", "ViT", "vitdet_large_config"]


# detectron2's ViTDet settings that every published size shares: a qkv
# bias, a class token in the pretraining position table, the pyramid at
# strides 4 to 32
SCALE_FACTORS = (4.0, 2.0, 1.0, 0.5)


@dataclasses.dataclass(frozen=True)
class ViTDetConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6  # every LayerNorm: the blocks' and the pyramid's
    drop_path_rate: float = 0.1
    window_size: int = 14
    # blocks that attend globally; every other block is a window block
    global_block_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    pretrain_img_size: int = 224
    out_dim: int = 256
    dtype: torch.dtype = torch.float32

    @property
    def num_blocks(self) -> int:
        return self.depth

    def drop_path_rates(self) -> np.ndarray:
        """Per-block stochastic-depth rates, block 0 first."""
        return np.linspace(0.0, self.drop_path_rate, self.depth)

    @property
    def out_channels(self) -> dict:
        return {f"res{self.stage(s)}": self.out_dim for s in SCALE_FACTORS}

    def stage(self, scale: float) -> int:
        """The pyramid level of a scale factor: log2 of its stride."""
        return int(round(np.log2(self.patch_size / scale)))


def vitdet_large_config(**kw) -> ViTDetConfig:
    """ViTDet-L at 1024 x 1024 (detectron2's ``mask_rcnn_vitdet_l_100ep.py``):
    ViT-L/16, 24 blocks of 16 heads, global attention in blocks 5, 11, 17
    and 23, DropPath 0.4."""
    return ViTDetConfig(embed_dim=1024, depth=24, num_heads=16, drop_path_rate=0.4,
                        global_block_indexes=(5, 11, 17, 23), **kw)


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, size: int, dtype, span: str):
        super().__init__()
        self.num_heads, self.span = num_heads, span
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Dense(dim, dim * 3, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.rel_pos_h, g, std=0.02, truncate=True)
        normal_(self.rel_pos_w, g, std=0.02, truncate=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C): self-attention over the H x W grid."""
        b, h, w, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b * heads, h * w, c // heads).contiguous() for t in qkv.unbind(0))
        with record_function(self.span):
            out = relpos_attention(q, k, v, self.rel_pos_h, self.rel_pos_w, (h, w), self.scale)
        out = out.reshape(b, heads, h, w, c // heads).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)


class _Block(nn.Module):
    def __init__(self, cfg: ViTDetConfig, drop_path: float, window: bool):
        super().__init__()
        dim, d = cfg.embed_dim, cfg.dtype
        self.window_size = cfg.window_size if window else 0
        self.drop_path = drop_path
        self.compute_dtype = d
        self.norm1 = LN(dim, eps=cfg.norm_eps, dtype=d)
        size = cfg.window_size if window else cfg.img_size // cfg.patch_size
        self.attn = _Attention(dim, cfg.num_heads, size, d,
                               "vit.window_attn" if window else "vit.global_attn")
        self.norm2 = LN(dim, eps=cfg.norm_eps, dtype=d)  # parameters consumed by #2
        self.mlp = _Mlp(dim, int(dim * cfg.mlp_ratio), d)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: (2, B) bool keep decisions of the attention and the MLP
        branch's DropPath, or None for the deterministic block."""
        stochastic = keep is not None and self.drop_path > 0.0
        shortcut = x
        y = self.norm1(x)
        if self.window_size:
            h, w = y.shape[1:3]
            y, pad_hw = window_partition(y, self.window_size)
            y = window_unpartition(self.attn(y), self.window_size, pad_hw, (h, w))
        else:
            y = self.attn(y)
        if stochastic:
            y = drop_path(y, keep[0], self.drop_path)
        x = shortcut + y
        d = self.compute_dtype
        n2, fc1, fc2 = self.norm2, self.mlp.fc1, self.mlp.fc2
        args = (x.to(d).contiguous(), n2.weight.to(d), n2.bias.to(d), fc1.weight.to(d),
                fc1.bias.to(d), fc2.weight.to(d), fc2.bias.to(d))
        if not stochastic:
            return fused_ln_mlp(*args, eps=n2.eps)
        return x + drop_path(fused_ln_mlp(*args, eps=n2.eps, add_residual=False), keep[1],
                             self.drop_path)


class ViT(nn.Module):
    """The plain ViT: (B, H, W, 3) -> (B, H/16, W/16, C)."""

    def __init__(self, cfg: ViTDetConfig):
        super().__init__()
        self.config = cfg
        p = cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchEmbed(3, cfg.embed_dim, (p, p), (p, p), dtype=cfg.dtype)
        grid = cfg.pretrain_img_size // p
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.embed_dim))
        rates = cfg.drop_path_rates()
        self.blocks = nn.ModuleList([_Block(cfg, float(rates[i]),
                                            i not in cfg.global_block_indexes)
                                     for i in range(cfg.depth)])

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.pos_embed, g, std=0.02, truncate=True)

    def abs_pos(self, hw: Tuple[int, int]) -> torch.Tensor:
        """The position table on the (H, W) grid, (1, H, W, C) f32:
        upstream's ``get_abs_pos`` (class token dropped, bicubic resize)."""
        pos = self.pos_embed[:, 1:]
        size = int(round(pos.shape[1] ** 0.5))
        grid = pos.reshape(1, size, size, -1)
        if (size, size) == tuple(hw):
            return grid
        grid = F.interpolate(grid.permute(0, 3, 1, 2), size=hw, mode="bicubic",
                             align_corners=False)
        return grid.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, drop_keep: Optional[torch.Tensor] = None):
        x = self.patch_embed.proj(x)
        x = (x.float() + self.abs_pos(tuple(x.shape[1:3]))).to(self.config.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if drop_keep is None else drop_keep[i])
        return x


class _ConvT(nn.Module):
    """A 2 x 2, stride-2 transposed convolution, channel-last: each input
    pixel spreads to its 2 x 2 output block; the weight (I, O, 2, 2) as
    ``nn.ConvTranspose2d`` holds it."""

    def __init__(self, c_in: int, c_out: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, 2, 2))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.compute_dtype = dtype

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.weight, g, std=self.weight.shape[0] ** -0.5, truncate=True)
        zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        d = self.compute_dtype
        o = self.weight.shape[1]
        y = torch.matmul(x.to(d).reshape(b, h * w, c), self.weight.to(d).reshape(c, o * 4))
        y = y.reshape(b, h, w, o, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * h, 2 * w, o)
        return y + self.bias.to(d)


class _Gelu(nn.Module):
    def forward(self, x):
        return F.gelu(x)


class _MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class _ConvLN(Conv):
    """detectron2's ``Conv2d(..., bias=False, norm=LayerNorm)``: the
    convolution, then a channel LayerNorm (its ``.norm``)."""

    def __init__(self, c_in: int, c_out: int, k: int, eps: float, dtype):
        super().__init__(c_in, c_out, k, bias=False, dtype=dtype)
        self.norm = LN(c_out, eps=eps, dtype=dtype)

    def forward(self, x):
        return self.norm(super().forward(x))


class ViTDet(nn.Module):
    """The ViT (``net``) and its simple feature pyramid (``simfp_{2..5}``);
    returns {res2: (B, H/4, W/4, 256), ..., res5: (B, H/32, W/32, 256)}."""

    def __init__(self, config: ViTDetConfig):
        super().__init__()
        self.config = cfg = config
        self.net = ViT(cfg)
        dim, out, eps, d = cfg.embed_dim, cfg.out_dim, cfg.norm_eps, cfg.dtype
        for scale in SCALE_FACTORS:
            if scale == 4.0:
                layers = [_ConvT(dim, dim // 2, d), LN(dim // 2, eps=eps, dtype=d), _Gelu(),
                          _ConvT(dim // 2, dim // 4, d)]
                width = dim // 4
            elif scale == 2.0:
                layers, width = [_ConvT(dim, dim // 2, d)], dim // 2
            elif scale == 1.0:
                layers, width = [], dim
            else:
                layers, width = [_MaxPool()], dim
            layers += [_ConvLN(width, out, 1, eps, d), _ConvLN(out, out, 3, eps, d)]
            self.add_module(f"simfp_{cfg.stage(scale)}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor, drop_keep: Optional[torch.Tensor] = None) -> dict:
        """x (B, H, W, 3). ``drop_keep``: (depth, 2, B) bool DropPath keep
        decisions, block 0 first (attention branch, MLP branch); read in
        training mode only. Without it every block is deterministic."""
        cfg = self.config
        if drop_keep is not None and tuple(drop_keep.shape) != (cfg.depth, 2, x.shape[0]):
            raise ValueError(f"drop_keep must be ({cfg.depth}, 2, {x.shape[0]}), "
                             f"got {tuple(drop_keep.shape)}")
        if not self.training:
            drop_keep = None
        feat = self.net(x, drop_keep)
        with record_function("vit.sfp"):
            return {f"res{cfg.stage(s)}": getattr(self, f"simfp_{cfg.stage(s)}")(feat)
                    for s in SCALE_FACTORS}
