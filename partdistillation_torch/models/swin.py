"""Swin Transformer backbone, channel-last.

Counterpart of the JAX package's ``models/swin.py`` on its default path:
the LayerNorms run the LayerNorm kernel (f32 statistics), window attention
runs the window-attention kernel on feature-major q/k/v with a grouped
additive bias (relative-position bias + the shift mask), and each block's MLP
half runs the fused LN->MLP kernel at every stage. With ``fused_proj`` the
window attention and its output projection run as one kernel at every stage
(the JAX package falls back to the two-step path at res5, where its kernel
exceeds the TPU's VMEM); the parameters are the same either way. Stochastic depth (DropPath
on the attention and the MLP branch, rates ``linspace(0, drop_path_rate,
blocks)``) is active in training mode when the caller passes the per-image
keep decisions (``drop_keep``); a block with a rate above 0 then takes the
MLP kernel's branch form and adds the dropped branch outside it, as the JAX
package does. Module and parameter names follow detectron2's Swin
(``layers.{s}.blocks.{b}.attn.qkv`` ...).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import fused_window_attention, fused_window_attention_proj
from ..ops.fused_mlp import fused_ln_mlp
from ..ops.layer_norm import fused_layer_norm
from .layers import Conv, Dense, LayerNorm, normal_, scalar_like

__all__ = ["SwinConfig", "SwinTransformer", "SwinBlock", "WindowAttention",
           "PatchMerging", "swin_large_config", "drop_path"]


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.3
    dtype: torch.dtype = torch.float32
    fused_proj: bool = False

    @property
    def num_blocks(self) -> int:
        return sum(self.depths)

    def drop_path_rates(self) -> np.ndarray:
        """Per-block stochastic-depth rates, block 0 first."""
        return np.linspace(0.0, self.drop_path_rate, self.num_blocks)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2**i)

    @property
    def out_channels(self) -> dict:
        return {f"res{i + 2}": self.stage_dim(i) for i in range(self.num_layers)}

    @property
    def out_strides(self) -> dict:
        return {f"res{i + 2}": self.patch_size * 2**i for i in range(self.num_layers)}


def swin_large_config(**kw) -> SwinConfig:
    """Swin-L/384 of the reference's flagship Mask2Former configs."""
    return SwinConfig(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                      window_size=12, **kw)


@functools.lru_cache(maxsize=64)
def _relative_position_index(window_size: int, device: torch.device) -> torch.Tensor:
    """Flat (ws*ws * ws*ws,) lookup into the (2*ws-1)^2 bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    idx = (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)
    with torch.inference_mode(False):  # cached: must serve autograd after inference too
        return torch.as_tensor(idx, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int,
                     device: torch.device) -> torch.Tensor:
    """Additive (nW, ws*ws, ws*ws) f32 mask for shifted windows: -100 between
    tokens from different regions of the rolled map."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = np.where(wins[:, :, None] != wins[:, None, :], -100.0, 0.0).astype(np.float32)
    with torch.inference_mode(False):  # cached: must serve autograd after inference too
        return torch.as_tensor(mask, device=device)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (nH * nW * B, ws*ws, C), WINDOW-MAJOR: all images'
    window (i, j) are contiguous, so windows sharing a bias block form runs."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(1, 3, 0, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    c = windows.shape[-1]
    x = windows.reshape(h // ws, w // ws, b, ws, ws, c)
    return x.permute(2, 0, 3, 1, 4, 5).reshape(b, h, w, c)


def drop_path(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """DropPath with given per-image decisions ``keep`` (B,) bool: kept
    images scaled by 1 / (1 - rate) in x's dtype, dropped images zero."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(keep.reshape(shape), x / scalar_like(1.0 - rate, x), 0.0)


class LN(LayerNorm):
    """LayerNorm through the LayerNorm kernel: input cast to ``dtype``, f32
    affine parameters, two-pass f32 statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x.to(self.compute_dtype).contiguous(), self.weight,
                                self.bias, self.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, dtype=torch.float32,
                 fused_proj: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.fused_proj = fused_proj
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, dim * 3, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.relative_position_bias_table, g, std=0.02, truncate=True)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (num_windows_total, N, C); mask: (nW, N, N) additive or None."""
        bnw, n, c = x.shape
        heads = self.num_heads
        idx = _relative_position_index(self.window_size, x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, heads).permute(2, 0, 1)
        # feature-major q/k/v (bnw, H, hd, N) for the kernel
        qkv = self.qkv(x).reshape(bnw, n, 3, heads, c // heads).permute(2, 0, 3, 4, 1)
        qt, kt, vt = (qkv[i].contiguous() for i in range(3))
        per = bias[None].float()
        if mask is not None:
            per = per + mask[:, None]
        if self.fused_proj:
            d = self.proj.compute_dtype
            return fused_window_attention_proj(qt, kt, vt, per.contiguous(),
                                               self.proj.weight.to(d), self.proj.bias.to(d),
                                               scale=self.scale)
        out = fused_window_attention(qt, kt, vt, per.contiguous(), scale=self.scale)
        return self.proj(out.reshape(bnw, c, n).transpose(1, 2))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype=torch.float32,
                 fused_proj: bool = False):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.drop_path = drop_path
        self.compute_dtype = dtype
        self.norm1 = LN(dim, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype, fused_proj)
        self.norm2 = LN(dim, dtype=dtype)  # parameters consumed by the MLP kernel
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: (2, B) bool keep decisions of the attention and the MLP
        branch's DropPath, or None for the deterministic block."""
        stochastic = keep is not None and self.drop_path > 0.0
        b, h, w, c = x.shape
        ws = self.window_size
        # a single padded window needs no shift (detection-Swin convention)
        shift = self.shift_size if min(h, w) > ws else 0

        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = _shift_attn_mask(hp, wp, ws, shift, x.device)
        attn_out = self.attn(_window_partition(x, ws), mask)
        x = _window_reverse(attn_out, ws, b, hp, wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = x[:, :h, :w]
        if stochastic:
            x = drop_path(x, keep[0], self.drop_path)
        x = shortcut + x

        d = self.compute_dtype
        n2, fc1, fc2 = self.norm2, self.mlp.fc1, self.mlp.fc2
        args = (x.to(d).contiguous(), n2.weight.to(d), n2.bias.to(d), fc1.weight.to(d),
                fc1.bias.to(d), fc2.weight.to(d), fc2.bias.to(d))
        if not stochastic:
            return fused_ln_mlp(*args)
        return x + drop_path(fused_ln_mlp(*args, add_residual=False), keep[1], self.drop_path)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.norm = LN(4 * dim, dtype=dtype)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        hp, wp = x.shape[1], x.shape[2]
        x = x.reshape(b, hp // 2, 2, wp // 2, 2, c)
        # (0,0), (1,0), (0,1), (1,1): the Swin checkpoint layout
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1],
                       x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = Conv(3, cfg.embed_dim, p, stride=p, dtype=cfg.dtype)
        self.norm = LN(cfg.embed_dim, dtype=cfg.dtype)


class _BasicLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int):
        super().__init__()
        dim = cfg.stage_dim(stage)
        first = sum(cfg.depths[:stage])
        rates = cfg.drop_path_rates()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, cfg.num_heads[stage], cfg.window_size,
                      0 if blk % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio,
                      float(rates[first + blk]), cfg.dtype, cfg.fused_proj)
            for blk in range(cfg.depths[stage])])
        self.downsample = (PatchMerging(dim, cfg.dtype)
                           if stage < cfg.num_layers - 1 else None)


class SwinTransformer(nn.Module):
    """Multi-scale backbone; returns {res2: (B, H/4, W/4, C), ..., res5}."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        self.config = config
        self.patch_embed = _PatchEmbed(config)
        self.layers = nn.ModuleList([_BasicLayer(config, s)
                                     for s in range(config.num_layers)])
        for s in range(config.num_layers):
            self.add_module(f"norm{s}", LN(config.stage_dim(s), dtype=config.dtype))

    def forward(self, x: torch.Tensor, drop_keep: Optional[torch.Tensor] = None) -> dict:
        """x (B, H, W, 3). ``drop_keep``: (blocks, 2, B) bool DropPath keep
        decisions, block 0 first (attention branch, MLP branch); read in
        training mode only. Without it every block is deterministic."""
        cfg = self.config
        if drop_keep is not None and tuple(drop_keep.shape) != (cfg.num_blocks, 2, x.shape[0]):
            raise ValueError(f"drop_keep must be ({cfg.num_blocks}, 2, {x.shape[0]}), "
                             f"got {tuple(drop_keep.shape)}")
        if not self.training:
            drop_keep = None
        h, w = x.shape[1], x.shape[2]
        p = cfg.patch_size
        if h % p or w % p:
            x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.patch_embed.norm(self.patch_embed.proj(x))
        outs = {}
        i = 0
        for s, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, None if drop_keep is None else drop_keep[i])
                i += 1
            outs[f"res{s + 2}"] = getattr(self, f"norm{s}")(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
