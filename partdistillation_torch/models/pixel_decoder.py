"""Deformable-attention pixel decoder (Mask2Former-style), channel-last.

Counterpart of the JAX package's ``models/pixel_decoder.py``: a deformable
transformer encoder over {res3, res4, res5} (processed high-stride first),
then one FPN step onto res2 for the stride-4 ``mask_features``. Parameter
names follow detectron2's MSDeformAttnPixelDecoder (``input_proj.{i}.0/1``,
``transformer.encoder.layers.{i}``, ``adapter_1``, ``layer_1``,
``mask_features``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MSDeformAttn
from .layers import Conv, ConvNorm, Dense, GroupNorm, LayerNorm, normal_
from .position_encoding import position_embedding_sine

__all__ = ["PixelDecoderConfig", "MSDeformAttnPixelDecoder"]


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    conv_dim: int = 256
    mask_dim: int = 256
    transformer_layers: int = 6
    transformer_ffn_dim: int = 1024
    n_heads: int = 8
    n_points: int = 4
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    fpn_in_feature: str = "res2"
    num_output_levels: int = 3
    dtype: torch.dtype = torch.float32
    # the encoder's sampling (ops.ms_deform_attn): mode None is dense,
    # "banded" reads a band of msda_band_radius level pixels around each
    # query tile (msda_band_oob_fraction measures the mass outside it); the
    # tile caps bound the bands' extent, 1-D row bands unless
    # msda_band_tile_x is set
    msda_mode: Optional[str] = None
    msda_band_radius: int = 6
    msda_band_tile_queries: int = 512
    msda_band_tile_x: Optional[int] = None


def _reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                      device=None) -> torch.Tensor:
    """(S, L, 2) normalised per-level pixel-centre reference points, each
    level's centres broadcast across all L level slots (valid ratios = 1)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    ref = torch.cat(pts, dim=0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Channel-last bilinear resize, half-pixel centres, no antialiasing."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, n_levels: int):
        super().__init__()
        d = cfg.dtype
        self.self_attn = MSDeformAttn(cfg.conv_dim, n_levels, cfg.n_heads, cfg.n_points, d,
                                      cfg.msda_mode, cfg.msda_band_radius,
                                      cfg.msda_band_tile_queries, cfg.msda_band_tile_x)
        self.norm1 = LayerNorm(cfg.conv_dim, dtype=d)
        self.linear1 = Dense(cfg.conv_dim, cfg.transformer_ffn_dim, dtype=d)
        self.linear2 = Dense(cfg.transformer_ffn_dim, cfg.conv_dim, dtype=d)
        self.norm2 = LayerNorm(cfg.conv_dim, dtype=d)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + attn)
        y = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + y)


class _Encoder(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, n_levels: int):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg, n_levels)
                                     for _ in range(cfg.transformer_layers)])


class _Transformer(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, n_levels: int):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, cfg.conv_dim))
        self.encoder = _Encoder(cfg, n_levels)

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.level_embed, g, std=1.0)


class MSDeformAttnPixelDecoder(nn.Module):
    """Returns (mask_features, encoder_feature, multi_scale_features):
    mask_features (B, H/4, W/4, mask_dim); multi-scale features a list of
    (B, H_l, W_l, conv_dim) at strides [32, 16, 8]."""

    def __init__(self, cfg: PixelDecoderConfig, in_channels: Dict[str, int]):
        super().__init__()
        self.cfg = cfg
        d = cfg.dtype
        keys = list(cfg.transformer_in_features)[::-1]
        self.input_proj = nn.ModuleList([
            nn.Sequential(Conv(in_channels[k], cfg.conv_dim, 1, dtype=d, init="xavier"),
                          GroupNorm(32, cfg.conv_dim, dtype=d))
            for k in keys])
        self.transformer = _Transformer(cfg, len(keys))
        self.adapter_1 = ConvNorm(in_channels[cfg.fpn_in_feature], cfg.conv_dim, 1, dtype=d)
        self.layer_1 = ConvNorm(cfg.conv_dim, cfg.conv_dim, 3, dtype=d)
        self.mask_features = Conv(cfg.conv_dim, cfg.mask_dim, 3, dtype=d, init="xavier")

    def forward(self, features: Dict[str, torch.Tensor]):
        cfg = self.cfg
        keys = list(cfg.transformer_in_features)[::-1]
        srcs, poss, spatial_shapes = [], [], []
        for i, k in enumerate(keys):
            x = features[k]
            b, h, w, _ = x.shape
            proj = self.input_proj[i](x)
            srcs.append(proj.reshape(b, h * w, cfg.conv_dim))
            pe = position_embedding_sine(h, w, cfg.conv_dim // 2, dtype=cfg.dtype,
                                         device=x.device)
            poss.append(pe.reshape(1, h * w, cfg.conv_dim).expand(b, -1, -1))
            spatial_shapes.append((h, w))

        level_embed = self.transformer.level_embed
        src = torch.cat(srcs, dim=1)
        pos = torch.cat([p + level_embed[i][None, None, :] for i, p in enumerate(poss)], dim=1)
        ref = _reference_points(spatial_shapes, src.device)[None]
        ref = ref.expand((src.shape[0],) + tuple(ref.shape[1:]))
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, spatial_shapes)

        outs: List[torch.Tensor] = []
        start = 0
        for h, w in spatial_shapes:
            outs.append(src[:, start:start + h * w].reshape(-1, h, w, cfg.conv_dim))
            start += h * w

        lateral = self.adapter_1(features[cfg.fpn_in_feature])
        y = lateral + _resize_bilinear(outs[-1], lateral.shape[1], lateral.shape[2])
        y = torch.relu(self.layer_1(y))
        mask_features = self.mask_features(y)
        return mask_features, outs[0], outs[: cfg.num_output_levels]
