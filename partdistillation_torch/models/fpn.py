"""FPN pixel decoders, the MaskFormer-v1 alternative to the deformable one.

Counterpart of the JAX package's ``models/fpn.py``:
  * ``BasePixelDecoder``: a top-down FPN over res2..res5, 1x1 lateral and
    3x3 output convolutions (GroupNorm 32, eps 1e-5, ReLU after the output
    convolutions), nearest upsampling with half-pixel centres (as
    ``jax.image.resize(method="nearest")``; torch's "nearest-exact"), a 3x3
    ``mask_features`` convolution on the finest map; the three coarsest
    decoded maps are the multi-scale features, coarse to fine;
  * ``TransformerEncoderPixelDecoder``: the same FPN with the coarsest level
    first run through a DETR transformer encoder (a 1x1 input projection and
    the sine positional embedding); the encoder's output is also returned,
    the v1 standard decoder's memory;
  * ``build_pixel_decoder``: the ``msdeform`` / ``fpn`` / ``transformer_fpn``
    dispatch.
Both default to f32, as the JAX package's configs do; in f32 they compute
inside ``utils.precision.full_f32``. Parameter names follow the reference's
``BasePixelDecoder``: ``adapter_{n}`` (laterals) and ``layer_{n}`` (output
convolutions), numbered fine to coarse from 1 (res2) to 4 (res5),
``mask_features``, ``input_proj`` and ``transformer.encoder``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import full_f32
from .detr_transformer import DETRTransformerConfig, TransformerEncoderOnly
from .layers import Conv, ConvNorm
from .pixel_decoder import MSDeformAttnPixelDecoder
from .position_encoding import position_embedding_sine

__all__ = ["FPNPixelDecoderConfig", "BasePixelDecoder", "TransformerEncoderPixelDecoder",
           "build_pixel_decoder", "f32_context"]


@dataclasses.dataclass(frozen=True)
class FPNPixelDecoderConfig:
    conv_dim: int = 256
    mask_dim: int = 256
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")  # fine -> coarse
    num_output_levels: int = 3
    # TransformerEncoderPixelDecoder
    transformer_enc_layers: int = 6
    n_heads: int = 8
    transformer_ffn_dim: int = 2048
    transformer_pre_norm: bool = False
    dtype: torch.dtype = torch.float32


def f32_context(dtype, device):
    """``full_f32`` for a module that computes in f32, else nothing."""
    return full_f32(device) if dtype == torch.float32 else contextlib.nullcontext()


def upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Channel-last nearest resize, half-pixel centres."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                         mode="nearest-exact").permute(0, 2, 3, 1)


class BasePixelDecoder(nn.Module):
    """Returns (mask_features (B, H/4, W/4, mask_dim), encoder feature or
    None, multi-scale features: the ``num_output_levels`` coarsest decoded
    maps (B, H_l, W_l, conv_dim), coarse to fine)."""

    def __init__(self, cfg: FPNPixelDecoderConfig, in_channels: Dict[str, int]):
        super().__init__()
        self.cfg = cfg
        d, n = cfg.dtype, len(cfg.in_features)
        for i, k in enumerate(cfg.in_features[:-1]):
            setattr(self, f"adapter_{i + 1}", ConvNorm(in_channels[k], cfg.conv_dim, 1, dtype=d))
            setattr(self, f"layer_{i + 1}", ConvNorm(cfg.conv_dim, cfg.conv_dim, 3, dtype=d))
        setattr(self, f"layer_{n}", ConvNorm(self._coarsest_in(in_channels), cfg.conv_dim, 3,
                                             dtype=d))
        self.mask_features = Conv(cfg.conv_dim, cfg.mask_dim, 3, dtype=d, init="xavier")

    def _coarsest_in(self, in_channels: Dict[str, int]) -> int:
        return in_channels[self.cfg.in_features[-1]]

    def _coarsest(self, x: torch.Tensor):
        """The coarsest level: (decoded map, encoder feature or None)."""
        return torch.relu(getattr(self, f"layer_{len(self.cfg.in_features)}")(x)), None

    def forward(self, features: Dict[str, torch.Tensor]):
        cfg = self.cfg
        with f32_context(cfg.dtype, next(iter(features.values())).device):
            n = len(cfg.in_features)
            y, encoder_feature = self._coarsest(features[cfg.in_features[-1]])
            multi_scale = [y]
            for i in range(n - 2, -1, -1):  # fine-to-coarse index of the next finer level
                lateral = getattr(self, f"adapter_{i + 1}")(features[cfg.in_features[i]])
                y = lateral + upsample_nearest(y, lateral.shape[1], lateral.shape[2])
                y = torch.relu(getattr(self, f"layer_{i + 1}")(y))
                if len(multi_scale) < cfg.num_output_levels:
                    multi_scale.append(y)
            return self.mask_features(y), encoder_feature, multi_scale[:cfg.num_output_levels]


class TransformerEncoderPixelDecoder(BasePixelDecoder):
    """The FPN with its coarsest level run through a DETR transformer
    encoder first; the encoder's output is the v1 decoder's memory."""

    def __init__(self, cfg: FPNPixelDecoderConfig, in_channels: Dict[str, int]):
        super().__init__(cfg, in_channels)
        self.input_proj = Conv(in_channels[cfg.in_features[-1]], cfg.conv_dim, 1, dtype=cfg.dtype,
                               init="xavier")
        self.transformer = TransformerEncoderOnly(DETRTransformerConfig(
            d_model=cfg.conv_dim, num_heads=cfg.n_heads, dim_feedforward=cfg.transformer_ffn_dim,
            num_encoder_layers=cfg.transformer_enc_layers, pre_norm=cfg.transformer_pre_norm,
            dtype=cfg.dtype))

    def _coarsest_in(self, in_channels: Dict[str, int]) -> int:
        return self.cfg.conv_dim

    def _coarsest(self, x: torch.Tensor):
        cfg = self.cfg
        b, h, w, _ = x.shape
        proj = self.input_proj(x)
        pos = position_embedding_sine(h, w, cfg.conv_dim // 2, dtype=cfg.dtype, device=x.device)
        pos = pos.reshape(1, h * w, cfg.conv_dim).expand(b, -1, -1)
        mem = self.transformer(proj.reshape(b, h * w, cfg.conv_dim), pos=pos)
        encoder_feature = mem.reshape(b, h, w, cfg.conv_dim)
        return torch.relu(getattr(self, f"layer_{len(cfg.in_features)}")(encoder_feature)), \
            encoder_feature


def build_pixel_decoder(name: str, cfg, in_channels: Dict[str, int]) -> nn.Module:
    """The pixel decoder ``name`` ("msdeform" | "fpn" | "transformer_fpn")
    with its config ``cfg`` over the backbone's ``in_channels``."""
    table = {"msdeform": MSDeformAttnPixelDecoder, "fpn": BasePixelDecoder,
             "transformer_fpn": TransformerEncoderPixelDecoder}
    if name not in table:
        raise ValueError(f"unknown pixel decoder {name!r}; options: {sorted(table)}")
    return table[name](cfg, in_channels)
