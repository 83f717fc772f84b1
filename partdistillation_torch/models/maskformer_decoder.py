"""MaskFormer-v1 standard transformer decoder (single scale).

Counterpart of the JAX package's ``models/maskformer_decoder.py``: a DETR
transformer (an optional encoder, then a decoder over learned query
embeddings) cross-attending one feature map, then a class head and a
3-layer mask-embedding MLP whose output is multiplied into the stride-4
mask features. Deep supervision returns every decoder layer's predictions.
The output dict has the keys of the multi-scale masked decoder
(``pred_logits``, ``pred_masks``, ``decoder_output``, ``aux_outputs``).
f32 by default, as the JAX package's config; in f32 it computes inside
``utils.precision.full_f32``. Parameter names follow the reference's
``TransformerPredictor`` (``query_embed``, ``input_proj``, ``transformer.
encoder`` / ``transformer.decoder``, ``class_embed``,
``mask_embed.layers.{i}``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .detr_transformer import DETRTransformerConfig, Transformer
from .fpn import f32_context
from .layers import Conv, Dense, normal_
from .position_encoding import position_embedding_sine
from .transformer_decoder import _MLP

__all__ = ["StandardDecoderConfig", "StandardTransformerDecoder"]


@dataclasses.dataclass(frozen=True)
class StandardDecoderConfig:
    num_classes: int = 1
    hidden_dim: int = 256
    num_queries: int = 100
    num_heads: int = 8
    dim_feedforward: int = 2048
    enc_layers: int = 0
    dec_layers: int = 6
    pre_norm: bool = False
    deep_supervision: bool = True
    mask_dim: int = 256
    mask_classification: bool = True
    enforce_input_project: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def supervised_layers(self) -> int:
        """The final output and the auxiliary layers' outputs."""
        return self.dec_layers if self.deep_supervision else 1


class StandardTransformerDecoder(nn.Module):
    def __init__(self, cfg: StandardDecoderConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        d, c = cfg.dtype, cfg.hidden_dim
        self.query_embed = nn.Embedding(cfg.num_queries, c)
        self.input_proj = (Conv(in_channels, c, 1, dtype=d, init="xavier")
                           if in_channels != c or cfg.enforce_input_project else None)
        self.transformer = Transformer(DETRTransformerConfig(
            d_model=c, num_heads=cfg.num_heads, dim_feedforward=cfg.dim_feedforward,
            num_encoder_layers=cfg.enc_layers, num_decoder_layers=cfg.dec_layers,
            pre_norm=cfg.pre_norm, return_intermediate=cfg.deep_supervision, dtype=d))
        self.mask_embed = _MLP(c, cfg.mask_dim, 3, d)
        self.class_embed = Dense(c, cfg.num_classes + 1, dtype=d) \
            if cfg.mask_classification else None

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.query_embed.weight, g, std=1.0)

    def forward(self, x: torch.Tensor, mask_features: torch.Tensor) -> dict:
        """x (B, H, W, C): one feature map (the pixel decoder's encoder
        feature, or res5); mask_features (B, H/4, W/4, mask_dim)."""
        cfg = self.cfg
        with f32_context(cfg.dtype, x.device):
            b, h, w, _ = x.shape
            c = cfg.hidden_dim
            pos = position_embedding_sine(h, w, c // 2, dtype=cfg.dtype, device=x.device)
            pos = pos.reshape(1, h * w, c).expand(b, -1, -1)
            if self.input_proj is not None:
                x = self.input_proj(x)
            hs, _ = self.transformer(x.reshape(b, h * w, c), self.query_embed.weight, pos=pos)
            mask_embed = self.mask_embed(hs)  # (L, B, Q, mask_dim)
            masks = torch.einsum("lbqc,bhwc->lbqhw", mask_embed.float(),
                                 mask_features.float()).to(cfg.dtype)
            out = {"pred_masks": masks[-1], "decoder_output": hs[-1]}
            if self.class_embed is not None:
                logits = self.class_embed(hs)
                out["pred_logits"] = logits[-1]
                out["aux_outputs"] = [{"pred_logits": logits[i], "pred_masks": masks[i]}
                                      for i in range(hs.shape[0] - 1)]
            else:
                out["aux_outputs"] = [{"pred_masks": masks[i]} for i in range(hs.shape[0] - 1)]
            return out
