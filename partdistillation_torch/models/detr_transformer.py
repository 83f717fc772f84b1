"""DETR transformer encoder / decoder stacks, batch-first and channel-last.

Counterpart of the JAX package's ``models/detr_transformer.py``: pre- or
post-norm encoder and decoder layers with the positional embedding added to
the queries and keys of every attention, a decoder that returns every
layer's normed output for deep supervision, and no dropout. They back the
MaskFormer-v1 heads (``fpn.TransformerEncoderPixelDecoder``,
``maskformer_decoder.StandardTransformerDecoder``). LayerNorms take
eps = 1e-5. Parameter names follow the reference's ``transformer.py``
(``self_attn`` / ``multihead_attn`` as ``torch.nn.MultiheadAttention``
packs them, ``linear1`` / ``linear2``, ``norm1``-``norm3``,
``encoder.layers.{i}``, ``decoder.norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .attention import MultiHeadAttention
from .layers import Dense, LayerNorm

__all__ = ["DETRTransformerConfig", "TransformerEncoderLayer", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerDecoder", "TransformerEncoderOnly", "Transformer"]


@dataclasses.dataclass(frozen=True)
class DETRTransformerConfig:
    d_model: int = 256
    num_heads: int = 8
    dim_feedforward: int = 2048
    num_encoder_layers: int = 0
    num_decoder_layers: int = 6
    pre_norm: bool = False
    return_intermediate: bool = True
    dtype: torch.dtype = torch.float32


def _block(key_padding_mask: Optional[torch.Tensor]):
    """(B, K) True = padded -> (B, 1, 1, K) blocking mask."""
    return None if key_padding_mask is None else key_padding_mask[:, None, None, :]


def _with(x, pos):
    return x if pos is None else x + pos


class TransformerEncoderLayer(nn.Module):
    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        d, c = cfg.dtype, cfg.d_model
        self.pre_norm = cfg.pre_norm
        self.self_attn = MultiHeadAttention(c, cfg.num_heads, dtype=d)
        self.linear1 = Dense(c, cfg.dim_feedforward, dtype=d)
        self.linear2 = Dense(cfg.dim_feedforward, c, dtype=d)
        self.norm1 = LayerNorm(c, eps=1e-5, dtype=d)
        self.norm2 = LayerNorm(c, eps=1e-5, dtype=d)

    def ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))

    def forward(self, src, pos=None, key_padding_mask=None):
        block = _block(key_padding_mask)
        if self.pre_norm:
            x = self.norm1(src)
            src = src + self.self_attn(_with(x, pos), _with(x, pos), x, block)
            return src + self.ffn(self.norm2(src))
        src = self.norm1(src + self.self_attn(_with(src, pos), _with(src, pos), src, block))
        return self.norm2(src + self.ffn(src))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        d, c = cfg.dtype, cfg.d_model
        self.pre_norm = cfg.pre_norm
        self.self_attn = MultiHeadAttention(c, cfg.num_heads, dtype=d)
        self.multihead_attn = MultiHeadAttention(c, cfg.num_heads, dtype=d)
        self.linear1 = Dense(c, cfg.dim_feedforward, dtype=d)
        self.linear2 = Dense(cfg.dim_feedforward, c, dtype=d)
        self.norm1 = LayerNorm(c, eps=1e-5, dtype=d)
        self.norm2 = LayerNorm(c, eps=1e-5, dtype=d)
        self.norm3 = LayerNorm(c, eps=1e-5, dtype=d)

    def ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))

    def forward(self, tgt, memory, query_pos=None, pos=None, memory_key_padding_mask=None):
        block = _block(memory_key_padding_mask)
        if self.pre_norm:
            x = self.norm1(tgt)
            tgt = tgt + self.self_attn(_with(x, query_pos), _with(x, query_pos), x, None)
            x = self.norm2(tgt)
            tgt = tgt + self.multihead_attn(_with(x, query_pos), _with(memory, pos), memory,
                                            block)
            return tgt + self.ffn(self.norm3(tgt))
        tgt = self.norm1(tgt + self.self_attn(_with(tgt, query_pos), _with(tgt, query_pos), tgt,
                                              None))
        tgt = self.norm2(tgt + self.multihead_attn(_with(tgt, query_pos), _with(memory, pos),
                                                   memory, block))
        return self.norm3(tgt + self.ffn(tgt))


class TransformerEncoder(nn.Module):
    """The encoder layers, then (pre-norm only) a final LayerNorm."""

    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList([TransformerEncoderLayer(cfg)
                                     for _ in range(cfg.num_encoder_layers)])
        self.norm = (LayerNorm(cfg.d_model, eps=1e-5, dtype=cfg.dtype)
                     if cfg.pre_norm and cfg.num_encoder_layers > 0 else None)

    def forward(self, src, pos=None, key_padding_mask=None):
        for layer in self.layers:
            src = layer(src, pos=pos, key_padding_mask=key_padding_mask)
        return src if self.norm is None else self.norm(src)


class TransformerDecoder(nn.Module):
    """(L, B, Q, C): every layer's output through the shared final norm when
    ``return_intermediate``, else (1, B, Q, C) of the last layer's."""

    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        self.return_intermediate = cfg.return_intermediate
        self.layers = nn.ModuleList([TransformerDecoderLayer(cfg)
                                     for _ in range(cfg.num_decoder_layers)])
        self.norm = LayerNorm(cfg.d_model, eps=1e-5, dtype=cfg.dtype)

    def forward(self, tgt, memory, query_pos=None, pos=None, memory_key_padding_mask=None):
        intermediates = []
        for layer in self.layers:
            tgt = layer(tgt, memory, query_pos=query_pos, pos=pos,
                        memory_key_padding_mask=memory_key_padding_mask)
            if self.return_intermediate:
                intermediates.append(self.norm(tgt))
        if self.return_intermediate:
            return torch.stack(intermediates)
        return self.norm(tgt)[None]


class TransformerEncoderOnly(nn.Module):
    """The encoder alone, under ``encoder`` (the reference's
    ``TransformerEncoderOnly``, the transformer-FPN's)."""

    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        self.encoder = TransformerEncoder(cfg)

    def forward(self, src, pos=None, key_padding_mask=None):
        return self.encoder(src, pos=pos, key_padding_mask=key_padding_mask)


class Transformer(nn.Module):
    """Encoder + decoder over a flattened map: src (B, S, C), query_embed
    (Q, C) learned query positions, pos (B, S, C) -> (hs (L | 1, B, Q, C),
    memory (B, S, C)); the decoder starts from zeros."""

    def __init__(self, cfg: DETRTransformerConfig):
        super().__init__()
        self.encoder = TransformerEncoder(cfg)
        self.decoder = TransformerDecoder(cfg)

    def forward(self, src, query_embed, pos=None, key_padding_mask=None):
        memory = self.encoder(src, pos=pos, key_padding_mask=key_padding_mask)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        hs = self.decoder(tgt, memory, query_pos=query_pos, pos=pos,
                          memory_key_padding_mask=key_padding_mask)
        return hs, memory
