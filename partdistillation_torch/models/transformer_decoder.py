"""Masked transformer decoder (Mask2Former-style), channel-last.

Counterpart of the JAX package's ``models/transformer_decoder.py``'s
``MultiScaleMaskedTransformerDecoder``: layers cycle over the feature scales,
each masked cross-attention (through the masked-attention kernel) ->
self-attention -> FFN, post-norm, with a prediction head after every layer
whose thresholded mask logits block the next layer's cross-attention. Both
attention-mask constructions are kept (``attn_mask_from_features``).
Parameter names follow detectron2's MultiScaleMaskedTransformerDecoder
(``transformer_{cross,self}_attention_layers.{i}``,
``transformer_ffn_layers.{i}``, ``mask_embed.layers.{i}``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiHeadAttention
from .layers import Conv, Dense, LayerNorm, normal_
from .position_encoding import position_embedding_sine

__all__ = ["TransformerDecoderConfig", "MultiScaleMaskedTransformerDecoder"]


@dataclasses.dataclass(frozen=True)
class TransformerDecoderConfig:
    num_classes: int = 1
    hidden_dim: int = 256
    num_queries: int = 200
    num_heads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9
    mask_dim: int = 256
    num_feature_levels: int = 3
    # >0 selects the PartDistillation head, which is not ported yet
    num_object_classes: int = 0
    dtype: torch.dtype = torch.float32
    # True: resize mask_features once per key scale and contract the query
    # embedding against it; False: resize each layer's full mask logits
    attn_mask_from_features: bool = True


class _CrossAttentionLayer(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(cfg.hidden_dim, cfg.num_heads,
                                                 cfg.dtype, use_fused=True)
        self.norm = LayerNorm(cfg.hidden_dim, dtype=cfg.dtype)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg.hidden_dim, cfg.num_heads, cfg.dtype)
        self.norm = LayerNorm(cfg.hidden_dim, dtype=cfg.dtype)


class _FFNLayer(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig):
        super().__init__()
        self.linear1 = Dense(cfg.hidden_dim, cfg.dim_feedforward, dtype=cfg.dtype)
        self.linear2 = Dense(cfg.dim_feedforward, cfg.hidden_dim, dtype=cfg.dtype)
        self.norm = LayerNorm(cfg.hidden_dim, dtype=cfg.dtype)


class _DecoderLayer:
    """Masked cross-attention -> self-attention -> FFN, post-norm, over the
    three registered per-layer modules."""

    def __init__(self, ca: _CrossAttentionLayer, sa: _SelfAttentionLayer, ffn: _FFNLayer):
        self.ca, self.sa, self.ffn = ca, sa, ffn

    def __call__(self, q, q_pos, src, src_pos, block_mask):
        q = self.ca.norm(q + self.ca.multihead_attn(q + q_pos, src + src_pos, src, block_mask))
        q = self.sa.norm(q + self.sa.self_attn(q + q_pos, q + q_pos, q, None))
        y = self.ffn.linear2(torch.relu(self.ffn.linear1(q)))
        return self.ffn.norm(q + y)


class _MLP(nn.Module):
    def __init__(self, hidden: int, out: int, layers: int, dtype):
        super().__init__()
        dims = [hidden] * (layers - 1) + [out]
        self.layers = nn.ModuleList([Dense(hidden, o, dtype=dtype) for o in dims])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes, half-pixel centres, no
    antialiasing (torch F.interpolate(align_corners=False) semantics)."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=(h, w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.reshape(tuple(lead) + (h, w))


def _threshold_block_mask(m: torch.Tensor) -> torch.Tensor:
    """(B, Q, h, w) mask logits at the key scale -> (B, 1, Q, h*w) bool block
    mask; rows that would block everything are fully unblocked."""
    b, q, h, w = m.shape
    blocked = torch.sigmoid(m).reshape(b, q, h * w) < 0.5
    blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
    return blocked[:, None]


def _attn_block_mask(mask_logits: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, Q, H, W) mask logits -> (B, 1, Q, h*w) block mask at the next
    layer's scale (resize, then threshold)."""
    return _threshold_block_mask(_resize(mask_logits, hw[0], hw[1]))


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


class MultiScaleMaskedTransformerDecoder(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig, in_channels: int):
        super().__init__()
        if cfg.num_object_classes > 0:
            raise NotImplementedError(
                "PartDistillationTransformerDecoder is not ported yet "
                "(ROADMAP: stage-4/5 part-distillation slice)")
        self.cfg = cfg
        hd, d = cfg.hidden_dim, cfg.dtype
        self.level_embed = nn.Embedding(cfg.num_feature_levels, hd)
        self.input_proj = nn.ModuleList([
            Conv(in_channels, hd, 1, dtype=d) if in_channels != hd else nn.Identity()
            for _ in range(cfg.num_feature_levels)])
        self.query_feat = nn.Embedding(cfg.num_queries, hd)
        self.query_embed = nn.Embedding(cfg.num_queries, hd)
        self.transformer_cross_attention_layers = nn.ModuleList(
            [_CrossAttentionLayer(cfg) for _ in range(cfg.dec_layers)])
        self.transformer_self_attention_layers = nn.ModuleList(
            [_SelfAttentionLayer(cfg) for _ in range(cfg.dec_layers)])
        self.transformer_ffn_layers = nn.ModuleList(
            [_FFNLayer(cfg) for _ in range(cfg.dec_layers)])
        self.decoder_norm = LayerNorm(hd, dtype=d)
        self.class_embed = Dense(hd, cfg.num_classes + 1, dtype=d)
        self.mask_embed = _MLP(hd, cfg.mask_dim, 3, d)

    def reset_parameters_with(self, g: torch.Generator):
        for emb in (self.level_embed, self.query_feat, self.query_embed):
            normal_(emb.weight, g, std=1.0)

    def _layer(self, i: int) -> _DecoderLayer:
        return _DecoderLayer(self.transformer_cross_attention_layers[i],
                             self.transformer_self_attention_layers[i],
                             self.transformer_ffn_layers[i])

    def forward(self, multi_scale_features: List[torch.Tensor],
                mask_features: torch.Tensor) -> dict:
        cfg = self.cfg
        if len(multi_scale_features) != cfg.num_feature_levels:
            raise ValueError(f"expected {cfg.num_feature_levels} feature levels")
        b = mask_features.shape[0]
        hd = cfg.hidden_dim
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale_features):
            _, h, w, _ = x.shape
            sizes.append((h, w))
            x = self.input_proj[i](x)
            srcs.append(x.reshape(b, h * w, hd) + self.level_embed.weight[i][None, None])
            pe = position_embedding_sine(h, w, hd // 2, dtype=cfg.dtype, device=x.device)
            poss.append(pe.reshape(1, h * w, hd).expand(b, -1, -1))

        output = self.query_feat.weight[None].expand(b, -1, -1)
        q_pos = self.query_embed.weight[None].expand(b, -1, -1)

        if cfg.attn_mask_from_features:
            mf_nchw = mask_features.permute(0, 3, 1, 2)
            feats_small = {
                (h, w): F.interpolate(mf_nchw, size=(h, w), mode="bilinear",
                                      align_corners=False, antialias=False).permute(0, 2, 3, 1)
                for (h, w) in set(sizes)}

        def prediction_heads(out, attn_size):
            dec = self.decoder_norm(out)
            logits = self.class_embed(dec)
            membed = self.mask_embed(dec)
            masks = _einsum_f32("bqc,bhwc->bqhw", membed, mask_features).to(cfg.dtype)
            if cfg.attn_mask_from_features:
                m_small = _einsum_f32("bqc,bhwc->bqhw", membed,
                                      feats_small[attn_size]).to(cfg.dtype)
                bmask = _threshold_block_mask(m_small)
            else:
                bmask = _attn_block_mask(masks, attn_size)
            return logits, masks, bmask, dec

        pred_classes, pred_masks = [], []
        logits, masks, bmask, dec = prediction_heads(output, sizes[0])
        pred_classes.append(logits)
        pred_masks.append(masks)
        for i in range(cfg.dec_layers):
            lvl = i % cfg.num_feature_levels
            output = self._layer(i)(output, q_pos, srcs[lvl], poss[lvl], bmask)
            logits, masks, bmask, dec = prediction_heads(
                output, sizes[(i + 1) % cfg.num_feature_levels])
            pred_classes.append(logits)
            pred_masks.append(masks)

        return {
            "pred_logits": pred_classes[-1],
            "pred_masks": pred_masks[-1],
            "decoder_output": dec,
            "aux_outputs": [{"pred_logits": c, "pred_masks": m}
                            for c, m in zip(pred_classes[:-1], pred_masks[:-1])],
        }
