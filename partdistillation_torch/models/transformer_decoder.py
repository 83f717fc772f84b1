"""Masked transformer decoder (Mask2Former-style), channel-last.

Counterpart of the JAX package's ``models/transformer_decoder.py``:
``MultiScaleMaskedTransformerDecoder``, whose layers cycle over the feature scales,
each masked cross-attention (through the masked-attention kernel) ->
self-attention -> FFN, post-norm, with a prediction head after every layer
whose thresholded mask logits block the next layer's cross-attention. Both
attention-mask constructions are kept (``attn_mask_from_features``); and
``PartDistillationTransformerDecoder``, the same decoder with the stage-5
per-object-class part classifier (``num_object_classes * num_parts + 1``
columns, each image reading its object class's ``num_parts`` columns and the
no-object column). Parameter names follow detectron2's MultiScaleMaskedTransformerDecoder
(``transformer_{cross,self}_attention_layers.{i}``,
``transformer_ffn_layers.{i}``, ``mask_embed.layers.{i}``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import copy_to_group, reduce_from_group, take_shard
from .attention import MultiHeadAttention
from .layers import Conv, Dense, LayerNorm, normal_, zeros_
from .position_encoding import position_embedding_sine

__all__ = ["TransformerDecoderConfig", "MultiScaleMaskedTransformerDecoder",
           "PartDistillationTransformerDecoder"]


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
    # >0 selects PartDistillationTransformerDecoder's per-object-class head
    num_object_classes: int = 0
    num_parts: int = 8
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
        self._build_class_head()
        self.mask_embed = _MLP(hd, cfg.mask_dim, 3, d)

    def _build_class_head(self):
        self.class_embed = Dense(self.cfg.hidden_dim, self.cfg.num_classes + 1,
                                 dtype=self.cfg.dtype)

    def _class_head(self, gt_object_class: Optional[torch.Tensor]):
        """fn(dec) -> class logits for this forward's images."""
        return self.class_embed

    def reset_parameters_with(self, g: torch.Generator):
        for emb in (self.level_embed, self.query_feat, self.query_embed):
            normal_(emb.weight, g, std=1.0)

    def _layer(self, i: int) -> _DecoderLayer:
        return _DecoderLayer(self.transformer_cross_attention_layers[i],
                             self.transformer_self_attention_layers[i],
                             self.transformer_ffn_layers[i])

    def forward(self, multi_scale_features: List[torch.Tensor], mask_features: torch.Tensor,
                gt_object_class: Optional[torch.Tensor] = None) -> dict:
        """``gt_object_class`` (B,) int: each image's object class, which only
        the part-distillation head reads."""
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

        class_head = self._class_head(gt_object_class)
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
            logits = class_head(dec)
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


class _PartClassHead(nn.Module):
    """The part classifier's (total, hidden) weight and (total,) bias, f32
    (the reference keeps this 176k-way head in float64; only P + 1 columns
    of it are live per image, so f32 logits of the live columns suffice).
    After ``shard`` the weight holds this rank's slice of the hidden
    dimension and ``group`` is the model group the slices are spread over."""

    def __init__(self, hidden: int, total: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(total, hidden))
        self.bias = nn.Parameter(torch.empty(total))
        self.group = None
        self.hidden_range = (0, hidden)

    def shard(self, group, index: int, count: int) -> None:
        """Keep slice ``index`` of ``count`` equal slices of the hidden
        dimension (the JAX package's ``P("model", None)`` on its (hidden,
        cols) kernel); the bias stays whole on every rank."""
        size = self.weight.shape[1] // count
        self.weight = nn.Parameter(take_shard(self.weight.detach(), index, count, dim=1))
        self.group, self.hidden_range = group, (index * size, (index + 1) * size)

    def reset_parameters_with(self, g: torch.Generator):
        # flax's lecun_normal on the (hidden, total) kernel, as Dense
        normal_(self.weight, g, std=1.0 / math.sqrt(self.weight.shape[1]), truncate=True)
        zeros_(self.bias)


class PartDistillationTransformerDecoder(MultiScaleMaskedTransformerDecoder):
    """The decoder with the per-object-class part classifier. For an image of
    object class c only the columns [c P, (c + 1) P) and the last
    (no-object) column get logits and gradients: their rows of the weight
    and bias are gathered once per forward (``index_select``, whose backward
    adds into those rows only) and every prediction head takes a batched
    product with them. This computes the function of both of the JAX
    package's ``head_slice`` forms ("gather" and "onehot"). With the head
    sharded over a model group (``_PartClassHead.shard``) the product is
    split along the hidden dimension and its partial logits summed over the
    group (the bias added once, after the sum)."""

    def _build_class_head(self):
        cfg = self.cfg
        if cfg.num_object_classes <= 0:
            raise ValueError("PartDistillationTransformerDecoder needs num_object_classes > 0")
        self.part_class_embed = _PartClassHead(
            cfg.hidden_dim, cfg.num_object_classes * cfg.num_parts + 1)

    def live_columns(self, gt_object_class: torch.Tensor) -> torch.Tensor:
        """(B, P + 1) column ids: the object class's P part columns, then
        the no-object column."""
        p = self.cfg.num_parts
        total = self.part_class_embed.bias.shape[0]
        oc = torch.as_tensor(gt_object_class, device=self.part_class_embed.bias.device).long()
        cols = oc[:, None] * p + torch.arange(p, device=oc.device)[None]
        return torch.cat([cols, torch.full_like(cols[:, :1], total - 1)], dim=1)

    def _class_head(self, gt_object_class: Optional[torch.Tensor]):
        if gt_object_class is None:
            raise ValueError("PartDistillationTransformerDecoder requires gt_object_class")
        cols = self.live_columns(gt_object_class)
        b, n = cols.shape
        head = self.part_class_embed
        w = head.weight.index_select(0, cols.reshape(-1)).reshape(b, n, -1)  # (B, P+1, C)
        bias = head.bias.index_select(0, cols.reshape(-1)).reshape(b, 1, n)
        if head.group is None:
            return lambda dec: torch.baddbmm(bias, dec.float(), w.transpose(1, 2))
        lo, hi = head.hidden_range

        def sharded(dec):
            # each rank's hidden slice of the features times its slice of the
            # live rows; the partial logits summed over the model group
            x = copy_to_group(dec.float(), head.group)[..., lo:hi]
            return reduce_from_group(torch.bmm(x, w.transpose(1, 2)), head.group) + bias

        return sharded
