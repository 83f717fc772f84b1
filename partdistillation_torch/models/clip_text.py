"""CLIP text tower for stage-1 open-vocabulary labels.

Counterpart of the JAX package's ``models/clip_text.py`` with the module
names of transformers' ``CLIPTextModelWithProjection``
(``text_model.embeddings.{token_embedding, position_embedding}.weight``,
``text_model.encoder.layers.{i}...``, ``text_model.final_layer_norm``,
``text_projection.weight``), so that its ``state_dict`` loads as it is.

Token embedding + learned absolute positions -> L x pre-LN blocks under a
causal mask (``clip_vit.CLIPEncoderLayer``) -> final LayerNorm -> the hidden
state at the first position holding ``eos_token_id`` (HF's pooling) ->
linear projection (no bias). CLIP pads after the end-of-text token, and the
causal mask keeps that position from seeing the padding, so the pooled
embedding does not depend on it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from .clip_vit import CLIPEncoder, EmbeddingTable, compute_context
from .layers import Dense, LayerNorm, init_weights

__all__ = ["CLIPTextTowerConfig", "CLIPTextTower", "causal_mask", "text_config_from_hf"]


@dataclasses.dataclass(frozen=True)
class CLIPTextTowerConfig:
    """Defaults: CLIP ViT-B/32's text encoder."""

    vocab_size: int = 49408
    max_positions: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    # pooled at the first token equal to this id (HF's semantics)
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32


def causal_mask(t: int, device) -> torch.Tensor:
    """(1, 1, T, T) additive f32 mask: query q sees the keys k <= q."""
    keep = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), device=device)
    return torch.where(keep, zero, torch.full_like(zero, float("-inf")))[None, None]


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextTowerConfig):
        super().__init__()
        self.token_embedding = EmbeddingTable(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = EmbeddingTable(cfg.max_positions, cfg.hidden_size)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        t = token_ids.shape[1]
        x = self.embeddings.token_embedding.weight[token_ids].to(c.dtype)
        x = x + self.embeddings.position_embedding.weight[None, :t].to(c.dtype)
        x = self.final_layer_norm(self.encoder(x, causal_mask(t, x.device)))
        eot = (token_ids == c.eos_token_id).int().argmax(-1)  # the first end-of-text
        return x[torch.arange(x.shape[0], device=x.device), eot]


class CLIPTextTower(nn.Module):
    """(B, T) token ids (T <= max_positions) -> (B, projection_dim) text
    embeddings (not L2-normalised). Built on ``device`` (``cuda`` unless told
    otherwise) with weights drawn from ``seed``."""

    def __init__(self, cfg: CLIPTextTowerConfig = CLIPTextTowerConfig(), device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device("meta"):
            self.text_model = CLIPTextTransformer(cfg)
            self.text_projection = Dense(cfg.hidden_size, cfg.projection_dim, bias=False,
                                         dtype=cfg.dtype)
        self.to_empty(device=dev)
        init_weights(self, seed)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        token_ids = torch.as_tensor(token_ids, device=self.text_projection.weight.device)
        with compute_context(self.cfg.dtype, token_ids.device):
            return self.text_projection(self.text_model(token_ids.long()))


def text_config_from_hf(hf_cfg) -> CLIPTextTowerConfig:
    """The tower's config from a transformers ``CLIPTextConfig``."""
    return CLIPTextTowerConfig(
        vocab_size=hf_cfg.vocab_size, max_positions=hf_cfg.max_position_embeddings,
        hidden_size=hf_cfg.hidden_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads, intermediate_size=hf_cfg.intermediate_size,
        projection_dim=hf_cfg.projection_dim, layer_norm_eps=hf_cfg.layer_norm_eps,
        eos_token_id=hf_cfg.eos_token_id)
