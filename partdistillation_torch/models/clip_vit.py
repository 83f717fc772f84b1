"""CLIP ViT vision tower for stage-1 region scoring.

Counterpart of the JAX package's ``models/clip_vit.py``, with the numerics of
its flax modules (f32 parameters cast to the compute dtype at each product,
LayerNorm statistics in f32, attention logits and softmax in f32) and the
module names of transformers' ``CLIPVisionModelWithProjection``, so that its
``state_dict`` (or a full ``CLIPModel``'s) loads as it is:
``vision_model.embeddings.{class_embedding, patch_embedding.weight,
position_embedding.weight}``, ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm1,
mlp.fc1, mlp.fc2, layer_norm2}``, ``vision_model.post_layernorm``,
``visual_projection.weight``.

Architecture: patch-embedding convolution (no bias) + class token + learned
absolute positions -> pre-LayerNorm -> L x (LN -> MHA -> residual, LN ->
MLP(quick_gelu) -> residual) -> post-LayerNorm of the class token -> linear
projection (no bias). Inputs of any patch multiple work: the position grid
is resized by ``vit_utils.get_abs_pos``. An f32 tower computes inside
``utils.precision.full_f32``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..utils.precision import full_f32
from .layers import Dense, LayerNorm, init_weights, normal_, scalar_like
from .vit_utils import PatchEmbed, get_abs_pos

__all__ = ["CLIPVisionTowerConfig", "CLIPVisionTower", "quick_gelu", "config_from_hf",
           "normalize_clip_pixels", "CLIP_PIXEL_MEAN", "CLIP_PIXEL_STD"]

# CLIP's preprocessing constants (the OpenAI release, HF CLIPProcessor's
# defaults), in [0, 1] pixel scale
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionTowerConfig:
    """Defaults: CLIP ViT-B/32 (the checkpoint the reference's Detic uses)."""

    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(scalar_like(1.702, x) * x)


def compute_context(dtype: torch.dtype, device):
    """Full f32 precision for an f32 tower; a bf16 tower needs none."""
    return full_f32(device) if dtype == torch.float32 else contextlib.nullcontext()


class CLIPAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        c, d = cfg.hidden_size, cfg.dtype
        self.q_proj = Dense(c, c, dtype=d)
        self.k_proj = Dense(c, c, dtype=d)
        self.v_proj = Dense(c, c, dtype=d)
        self.out_proj = Dense(c, c, dtype=d)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        hd = c.hidden_size // c.num_heads
        q = self.q_proj(x)
        q = (q * scalar_like(hd ** -0.5, q)).reshape(b, n, c.num_heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, n, c.num_heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, n, c.num_heads, hd).transpose(1, 2)
        # a short sequence (50 tokens at 224 / 32, 77 for text): the logits
        # and the softmax in f32 (exact products of bf16 values)
        logits = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            logits = logits + bias  # the text tower's causal mask
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, n, -1)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=cfg.dtype)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN transformer block (JAX ``_Block``)."""

    def __init__(self, cfg):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class EmbeddingTable(nn.Module):
    """A learned (num, dim) table, its key ``weight`` as in HF (``position_embedding.weight``,
    ``token_embedding.weight``)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.weight, g, std=0.02)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionTowerConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = PatchEmbed(3, cfg.hidden_size, (p, p), (p, p), bias=False,
                                          dtype=cfg.dtype)
        grid = cfg.image_size // p
        self.position_embedding = EmbeddingTable(grid * grid + 1, cfg.hidden_size)

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.class_embedding, g, std=0.02)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b = pixels.shape[0]
        grid = c.image_size // c.patch_size
        x = self.patch_embedding(pixels)
        h, w = x.shape[1:3]
        pos = self.position_embedding.weight
        if (h, w) != (grid, grid):
            grid_pos = get_abs_pos(pos[None], True, (h, w)).reshape(1, h * w, c.hidden_size)
        else:
            grid_pos = pos[None, 1:]
        x = x.reshape(b, h * w, c.hidden_size) + grid_pos.to(c.dtype)
        cls_tok = (self.class_embedding + pos[0]).to(c.dtype)
        return torch.cat([cls_tok.expand(b, 1, c.hidden_size), x], dim=1)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionTowerConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0])


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) CLIP-normalised pixels -> (B, projection_dim) image
    embeddings (not L2-normalised). Built on ``device`` (``cuda`` unless told
    otherwise) with weights drawn from ``seed``; ``load_state_dict`` takes an
    HF state_dict (``strict=False`` for a full ``CLIPModel``'s)."""

    def __init__(self, cfg: CLIPVisionTowerConfig = CLIPVisionTowerConfig(), device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device("meta"):
            self.vision_model = CLIPVisionTransformer(cfg)
            self.visual_projection = Dense(cfg.hidden_size, cfg.projection_dim, bias=False,
                                           dtype=cfg.dtype)
        self.to_empty(device=dev)
        init_weights(self, seed)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        with compute_context(self.cfg.dtype, pixels.device):
            return self.visual_projection(self.vision_model(pixels))


def config_from_hf(hf_cfg) -> CLIPVisionTowerConfig:
    """The tower's config from a transformers ``CLIPVisionConfig``."""
    return CLIPVisionTowerConfig(
        image_size=hf_cfg.image_size, patch_size=hf_cfg.patch_size,
        hidden_size=hf_cfg.hidden_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads, intermediate_size=hf_cfg.intermediate_size,
        projection_dim=hf_cfg.projection_dim, layer_norm_eps=hf_cfg.layer_norm_eps)


def normalize_clip_pixels(images_01: torch.Tensor) -> torch.Tensor:
    """[0, 1]-scaled (B, H, W, 3) -> CLIP-normalised pixels."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=images_01.dtype, device=images_01.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=images_01.dtype, device=images_01.device)
    return (images_01 - mean) / std
