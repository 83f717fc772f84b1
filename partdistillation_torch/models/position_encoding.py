"""2-D sine/cosine positional encoding (DETR-style, normalize=True, scale=2*pi).

Counterpart of the JAX package's ``models/position_encoding.py``;
channel-last output.
"""

from __future__ import annotations

import math

import torch

__all__ = ["position_embedding_sine"]


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """Returns (H, W, 2 * num_pos_feats) sine PE (y features first, then x)."""
    scale = 2.0 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = (x[:, :, None] / dim_t).expand(h, w, num_pos_feats)
    pos_y = (y[:, :, None] / dim_t).expand(h, w, num_pos_feats)

    def interleave(pe):
        return torch.stack([torch.sin(pe[..., 0::2]), torch.cos(pe[..., 1::2])],
                           dim=-1).reshape(h, w, -1)

    return torch.cat([interleave(pos_y), interleave(pos_x)], dim=-1).to(dtype)
