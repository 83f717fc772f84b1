"""Seeded weights of a configuration, made on the device in a few large calls.

One ``torch.Generator`` on the device, seeded from the run's seed, draws
every random number in two calls: one normal buffer for all normal leaves
(truncated at two standard deviations where the rule says so) and nothing
else. Each leaf is then a scaled view of that buffer or a constant, by the
kind of module that owns it (the reference's module kinds, whose parameter
names are the program's):

- linear / conv / attention in-projections: truncated normal, std 1/sqrt(fan_in);
- norms: weight 1, bias 0; every other bias 0;
- the backbone's own leaves by its ``weight_rule`` (Swin's relative-position
  bias tables: truncated normal, std 0.02);
- level, query and position embeddings: normal, std 1;
- deformable attention: sampling offsets' weight 0 and bias the rotated
  grid of Deformable DETR (point p of head h at (p + 1) (cos, sin) of
  2 pi h / H, scaled so that max |coord| = 1); attention weights 0.

Parameters are float32, as the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import backbones
from .reference.model import PixelDecoder, Segmenter, leaves


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    th = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    g = torch.stack([th.cos(), th.sin()], -1)
    g = g / g.abs().max(-1, keepdim=True).values
    g = g[:, None, None, :].repeat(1, levels, points, 1)
    g = g * torch.arange(1, points + 1, dtype=torch.float64)[None, None, :, None]
    return g.reshape(-1).float()


def _rule(name: str, p, kind: str, backbone):
    """(fill, std, truncate): fill one of "normal", "zero", "one", "grid"."""
    own = backbone.weight_rule(name, p, kind) if name.startswith("backbone.") else None
    if own is not None:
        return own
    leaf = name.rsplit(".", 1)[-1]
    if kind == "norm":
        return ("one" if leaf == "weight" else "zero"), 0.0, False
    if leaf in ("bias", "in_proj_bias"):
        return ("grid" if ".sampling_offsets." in name else "zero"), 0.0, False
    if ".sampling_offsets." in name or ".attention_weights." in name:
        return "zero", 0.0, False
    if kind == "embedding" or leaf == "level_embed":
        return "normal", 1.0, False
    fan_in = p.shape[1] * (p.shape[2] * p.shape[3] if p.dim() == 4 else 1)
    return "normal", 1.0 / math.sqrt(fan_in), True


def make_weights(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model_cfg`` (a configuration's ``model`` group)
    drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        ref = Segmenter(model_cfg)
    backbone, _ = backbones.load(model_cfg)
    plan = [(n, p.shape, _rule(n, p, kind, backbone)) for n, p, kind in leaves(ref)]
    total = sum(math.prod(s) for _, s, (fill, _, _) in plan if fill == "normal")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    buf = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    pd = model_cfg["pixel_decoder"]
    grid = offset_grid(pd["n_heads"], len(PixelDecoder.IN), pd["n_points"]).to(device)
    for name, shape, (fill, std, truncate) in plan:
        if fill == "normal":
            n = math.prod(shape)
            view = buf[at:at + n]
            at += n
            if truncate:
                view = view.clamp(-2.0, 2.0)
            out[name] = (view * std).reshape(shape)
        elif fill == "grid":
            out[name] = grid.clone()
        else:
            out[name] = torch.full(shape, 1.0 if fill == "one" else 0.0, device=device)
    return out
