"""The ViTDet backbone (Li et al. 2022; detectron2's ``ViT`` and
``SimpleFeaturePyramid`` as ``projects/ViTDet`` configures them): the
program's ``ViTDetConfig``, the plain float32 reference, its level shapes,
its DropPath noise, and the weight rule and the optimizer's no-decay name of
its position tables.

The reference follows the published description: a plain ViT (16 x 16
patches, the pretraining grid's absolute positions resized bicubically to
the token grid, window attention with zero-padded windows whose padded
tokens are keys, global attention in the configuration's other blocks, both
with decomposed relative positions from the unscaled q), then the simple
feature pyramid (transposed convolutions, max pooling, 1 x 1 and 3 x 3
convolutions with channel LayerNorms). Every product rounds its operands
through ``Rounding``. Each block is recomputed in the backward
(``torch.utils.checkpoint``) so that four 1024 x 1024 images fit the card in
float32; on ``meta`` tensors (the FLOP count) the blocks run once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..reference.model import Conv, Linear, Norm, Rounding, drop_path

NO_DECAY = ("pos_embed",)
TINY = {"img_size": 64, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
        "window_size": 3, "window_block_indexes": [0], "pretrain_img_size": 32,
        "out_channels": 32}


# the configuration's keys that describe the published model and that the
# program and this reference build in, whatever they read: each must hold
# its published value
PUBLISHED = {"qkv_bias": True, "use_rel_pos": True, "use_abs_pos": True,
             "residual_block_indexes": [], "norm": "LN", "pretrain_use_cls_token": True,
             "scale_factors": [4.0, 2.0, 1.0, 0.5]}


def published(group: dict) -> dict:
    """``group``, refused unless each of ``PUBLISHED``'s keys holds its
    published value."""
    other = {k: group.get(k) for k, v in PUBLISHED.items() if group.get(k) != v}
    if other:
        raise ValueError(f"vitdet: {other} differ from the published {PUBLISHED}")
    return group


def global_blocks(group: dict) -> Tuple[int, ...]:
    """The blocks outside ``window_block_indexes``: global attention."""
    return tuple(i for i in range(group["depth"]) if i not in group["window_block_indexes"])


def program_config(group: dict, dtype) -> dict:
    from partdistillation_torch.models.vitdet import ViTDetConfig

    published(group)
    return {"vitdet": ViTDetConfig(
        img_size=group["img_size"], patch_size=group["patch_size"],
        embed_dim=group["embed_dim"], depth=group["depth"], num_heads=group["num_heads"],
        mlp_ratio=group["mlp_ratio"], norm_eps=group["norm_eps"],
        drop_path_rate=group["drop_path_rate"], window_size=group["window_size"],
        global_block_indexes=global_blocks(group),
        pretrain_img_size=group["pretrain_img_size"], out_dim=group["out_channels"],
        dtype=dtype)}


def _stage(group: dict, scale: float) -> int:
    """The pyramid level of a scale factor: log2 of its stride."""
    return int(round(math.log2(group["patch_size"] / scale)))


def reference(rnd: Rounding, group: dict) -> Tuple[nn.Module, Dict[str, int]]:
    chans = {f"res{_stage(group, s)}": group["out_channels"]
             for s in published(group)["scale_factors"]}
    return ViTDet(rnd, group), chans


def level_shapes(size: int, group: dict) -> List[Tuple[int, int]]:
    g = size // group["patch_size"]
    return [(g // 2, g // 2), (g, g), (2 * g, 2 * g)]


def stage_sizes(size: int, group: dict) -> List[int]:
    return [size // group["patch_size"]]


def draw_noise(group: dict, b: int, uniform) -> Dict[str, torch.Tensor]:
    """DropPath keep decisions (blocks, 2, B): the attention and the MLP
    branch of each block, the rate rising linearly over the blocks."""
    blocks = group["depth"]
    rates = torch.linspace(0.0, group["drop_path_rate"], blocks, dtype=torch.float64)
    keep = (1.0 - rates).float()
    draws = uniform(blocks, 2, b)
    return {"drop_keep": draws < keep.to(draws.device)[:, None, None]}


def weight_rule(name: str, p, kind: str):
    """The position tables: truncated normal, std 0.02 (upstream draws the
    relative tables as zeros, under which a program that dropped them would
    pass every check); the transposed convolutions: fan-in = input
    channels."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
        return "normal", 0.02, True
    if kind == "conv_transpose" and leaf == "weight":
        return "normal", p.shape[0] ** -0.5, True
    return None


class Attention(nn.Module):
    kind = "attention"

    def __init__(self, rnd: Rounding, dim: int, heads: int, size: int):
        super().__init__()
        self.rnd, self.heads = rnd, heads
        self.qkv = Linear(rnd, dim, 3 * dim)
        self.proj = Linear(rnd, dim, dim)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * size - 1, dim // heads))

    def forward(self, x):
        """x (B, H, W, C): self-attention over the H x W grid."""
        b, h, w, c = x.shape
        heads, d = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, d).unbind(0)
        attn = self.rnd.mm(q * d ** -0.5, k.transpose(-2, -1))
        ih, iw = torch.arange(h, device=x.device), torch.arange(w, device=x.device)
        rh = self.rel_pos_h[ih[:, None] - ih[None, :] + h - 1]
        rw = self.rel_pos_w[iw[:, None] - iw[None, :] + w - 1]
        r_q = self.rnd(q).reshape(b * heads, h, w, d)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, self.rnd(rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, self.rnd(rw))
        attn = (attn.reshape(-1, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).reshape(-1, h * w, h * w)
        out = self.rnd.mm(attn.softmax(-1), v)
        out = out.reshape(b, heads, h, w, d).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, rnd, dim, hidden):
        super().__init__()
        self.fc1 = Linear(rnd, dim, hidden)
        self.fc2 = Linear(rnd, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, rnd, group: dict, rate: float, window: int):
        super().__init__()
        dim, eps = group["embed_dim"], group["norm_eps"]
        self.rate, self.window = rate, window
        self.norm1 = Norm(dim, eps=eps)
        size = window or group["img_size"] // group["patch_size"]
        self.attn = Attention(rnd, dim, group["num_heads"], size)
        self.norm2 = Norm(dim, eps=eps)
        self.mlp = Mlp(rnd, dim, int(dim * group["mlp_ratio"]))

    def forward(self, x, keep):
        y = self.norm1(x)
        ws = self.window
        if ws:
            b, h, w, c = y.shape
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            win = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            out = self.attn(win.reshape(-1, ws, ws, c))
            y = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            y = self.attn(y)
        x = x + drop_path(y, None if keep is None else keep[0], self.rate)
        return x + drop_path(self.mlp(self.norm2(x)), None if keep is None else keep[1],
                             self.rate)


class PatchEmbed(nn.Module):
    def __init__(self, rnd, patch, dim):
        super().__init__()
        self.proj = Conv(rnd, 3, dim, patch, stride=patch)


class ViT(nn.Module):
    def __init__(self, rnd: Rounding, group: dict):
        super().__init__()
        self.group = group
        n = group["depth"]
        self.rates = [group["drop_path_rate"] * i / max(n - 1, 1) for i in range(n)]
        self.patch_embed = PatchEmbed(rnd, group["patch_size"], group["embed_dim"])
        grid = group["pretrain_img_size"] // group["patch_size"]
        self.pos_embed = nn.Parameter(torch.empty(
            1, grid * grid + int(group["pretrain_use_cls_token"]), group["embed_dim"]))
        windows = group["window_block_indexes"]
        self.blocks = nn.ModuleList([
            Block(rnd, group, self.rates[i], group["window_size"] if i in windows else 0)
            for i in range(n)])

    def forward(self, x, drop_keep=None):
        x = self.patch_embed.proj(x)
        h, w = x.shape[1:3]
        pos = self.pos_embed[:, 1:] if self.group["pretrain_use_cls_token"] else self.pos_embed
        s = int(round(pos.shape[1] ** 0.5))
        pos = pos.reshape(1, s, s, -1).permute(0, 3, 1, 2)
        if (s, s) != (h, w):
            pos = F.interpolate(pos, size=(h, w), mode="bicubic", align_corners=False)
        x = x + pos.permute(0, 2, 3, 1)
        for i, blk in enumerate(self.blocks):
            keep = None if drop_keep is None else drop_keep[i]
            if torch.is_grad_enabled() and not x.is_meta:
                x = checkpoint(blk, x, keep, use_reentrant=False)
            else:
                x = blk(x, keep)
        return x


class ConvT(nn.Module):
    """A 2 x 2, stride-2 transposed convolution, channel-last."""
    kind = "conv_transpose"

    def __init__(self, rnd: Rounding, c_in: int, c_out: int):
        super().__init__()
        self.rnd = rnd
        self.weight = nn.Parameter(torch.empty(c_in, c_out, 2, 2))
        self.bias = nn.Parameter(torch.empty(c_out))

    def forward(self, x):
        y = F.conv_transpose2d(self.rnd(x.permute(0, 3, 1, 2)), self.rnd(self.weight),
                               self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class Gelu(nn.Module):
    def forward(self, x):
        return F.gelu(x)


class MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ConvLN(Conv):
    """A convolution without bias, then a channel LayerNorm (``.norm``)."""

    def __init__(self, rnd, c_in, c_out, k, eps):
        super().__init__(rnd, c_in, c_out, k, bias=False)
        self.norm = Norm(c_out, eps=eps)

    def forward(self, x):
        return self.norm(super().forward(x))


class ViTDet(nn.Module):
    def __init__(self, rnd: Rounding, group: dict):
        super().__init__()
        self.group = group
        self.net = ViT(rnd, group)
        dim, out, eps = group["embed_dim"], group["out_channels"], group["norm_eps"]
        for scale in group["scale_factors"]:
            if scale == 4.0:
                layers = [ConvT(rnd, dim, dim // 2), Norm(dim // 2, eps=eps), Gelu(),
                          ConvT(rnd, dim // 2, dim // 4)]
                width = dim // 4
            elif scale == 2.0:
                layers, width = [ConvT(rnd, dim, dim // 2)], dim // 2
            elif scale == 1.0:
                layers, width = [], dim
            else:
                layers, width = [MaxPool()], dim
            layers += [ConvLN(rnd, width, out, 1, eps), ConvLN(rnd, out, out, 3, eps)]
            self.add_module(f"simfp_{_stage(group, scale)}", nn.Sequential(*layers))

    def forward(self, x, drop_keep=None) -> Dict[str, torch.Tensor]:
        feat = self.net(x, drop_keep)
        levels = [_stage(self.group, s) for s in self.group["scale_factors"]]
        return {f"res{i}": getattr(self, f"simfp_{i}")(feat) for i in levels}
