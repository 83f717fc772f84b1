"""The Swin Transformer backbone (Liu et al. 2021; detectron2's D2SwinTransformer
as Mask2Former configures it): the program's ``SwinConfig``, the plain
float32 reference, its level shapes, its DropPath noise, and the weight rule
and the optimizer's no-decay names of its relative-position bias tables."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..reference.model import Conv, Linear, Norm, Rounding, drop_path

NO_DECAY = ("relative_position_bias_table", "absolute_pos_embed")
TINY = {"embed_dim": 16, "depths": [1, 1, 2, 1], "num_heads": [1, 2, 4, 8], "window_size": 4}


def program_config(group: dict, dtype) -> dict:
    from partdistillation_torch.models.swin import SwinConfig

    return {"swin": SwinConfig(patch_size=group["patch_size"], embed_dim=group["embed_dim"],
                               depths=tuple(group["depths"]), num_heads=tuple(group["num_heads"]),
                               window_size=group["window_size"],
                               drop_path_rate=group["drop_path_rate"], dtype=dtype)}


def reference(rnd: Rounding, group: dict) -> Tuple[nn.Module, Dict[str, int]]:
    chans = {f"res{i + 2}": group["embed_dim"] * 2 ** i for i in range(len(group["depths"]))}
    return Swin(rnd, group), chans


def level_shapes(size: int, group: dict) -> List[Tuple[int, int]]:
    p = group["patch_size"]
    out = []
    for s in (3, 2, 1):
        h = -(-size // p)
        for _ in range(s):
            h = -(-h // 2)
        out.append((h, h))
    return out


def stage_sizes(size: int, group: dict) -> List[int]:
    h = -(-size // group["patch_size"])
    out = []
    for _ in group["depths"]:
        out.append(h)
        h = -(-h // 2)
    return out


def draw_noise(group: dict, b: int, uniform) -> Dict[str, torch.Tensor]:
    """DropPath keep decisions (blocks, 2, B): the attention and the MLP
    branch of each block, the rate rising linearly over the blocks."""
    blocks = sum(group["depths"])
    rates = torch.linspace(0.0, group["drop_path_rate"], blocks, dtype=torch.float64)
    keep = (1.0 - rates).float()
    draws = uniform(blocks, 2, b)
    return {"drop_keep": draws < keep.to(draws.device)[:, None, None]}


def weight_rule(name: str, p, kind: str):
    if name.rsplit(".", 1)[-1] == "relative_position_bias_table":
        return "normal", 0.02, True
    return None


def relative_position_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1).to(device)


def shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, N, N) additive mask of the shifted windows, -100 across regions."""
    img = torch.zeros(hp, wp, dtype=torch.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, :, None] != wins[:, None, :]
    return torch.where(diff, -100.0, 0.0).to(device)


class WindowAttention(nn.Module):
    kind = "window_attention"

    def __init__(self, rnd: Rounding, dim: int, heads: int, ws: int):
        super().__init__()
        self.rnd, self.heads, self.ws = rnd, heads, ws
        self.qkv = Linear(rnd, dim, 3 * dim)
        self.proj = Linear(rnd, dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))

    def forward(self, x, mask):
        """x (windows, N, C); mask (nW, N, N) or None, windows image-major."""
        bw, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (c // h) ** -0.5, qkv[1], qkv[2]
        idx = relative_position_index(self.ws, x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        attn = self.rnd.mm(q, k.transpose(-1, -2)) + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]).reshape(bw, h, n, n)
        out = self.rnd.mm(attn.softmax(-1), v)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, rnd, dim, hidden):
        super().__init__()
        self.fc1 = Linear(rnd, dim, hidden)
        self.fc2 = Linear(rnd, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, rnd, dim, heads, ws, shift, rate):
        super().__init__()
        self.ws, self.shift, self.rate = ws, shift, rate
        self.norm1 = Norm(dim)
        self.attn = WindowAttention(rnd, dim, heads, ws)
        self.norm2 = Norm(dim)
        self.mlp = Mlp(rnd, dim, 4 * dim)

    def forward(self, x, keep):
        b, h, w, c = x.shape
        ws = self.ws
        shift = self.shift if min(h, w) > ws else 0
        y = self.norm1(x)
        pb, pr = (ws - h % ws) % ws, (ws - w % ws) % ws
        y = F.pad(y, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = shift_mask(hp, wp, ws, shift, x.device)
        win = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = self.attn(win.reshape(-1, ws * ws, c), mask)
        y = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + drop_path(y[:, :h, :w], None if keep is None else keep[0], self.rate)
        return x + drop_path(self.mlp(self.norm2(x)), None if keep is None else keep[1],
                             self.rate)


class PatchMerging(nn.Module):
    def __init__(self, rnd, dim):
        super().__init__()
        self.norm = Norm(4 * dim)
        self.reduction = Linear(rnd, 4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, rnd, patch, dim):
        super().__init__()
        self.proj = Conv(rnd, 3, dim, patch, stride=patch)
        self.norm = Norm(dim)


class Stage(nn.Module):
    def __init__(self, rnd, dim, depth, heads, ws, rates, last):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(rnd, dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                                               rates[i]) for i in range(depth)])
        self.downsample = None if last else PatchMerging(rnd, dim)


class Swin(nn.Module):
    def __init__(self, rnd: Rounding, cfg: dict):
        super().__init__()
        self.cfg = cfg
        dims = [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]
        n = sum(cfg["depths"])
        rates = [cfg["drop_path_rate"] * i / max(n - 1, 1) for i in range(n)]
        self.rates = rates
        self.patch_embed = PatchEmbed(rnd, cfg["patch_size"], cfg["embed_dim"])
        first = 0
        self.layers = nn.ModuleList()
        for s, depth in enumerate(cfg["depths"]):
            self.layers.append(Stage(rnd, dims[s], depth, cfg["num_heads"][s],
                                     cfg["window_size"], rates[first:first + depth],
                                     s == len(dims) - 1))
            first += depth
        for s, d in enumerate(dims):
            self.add_module(f"norm{s}", Norm(d))

    def forward(self, x, drop_keep=None) -> Dict[str, torch.Tensor]:
        p = self.cfg["patch_size"]
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.patch_embed.norm(self.patch_embed.proj(x))
        outs, i = {}, 0
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, None if drop_keep is None else drop_keep[i])
                i += 1
            outs[f"res{s + 2}"] = getattr(self, f"norm{s}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
