"""Plain float32 Mask2Former segmenter: the configuration's backbone
(``backbones/<group>.py``) -> MSDeformAttn pixel decoder -> masked transformer
decoder, channel-last, in plain ``torch`` operations.

This is the benchmark's own reference of the measured model. It imports
nothing of the program. It follows the published description (the backbone's,
Deformable DETR's multi-scale deformable attention with a dense bilinear
sampling, Mask2Former's masked decoder) and takes the parameter names of
detectron2's checkpoints, so one state dict loads into it and into the
program. Every product of two tensors (linear layers, convolutions,
attention, mask logits) rounds its operands through ``Rounding``: exact in
``f32``, or to ``bf16`` / scaled ``fp8`` (e4m3) for the control runs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import backbones

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
FP8_MAX = 448.0


class Rounding:
    """Operand rounding of every product: ``f32`` (none), ``bf16`` or
    ``fp8`` (float8 e4m3 with one scale per tensor, amax to 448)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()  # the rounded value, the identity's gradient

    def mm(self, a, b):
        return torch.matmul(self(a), self(b))


class Linear(nn.Module):
    kind = "linear"

    def __init__(self, rnd: Rounding, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.rnd = rnd
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return F.linear(self.rnd(x), self.rnd(self.weight), self.bias)


class Conv(nn.Module):
    """Channel-last convolution with 'SAME' padding."""
    kind = "conv"

    def __init__(self, rnd: Rounding, c_in: int, c_out: int, k: int, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.rnd, self.stride = rnd, stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        x = x.permute(0, 3, 1, 2)
        pads = []
        for size in (x.shape[3], x.shape[2]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        y = F.conv2d(self.rnd(x), self.rnd(self.weight), self.bias, stride=s)
        return y.permute(0, 2, 3, 1)


class Norm(nn.Module):
    """LayerNorm over the last axis, or GroupNorm over (H, W, the group's
    channels) of channel-last input."""
    kind = "norm"

    def __init__(self, dim: int, groups: int = 0, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        if not self.groups:
            return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups, self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class ConvNorm(Conv):
    def __init__(self, rnd: Rounding, c_in: int, c_out: int, k: int):
        super().__init__(rnd, c_in, c_out, k, bias=False)
        self.norm = Norm(c_out, groups=32)

    def forward(self, x):
        return self.norm(super().forward(x))


class Embedding(nn.Module):
    kind = "embedding"

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))


def drop_path(x, keep, rate: float):
    """Per-image DropPath with given keep decisions (B,)."""
    if keep is None or rate <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(keep.reshape(shape), x / (1.0 - rate), torch.zeros_like(x))


# ------------------------------------------------------- pixel decoder


def position_embedding_sine(h: int, w: int, npf: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding, (H, W, 2 npf), y features first."""
    scale, eps = 2.0 * math.pi, 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None] / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :] / (w + eps) * scale
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / npf)
    px = (x[:, :, None] / dim_t).expand(h, w, npf)
    py = (y[:, :, None] / dim_t).expand(h, w, npf)

    def inter(pe):
        return torch.stack([pe[..., 0::2].sin(), pe[..., 1::2].cos()], -1).reshape(h, w, -1)

    return torch.cat([inter(py), inter(px)], -1)


def msda_dense(value, shapes, loc, weights):
    """Multi-scale deformable attention's sampling (Deformable DETR): value
    (B, S, M, D), loc (B, Lq, M, L, P, 2) as (x, y) in [0, 1], weights
    (B, Lq, M, L, P) -> (B, Lq, M * D); bilinear, zero outside, half-pixel
    centres (``grid_sample``, ``align_corners=False``)."""
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = loc.shape
    out = 0.0
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        g = 2.0 * loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * m, lq, p, 2) - 1.0
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (B M, D, Lq, P)
        wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * m, 1, lq, p)
        out = out + (sampled * wl).sum(-1)
        start += h * w
    return out.reshape(b, m, d, lq).permute(0, 3, 1, 2).reshape(b, lq, m * d)


class MSDeformAttn(nn.Module):
    kind = "msdeform"

    def __init__(self, rnd, dim, levels, heads, points):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = Linear(rnd, dim, dim)
        self.sampling_offsets = Linear(rnd, dim, heads * levels * points * 2)
        self.attention_weights = Linear(rnd, dim, heads * levels * points)
        self.output_proj = Linear(rnd, dim, dim)

    def forward(self, query, ref, src, shapes):
        b, lq, c = query.shape
        m, L, p = self.heads, self.levels, self.points
        value = self.value_proj(src).reshape(b, -1, m, c // m)
        off = self.sampling_offsets(query).reshape(b, lq, m, L, p, 2)
        aw = self.attention_weights(query).reshape(b, lq, m, L * p).softmax(-1)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        out = msda_dense(value, shapes, loc, aw.reshape(b, lq, m, L, p))
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, rnd, cfg, levels):
        super().__init__()
        d = cfg["conv_dim"]
        self.self_attn = MSDeformAttn(rnd, d, levels, cfg["n_heads"], cfg["n_points"])
        self.norm1 = Norm(d)
        self.linear1 = Linear(rnd, d, cfg["transformer_ffn_dim"])
        self.linear2 = Linear(rnd, cfg["transformer_ffn_dim"], d)
        self.norm2 = Norm(d)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return self.norm2(src + self.linear2(torch.relu(self.linear1(src))))


class Encoder(nn.Module):
    def __init__(self, rnd, cfg, levels):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(rnd, cfg, levels)
                                     for _ in range(cfg["transformer_layers"])])


class DeformTransformer(nn.Module):
    def __init__(self, rnd, cfg, levels):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(levels, cfg["conv_dim"]))
        self.encoder = Encoder(rnd, cfg, levels)


class PixelDecoder(nn.Module):
    IN = ("res5", "res4", "res3")

    def __init__(self, rnd, cfg, in_channels):
        super().__init__()
        d = cfg["conv_dim"]
        self.cfg = cfg
        self.input_proj = nn.ModuleList([
            nn.Sequential(Conv(rnd, in_channels[k], d, 1), Norm(d, groups=32)) for k in self.IN])
        self.transformer = DeformTransformer(rnd, cfg, len(self.IN))
        self.adapter_1 = ConvNorm(rnd, in_channels["res2"], d, 1)
        self.layer_1 = ConvNorm(rnd, d, d, 3)
        self.mask_features = Conv(rnd, d, cfg["mask_dim"], 3)

    def forward(self, feats):
        d = self.cfg["conv_dim"]
        srcs, poss, shapes = [], [], []
        for i, k in enumerate(self.IN):
            x = feats[k]
            b, h, w, _ = x.shape
            srcs.append(self.input_proj[i](x).reshape(b, h * w, d))
            pe = position_embedding_sine(h, w, d // 2, x.device).reshape(1, h * w, d)
            poss.append(pe + self.transformer.level_embed[i][None, None])
            shapes.append((h, w))
        src = torch.cat(srcs, 1)
        pos = torch.cat(poss, 1).expand(src.shape[0], -1, -1)
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32, device=src.device) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=src.device) + 0.5) / w
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        ref = torch.cat(refs)[None, :, None, :].expand(src.shape[0], -1, len(shapes), 2)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, shapes)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(src[:, start:start + h * w].reshape(-1, h, w, d))
            start += h * w
        lat = self.adapter_1(feats["res2"])
        up = F.interpolate(outs[-1].permute(0, 3, 1, 2), size=lat.shape[1:3], mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
        y = torch.relu(self.layer_1(lat + up))
        return self.mask_features(y), outs


# ------------------------------------------------------------- decoder


class MHA(nn.Module):
    kind = "mha"

    def __init__(self, rnd, dim, heads):
        super().__init__()
        self.rnd, self.heads = rnd, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(rnd, dim, dim)

    def forward(self, q, k, v, block=None):
        b, nq, c = q.shape
        h = self.heads
        ws, bs = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)

        def split(x, i):
            return F.linear(self.rnd(x), self.rnd(ws[i]), bs[i]).reshape(b, -1, h, c // h) \
                .transpose(1, 2)

        qh, kh, vh = split(q, 0) * (c // h) ** -0.5, split(k, 1), split(v, 2)
        logits = self.rnd.mm(qh, kh.transpose(-1, -2))
        if block is not None:
            logits = logits.masked_fill(block, float("-inf"))
        out = self.rnd.mm(logits.softmax(-1), vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, c))


class CrossLayer(nn.Module):
    def __init__(self, rnd, d, heads):
        super().__init__()
        self.multihead_attn = MHA(rnd, d, heads)
        self.norm = Norm(d)


class SelfLayer(nn.Module):
    def __init__(self, rnd, d, heads):
        super().__init__()
        self.self_attn = MHA(rnd, d, heads)
        self.norm = Norm(d)


class FFNLayer(nn.Module):
    def __init__(self, rnd, d, ffn):
        super().__init__()
        self.linear1 = Linear(rnd, d, ffn)
        self.linear2 = Linear(rnd, ffn, d)
        self.norm = Norm(d)


class MaskEmbed(nn.Module):
    def __init__(self, rnd, d, out):
        super().__init__()
        self.layers = nn.ModuleList([Linear(rnd, d, d), Linear(rnd, d, d), Linear(rnd, d, out)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < 2:
                x = torch.relu(x)
        return x


class MaskedDecoder(nn.Module):
    """Mask2Former's decoder: masked cross-attention -> self-attention ->
    FFN, post-norm, the layers cycling over the feature scales from the
    coarsest, a prediction head before the first layer and after each; the
    next layer's mask blocks keys where sigmoid(mask logit) < 0.5, computed
    from the mask embedding and the mask features resized to that scale
    (a query's row is left open where it would block every key)."""

    def __init__(self, rnd, cfg, in_dim):
        super().__init__()
        d = cfg["hidden_dim"]
        self.rnd, self.cfg = rnd, cfg
        if in_dim != d:
            raise ValueError("the reference decoder takes features of its own width")
        n = cfg["dec_layers"]
        self.level_embed = Embedding(cfg["num_feature_levels"], d)
        self.query_feat = Embedding(cfg["num_queries"], d)
        self.query_embed = Embedding(cfg["num_queries"], d)
        self.transformer_cross_attention_layers = nn.ModuleList(
            [CrossLayer(rnd, d, cfg["num_heads"]) for _ in range(n)])
        self.transformer_self_attention_layers = nn.ModuleList(
            [SelfLayer(rnd, d, cfg["num_heads"]) for _ in range(n)])
        self.transformer_ffn_layers = nn.ModuleList(
            [FFNLayer(rnd, d, cfg["dim_feedforward"]) for _ in range(n)])
        self.decoder_norm = Norm(d)
        self.class_embed = Linear(rnd, d, cfg["num_classes"] + 1)
        self.mask_embed = MaskEmbed(rnd, d, cfg["mask_dim"])

    def forward(self, feats: List[torch.Tensor], mask_features: torch.Tensor) -> dict:
        cfg, rnd = self.cfg, self.rnd
        b, d = mask_features.shape[0], cfg["hidden_dim"]
        levels = cfg["num_feature_levels"]
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(feats[:levels]):
            h, w = x.shape[1:3]
            sizes.append((h, w))
            srcs.append(x.reshape(b, h * w, d) + self.level_embed.weight[i][None, None])
            poss.append(position_embedding_sine(h, w, d // 2, x.device).reshape(1, h * w, d))
        small = {s: F.interpolate(mask_features.permute(0, 3, 1, 2), size=s, mode="bilinear",
                                  align_corners=False).permute(0, 2, 3, 1) for s in set(sizes)}
        out = self.query_feat.weight[None].expand(b, -1, -1)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)

        def heads(out, size):
            dec = self.decoder_norm(out)
            emb = self.mask_embed(dec)
            masks = torch.einsum("bqc,bhwc->bqhw", rnd(emb), rnd(mask_features))
            m = torch.einsum("bqc,bhwc->bqhw", rnd(emb), rnd(small[size])).detach()
            blocked = (m.sigmoid() < 0.5).flatten(2)
            blocked = blocked & ~blocked.all(-1, keepdim=True)
            return self.class_embed(dec), masks, blocked[:, None], dec

        logits, masks, block, dec = heads(out, sizes[0])
        preds = [(logits, masks)]
        for i in range(cfg["dec_layers"]):
            lvl = i % levels
            ca = self.transformer_cross_attention_layers[i]
            sa = self.transformer_self_attention_layers[i]
            ffn = self.transformer_ffn_layers[i]
            out = ca.norm(out + ca.multihead_attn(out + qpos, srcs[lvl] + poss[lvl], srcs[lvl],
                                                  block))
            out = sa.norm(out + sa.self_attn(out + qpos, out + qpos, out))
            out = ffn.norm(out + ffn.linear2(torch.relu(ffn.linear1(out))))
            logits, masks, block, dec = heads(out, sizes[(i + 1) % levels])
            preds.append((logits, masks))
        return {"pred_logits": logits, "pred_masks": masks, "decoder_output": dec,
                "aux_outputs": [{"pred_logits": c, "pred_masks": m} for c, m in preds[:-1]]}


class SemSegHead(nn.Module):
    def __init__(self, rnd, cfg, in_channels):
        super().__init__()
        self.pixel_decoder = PixelDecoder(rnd, cfg["pixel_decoder"], in_channels)
        self.predictor = MaskedDecoder(rnd, cfg["decoder"], cfg["pixel_decoder"]["conv_dim"])


class Segmenter(nn.Module):
    """The whole segmenter; ``cfg`` is a configuration file's ``model``
    group. Parts named in ``frozen`` (``backbone``, ``pixel_decoder``) run
    without gradient."""

    def __init__(self, cfg: dict, rounding: str = "f32", frozen: Sequence[str] = ()):
        super().__init__()
        self.rnd = Rounding(rounding)
        self.frozen = tuple(frozen)
        backbone, group = backbones.load(cfg)
        self.backbone, chans = backbone.reference(self.rnd, group)
        self.sem_seg_head = SemSegHead(self.rnd, cfg, chans)

    def forward(self, images: torch.Tensor, drop_keep=None) -> dict:
        """images (B, H, W, 3) in 0..255; ``drop_keep`` (blocks, 2, B) or
        None (no DropPath)."""
        mean = torch.tensor(PIXEL_MEAN, device=images.device)
        std = torch.tensor(PIXEL_STD, device=images.device)
        x = (images.float() - mean) / std
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and not self.frozen):
            feats = self.backbone(x, drop_keep)
        with torch.set_grad_enabled(grad and "pixel_decoder" not in self.frozen):
            mask_features, ms = self.sem_seg_head.pixel_decoder(feats)
        out = self.sem_seg_head.predictor(ms, mask_features)
        out["mask_features"] = mask_features
        out["backbone_features"] = feats
        return out


def trainable(name: str, frozen: Sequence[str]) -> bool:
    return not any(k in name for k in frozen)


def leaves(model: nn.Module) -> List[Tuple[str, nn.Parameter, str]]:
    """(name, parameter, owning module kind) of every parameter."""
    out = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            out.append((f"{mname}.{pname}" if mname else pname, p,
                        getattr(mod, "kind", type(mod).__name__)))
    return out


def level_shapes(size: int, cfg: dict) -> List[Tuple[int, int]]:
    """The pixel decoder's (h, w) of res5, res4, res3 at a square input;
    ``cfg`` is a configuration's ``model`` group."""
    backbone, group = backbones.load(cfg)
    return backbone.level_shapes(size, group)


def stage_sizes(size: int, cfg: dict) -> List[int]:
    """The backbone's token grid side at each stage of a square input."""
    backbone, group = backbones.load(cfg)
    return backbone.stage_sizes(size, group)


def is_frozen(name: str, frozen: Optional[Sequence[str]]) -> bool:
    return bool(frozen) and any(k in name for k in frozen)
