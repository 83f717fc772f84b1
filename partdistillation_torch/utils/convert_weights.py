"""Weights carried across: the JAX package's flax param tree -> this port's
``state_dict``.

The input is the flax tree of ``MaskFormerSegmenter`` (``{"params": {...}}``
or the inner dict) with numpy leaves. Port keys are the detectron2 /
Mask2Former names (``backbone.layers.0.blocks.1.attn.qkv.weight``,
``sem_seg_head.pixel_decoder.input_proj.0.0.weight``,
``sem_seg_head.predictor.transformer_cross_attention_layers.0.multihead_attn.
in_proj_weight`` ...), so a real checkpoint in that layout loads with a plain
``load_state_dict`` as well.

Conventions: Dense kernel (in, out) -> Linear weight (out, in); Conv kernel
HWIO -> OIHW; LayerNorm / GroupNorm ``scale`` -> ``weight``; the q/k/v Dense
kernels of an attention block are packed into ``in_proj_weight`` /
``in_proj_bias``; the split ``_LNParams`` / ``_DenseParams`` trees of the
fused Swin MLP (``norm2``, ``mlp_fc1``, ``mlp_fc2``) map to ``norm2``,
``mlp.fc1``, ``mlp.fc2``. The stage-5 part classifier's
``part_class_kernel`` (hidden, total) and ``part_class_bias`` map to
``sem_seg_head.predictor.part_class_embed.weight`` (total, hidden) and
``.bias``: a name no stage-3 ``class_embed`` shares, so a warm start from a
stage-3 checkpoint by name and shape keeps the head's initial weights.

The MaskFormer-v1 heads take the reference's names: the FPN's
``output_conv{i}`` / ``lateral_conv{i}`` (numbered coarse to fine from 0)
map to ``layer_{n - i}`` / ``adapter_{n - i}`` (numbered fine to coarse from
1, n the FPN's levels), their ``conv`` / ``norm`` to the convolution and its
``.norm``; the DETR layers (``transformer/layer{i}`` of the transformer-FPN,
``transformer/encoder|decoder/layer{i}`` of the standard decoder) map to
``transformer.encoder|decoder.layers.{i}``, their ``cross_attn`` to
``multihead_attn`` (q/k/v packed as above), ``ffn/linear{j}`` to
``linear{j}``.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "clip_state_dict_from_flax"]

# (flax module path regex, port module prefix template); first match wins
_MODULE_RULES = [
    (r"backbone/patch_embed", "backbone.patch_embed.proj"),
    (r"backbone/patch_norm", "backbone.patch_embed.norm"),
    (r"backbone/stage(\d+)_block(\d+)/attn/(qkv|proj)", r"backbone.layers.\1.blocks.\2.attn.\3"),
    (r"backbone/stage(\d+)_block(\d+)/(norm1|norm2)", r"backbone.layers.\1.blocks.\2.\3"),
    (r"backbone/stage(\d+)_block(\d+)/mlp_fc(\d)", r"backbone.layers.\1.blocks.\2.mlp.fc\3"),
    (r"backbone/downsample(\d+)/(norm|reduction)", r"backbone.layers.\1.downsample.\2"),
    (r"pixel_decoder/input_proj(\d+)", r"sem_seg_head.pixel_decoder.input_proj.\1.0"),
    (r"pixel_decoder/input_norm(\d+)", r"sem_seg_head.pixel_decoder.input_proj.\1.1"),
    (r"pixel_decoder/layer(\d+)/self_attn/(\w+)",
     r"sem_seg_head.pixel_decoder.transformer.encoder.layers.\1.self_attn.\2"),
    (r"pixel_decoder/layer(\d+)/(linear1|linear2|norm1|norm2)",
     r"sem_seg_head.pixel_decoder.transformer.encoder.layers.\1.\2"),
    (r"pixel_decoder/fpn_lateral_norm", "sem_seg_head.pixel_decoder.adapter_1.norm"),
    (r"pixel_decoder/fpn_lateral", "sem_seg_head.pixel_decoder.adapter_1"),
    (r"pixel_decoder/fpn_output_norm", "sem_seg_head.pixel_decoder.layer_1.norm"),
    (r"pixel_decoder/fpn_output", "sem_seg_head.pixel_decoder.layer_1"),
    (r"pixel_decoder/mask_features", "sem_seg_head.pixel_decoder.mask_features"),
    (r"predictor/input_proj(\d+)", r"sem_seg_head.predictor.input_proj.\1"),
    (r"predictor/layer(\d+)/cross_attn/out_proj",
     r"sem_seg_head.predictor.transformer_cross_attention_layers.\1.multihead_attn.out_proj"),
    (r"predictor/layer(\d+)/self_attn/out_proj",
     r"sem_seg_head.predictor.transformer_self_attention_layers.\1.self_attn.out_proj"),
    (r"predictor/layer(\d+)/norm_cross",
     r"sem_seg_head.predictor.transformer_cross_attention_layers.\1.norm"),
    (r"predictor/layer(\d+)/norm_self",
     r"sem_seg_head.predictor.transformer_self_attention_layers.\1.norm"),
    (r"predictor/layer(\d+)/ffn(\d)", r"sem_seg_head.predictor.transformer_ffn_layers.\1.linear\2"),
    (r"predictor/layer(\d+)/norm_ffn", r"sem_seg_head.predictor.transformer_ffn_layers.\1.norm"),
    (r"predictor/decoder_norm", "sem_seg_head.predictor.decoder_norm"),
    (r"predictor/class_embed", "sem_seg_head.predictor.class_embed"),
    (r"predictor/mask_embed/fc(\d+)", r"sem_seg_head.predictor.mask_embed.layers.\1"),
    # the MaskFormer-v1 heads
    (r"(pixel_decoder|predictor)/input_proj", r"sem_seg_head.\1.input_proj"),
    (r"pixel_decoder/transformer/layer(\d+)/self_attn/out_proj",
     r"sem_seg_head.pixel_decoder.transformer.encoder.layers.\1.self_attn.out_proj"),
    (r"pixel_decoder/transformer/layer(\d+)/(?:ffn/)?(linear\d|norm\d)",
     r"sem_seg_head.pixel_decoder.transformer.encoder.layers.\1.\2"),
    (r"pixel_decoder/transformer/norm", "sem_seg_head.pixel_decoder.transformer.encoder.norm"),
    (r"predictor/transformer/(encoder|decoder)/layer(\d+)/self_attn/out_proj",
     r"sem_seg_head.predictor.transformer.\1.layers.\2.self_attn.out_proj"),
    (r"predictor/transformer/decoder/layer(\d+)/cross_attn/out_proj",
     r"sem_seg_head.predictor.transformer.decoder.layers.\1.multihead_attn.out_proj"),
    (r"predictor/transformer/(encoder|decoder)/layer(\d+)/(?:ffn/)?(linear\d|norm\d)",
     r"sem_seg_head.predictor.transformer.\1.layers.\2.\3"),
    (r"predictor/transformer/(encoder|decoder)/norm",
     r"sem_seg_head.predictor.transformer.\1.norm"),
]

# raw parameters (no kernel/scale leaf convention)
_RAW_RULES = [
    (r"backbone/stage(\d+)_block(\d+)/attn/relative_position_bias_table",
     r"backbone.layers.\1.blocks.\2.attn.relative_position_bias_table"),
    (r"backbone/norm_res(\d+)/(scale|bias)", None),  # handled in _norm_res
    (r"pixel_decoder/level_embed", "sem_seg_head.pixel_decoder.transformer.level_embed"),
    (r"predictor/level_embed", "sem_seg_head.predictor.level_embed.weight"),
    (r"predictor/query_feat", "sem_seg_head.predictor.query_feat.weight"),
    (r"predictor/query_embed", "sem_seg_head.predictor.query_embed.weight"),
    (r"predictor/part_class_bias", "sem_seg_head.predictor.part_class_embed.bias"),
]

_MHA = re.compile(r"(.+)/(cross|self)_attn/(q|k|v)_proj/(kernel|bias)")
# (flax layer path holding an attention, the port module of that layer);
# the masked decoder's attentions live in separate per-kind layer lists
_MHA_OWNERS = [
    (r"pixel_decoder/transformer/layer(\d+)",
     r"sem_seg_head.pixel_decoder.transformer.encoder.layers.\1"),
    (r"predictor/transformer/(encoder|decoder)/layer(\d+)",
     r"sem_seg_head.predictor.transformer.\1.layers.\2"),
]


def _mha_prefix(layer: str, kind: str) -> str:
    """The port module that packs the q/k/v projections of attention
    ``kind`` ("self" | "cross") in the flax layer ``layer``."""
    m = re.fullmatch(r"predictor/layer(\d+)", layer)
    if m:
        owner = ("transformer_cross_attention_layers", "multihead_attn") if kind == "cross" \
            else ("transformer_self_attention_layers", "self_attn")
        return f"sem_seg_head.predictor.{owner[0]}.{m.group(1)}.{owner[1]}"
    for pattern, target in _MHA_OWNERS:
        if re.fullmatch(pattern, layer):
            attn = "multihead_attn" if kind == "cross" else "self_attn"
            return f"{re.sub(pattern, target, layer)}.{attn}"
    raise KeyError(f"no port key for the attention of flax layer {layer}")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(value: np.ndarray, leaf: str):
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if leaf == "scale":
        return "weight", value
    return leaf, value


def state_dict_from_flax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax param tree (numpy leaves) -> the port's state_dict (f32 tensors).
    Raises on a flax leaf that no rule maps."""
    tree = params.get("params", params)
    flat = _flatten(tree)
    sd: Dict[str, np.ndarray] = {}
    mha: Dict[tuple, Dict[str, np.ndarray]] = {}
    # the FPN's levels (its output convolutions), which its names count down from
    n_fpn = len({m.group(1) for p in flat
                 if (m := re.match(r"pixel_decoder/output_conv(\d+)/", p))})
    for path, value in flat.items():
        m = _MHA.fullmatch(path)
        if m:
            layer, kind, which, leaf = m.groups()
            mha.setdefault((_mha_prefix(layer, kind), leaf), {})[which] = value
            continue
        m = re.fullmatch(r"pixel_decoder/(output|lateral)_conv(\d+)/(conv|norm)/(\w+)", path)
        if m:
            name = ("layer_" if m.group(1) == "output" else "adapter_") + \
                str(n_fpn - int(m.group(2)))
            leaf, v = _leaf(value, m.group(4))
            sd[f"sem_seg_head.pixel_decoder.{name}{'.norm' if m.group(3) == 'norm' else ''}"
               f".{leaf}"] = v
            continue
        if path == "predictor/part_class_kernel":
            sd["sem_seg_head.predictor.part_class_embed.weight"] = value.T
            continue
        m = re.fullmatch(r"backbone/norm_res(\d+)/(scale|bias)", path)
        if m:
            name = "weight" if m.group(2) == "scale" else "bias"
            sd[f"backbone.norm{int(m.group(1)) - 2}.{name}"] = value
            continue
        for pattern, target in _RAW_RULES:
            if target is not None and re.fullmatch(pattern, path):
                sd[re.sub(pattern, target, path)] = value
                break
        else:
            module, _, leaf = path.rpartition("/")
            for pattern, target in _MODULE_RULES:
                if re.fullmatch(pattern, module):
                    name, v = _leaf(value, leaf)
                    sd[f"{re.sub(pattern, target, module)}.{name}"] = v
                    break
            else:
                raise KeyError(f"no port key for flax parameter {path}")
    for (prefix, leaf), parts in mha.items():
        if leaf == "kernel":
            sd[f"{prefix}.in_proj_weight"] = np.concatenate(
                [parts[w].T for w in ("q", "k", "v")], axis=0)
        else:
            sd[f"{prefix}.in_proj_bias"] = np.concatenate([parts[w] for w in ("q", "k", "v")])
    return OrderedDict((k, torch.from_numpy(np.array(v, dtype=np.float32)))
                       for k, v in sorted(sd.items()))


def clip_state_dict_from_flax(params: Dict[str, Any],
                              tower: str) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's CLIP tower tree (``CLIPVisionTower`` for ``tower=
    "vision"``, ``CLIPTextTower`` for ``"text"``; numpy leaves) -> the port
    tower's state_dict, under transformers' key names (which the port's
    towers use). Raises on a flax leaf that no rule maps."""
    if tower not in ("vision", "text"):
        raise ValueError(f"tower must be 'vision' or 'text', not {tower!r}")
    flat = _flatten(params.get("params", params))
    model = "vision_model" if tower == "vision" else "text_model"
    raw = ({"class_embedding": "vision_model.embeddings.class_embedding",
            "position_embedding": "vision_model.embeddings.position_embedding.weight",
            "patch_embed/proj/kernel": "vision_model.embeddings.patch_embedding.weight"}
           if tower == "vision" else
           {"position_embedding": "text_model.embeddings.position_embedding.weight",
            "token_embedding/embedding": "text_model.embeddings.token_embedding.weight"})
    modules = {"pre_layernorm": "vision_model.pre_layrnorm",
               "post_layernorm": "vision_model.post_layernorm",
               "final_layer_norm": "text_model.final_layer_norm",
               "visual_projection": "visual_projection", "text_projection": "text_projection"}
    sd: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        if path in raw:
            sd[raw[path]] = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
            continue
        module, _, leaf = path.rpartition("/")
        m = re.fullmatch(r"block_(\d+)/(self_attn/(?:q|k|v|out)_proj|fc1|fc2|layer_norm[12])",
                         module)
        if m:
            sub = m.group(2).replace("fc", "mlp.fc").replace("/", ".")
            target = f"{model}.encoder.layers.{m.group(1)}.{sub}"
        elif module in modules:
            target = modules[module]
        else:
            raise KeyError(f"no port key for flax CLIP parameter {path}")
        name, v = _leaf(value, leaf)
        sd[f"{target}.{name}"] = v
    return OrderedDict((k, torch.from_numpy(np.array(v, dtype=np.float32)))
                       for k, v in sorted(sd.items()))
