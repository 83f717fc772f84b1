"""Mask2Former-style segmenter: backbone -> pixel decoder -> transformer
decoder.

Counterpart of the JAX package's ``models/segmenter.py``. The backbone is
Swin (``swin``) unless ``vitdet`` holds a ViTDet configuration
(``models/vitdet.py``, imported only then), which clears ``swin``: the
configuration holds the one backbone it builds, and the pixel decoder reads
its ``out_channels``. The pixel decoder
``pixel_decoder_type`` (``msdeform``, the deformable one; ``fpn`` or
``transformer_fpn``, the MaskFormer-v1 FPNs of ``fpn.py``) and the decoder
``decoder_type`` (``multi_scale``, the masked decoder, with the stage-5
part-distillation head when ``decoder.num_object_classes > 0``; or
``standard``, the v1 decoder of ``maskformer_decoder.py``, which attends the
pixel decoder's encoder feature or, for a plain FPN, the raw res5). Module names
follow detectron2 (``backbone``, ``sem_seg_head.pixel_decoder``,
``sem_seg_head.predictor``), so a detectron2/Mask2Former state dict loads
with ``load_state_dict``. ``freeze_backbone`` / ``freeze_pixel_decoder`` run
those parts under ``torch.no_grad()`` (the JAX package's ``stop_gradient``):
no gradient reaches them and none of their activations are kept, while
training mode (DropPath) stays as the caller set it. The three parts run
inside ``torch.profiler.record_function`` scopes named ``backbone``,
``pixel_decoder`` and ``transformer_decoder`` (the JAX package's
``jax.named_scope``s), which ``utils/profiling.summarize_trace`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from .. import resolve_device
from .fpn import FPNPixelDecoderConfig, build_pixel_decoder
from .layers import init_weights
from .maskformer_decoder import StandardDecoderConfig, StandardTransformerDecoder
from .pixel_decoder import PixelDecoderConfig
from .swin import SwinConfig, SwinTransformer
from .transformer_decoder import (
    MultiScaleMaskedTransformerDecoder,
    PartDistillationTransformerDecoder,
    TransformerDecoderConfig,
)

__all__ = ["SegmenterConfig", "MaskFormerSegmenter", "PIXEL_MEAN", "PIXEL_STD"]

# ImageNet normalisation of every reference config
PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    swin: Optional[SwinConfig] = SwinConfig()
    pixel_decoder: PixelDecoderConfig = PixelDecoderConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    freeze_backbone: bool = False
    freeze_pixel_decoder: bool = False
    pixel_decoder_type: str = "msdeform"  # "msdeform" | "fpn" | "transformer_fpn"
    fpn: FPNPixelDecoderConfig = FPNPixelDecoderConfig()
    decoder_type: str = "multi_scale"  # "multi_scale" | "standard"
    standard_decoder: StandardDecoderConfig = StandardDecoderConfig()
    vitdet: Optional["ViTDetConfig"] = None  # noqa: F821  (models/vitdet.py)

    def __post_init__(self):
        if self.vitdet is not None:
            object.__setattr__(self, "swin", None)

    @property
    def backbone_config(self):
        """The backbone's configuration, ``swin`` or ``vitdet`` (both give
        ``out_channels``, ``num_blocks`` and ``drop_path_rates()``)."""
        return self.swin if self.vitdet is None else self.vitdet

    @property
    def supervised_layers(self) -> int:
        """The decoder's final output and its auxiliary layers' outputs."""
        if self.decoder_type == "standard":
            return self.standard_decoder.supervised_layers
        return 1 + self.decoder.dec_layers


class _SemSegHead(nn.Module):
    def __init__(self, cfg: SegmenterConfig):
        super().__init__()
        msdeform = cfg.pixel_decoder_type == "msdeform"
        self.pixel_decoder = build_pixel_decoder(
            cfg.pixel_decoder_type, cfg.pixel_decoder if msdeform else cfg.fpn,
            cfg.backbone_config.out_channels)
        conv_dim = cfg.pixel_decoder.conv_dim if msdeform else cfg.fpn.conv_dim
        if cfg.decoder_type == "standard":
            # the encoder feature's width, or res5's for a plain FPN
            src = (cfg.backbone_config.out_channels["res5"] if cfg.pixel_decoder_type == "fpn"
                   else conv_dim)
            self.predictor = StandardTransformerDecoder(cfg.standard_decoder, src)
        elif cfg.decoder_type == "multi_scale":
            decoder = (PartDistillationTransformerDecoder if cfg.decoder.num_object_classes > 0
                       else MultiScaleMaskedTransformerDecoder)
            self.predictor = decoder(cfg.decoder, conv_dim)
        else:
            raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}; options: "
                             "['multi_scale', 'standard']")


class MaskFormerSegmenter(nn.Module):
    """Built directly on ``device`` (``cuda`` unless told otherwise) with
    weights drawn from ``seed``; load real or converted weights with
    ``load_state_dict``."""

    def __init__(self, cfg: SegmenterConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            if cfg.vitdet is None:
                self.backbone = SwinTransformer(cfg.swin)
            else:
                from .vitdet import ViTDet

                self.backbone = ViTDet(cfg.vitdet)
            self.sem_seg_head = _SemSegHead(cfg)
        self.to_empty(device=dev)
        init_weights(self, seed)

    def forward(self, images: torch.Tensor, drop_keep=None, gt_object_class=None) -> dict:
        """images: (B, H, W, 3) normalised float; ``drop_keep``: the
        backbone's DropPath keep decisions (``SwinTransformer.forward``,
        ``ViTDet.forward``);
        ``gt_object_class`` (B,): each image's object class, which the
        part-distillation head requires."""
        cfg, grad = self.cfg, torch.is_grad_enabled()
        # a frozen pixel decoder also cuts the backbone's only path to the
        # loss, unless the v1 decoder reads the raw res5 (a plain FPN)
        reads_res5 = cfg.decoder_type == "standard" and cfg.pixel_decoder_type == "fpn"
        with record_function("backbone"), torch.set_grad_enabled(grad and not (
                cfg.freeze_backbone or (cfg.freeze_pixel_decoder and not reads_res5))):
            feats = self.backbone(images, drop_keep)
        with record_function("pixel_decoder"), \
                torch.set_grad_enabled(grad and not cfg.freeze_pixel_decoder):
            mask_features, encoder_feature, ms_feats = self.sem_seg_head.pixel_decoder(feats)
        with record_function("transformer_decoder"):
            if cfg.decoder_type == "standard":
                src = feats["res5"] if encoder_feature is None else encoder_feature
                out = self.sem_seg_head.predictor(src, mask_features)
            else:
                out = self.sem_seg_head.predictor(ms_feats, mask_features, gt_object_class)
        out["mask_features"] = mask_features
        out["backbone_features"] = feats
        return out
