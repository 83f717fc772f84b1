"""Mask2Former-style segmenter: Swin backbone -> deformable pixel decoder ->
masked transformer decoder.

Counterpart of the JAX package's ``models/segmenter.py`` for the
``msdeform`` pixel decoder and the ``multi_scale`` decoder, with the stage-5
part-distillation head when ``decoder.num_object_classes > 0``. Module names
follow detectron2 (``backbone``, ``sem_seg_head.pixel_decoder``,
``sem_seg_head.predictor``), so a detectron2/Mask2Former state dict loads
with ``load_state_dict``. ``freeze_backbone`` / ``freeze_pixel_decoder`` run
those parts under ``torch.no_grad()`` (the JAX package's ``stop_gradient``):
no gradient reaches them and none of their activations are kept, while
training mode (DropPath) stays as the caller set it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from .layers import init_weights
from .pixel_decoder import MSDeformAttnPixelDecoder, PixelDecoderConfig
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
    swin: SwinConfig = SwinConfig()
    pixel_decoder: PixelDecoderConfig = PixelDecoderConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    freeze_backbone: bool = False
    freeze_pixel_decoder: bool = False
    pixel_decoder_type: str = "msdeform"
    decoder_type: str = "multi_scale"


class _SemSegHead(nn.Module):
    def __init__(self, cfg: SegmenterConfig):
        super().__init__()
        self.pixel_decoder = MSDeformAttnPixelDecoder(cfg.pixel_decoder,
                                                      cfg.swin.out_channels)
        decoder = (PartDistillationTransformerDecoder if cfg.decoder.num_object_classes > 0
                   else MultiScaleMaskedTransformerDecoder)
        self.predictor = decoder(cfg.decoder, cfg.pixel_decoder.conv_dim)


class MaskFormerSegmenter(nn.Module):
    """Built directly on ``device`` (``cuda`` unless told otherwise) with
    weights drawn from ``seed``; load real or converted weights with
    ``load_state_dict``."""

    def __init__(self, cfg: SegmenterConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.pixel_decoder_type != "msdeform":
            raise NotImplementedError(
                f"pixel_decoder_type={cfg.pixel_decoder_type!r} is not ported yet "
                "(ROADMAP: FPN / transformer-FPN pixel decoders)")
        if cfg.decoder_type != "multi_scale":
            raise NotImplementedError(
                f"decoder_type={cfg.decoder_type!r} is not ported yet "
                "(ROADMAP: MaskFormer v1 standard decoder)")
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.backbone = SwinTransformer(cfg.swin)
            self.sem_seg_head = _SemSegHead(cfg)
        self.to_empty(device=dev)
        init_weights(self, seed)

    def forward(self, images: torch.Tensor, drop_keep=None, gt_object_class=None) -> dict:
        """images: (B, H, W, 3) normalised float; ``drop_keep``: the
        backbone's DropPath keep decisions (``SwinTransformer.forward``);
        ``gt_object_class`` (B,): each image's object class, which the
        part-distillation head requires."""
        cfg, grad = self.cfg, torch.is_grad_enabled()
        # a frozen pixel decoder also cuts the backbone's only path to the loss
        with torch.set_grad_enabled(grad and not (cfg.freeze_backbone
                                                  or cfg.freeze_pixel_decoder)):
            feats = self.backbone(images, drop_keep)
        with torch.set_grad_enabled(grad and not cfg.freeze_pixel_decoder):
            mask_features, _, ms_feats = self.sem_seg_head.pixel_decoder(feats)
        out = self.sem_seg_head.predictor(ms_feats, mask_features, gt_object_class)
        out["mask_features"] = mask_features
        out["backbone_features"] = feats
        return out
