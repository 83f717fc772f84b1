"""The system under test, built through its normal entry points from a
configuration file and a traffic file: the segmenter, the train step's loss
and ``Trainer``, the item list, the mapper and the ``DataLoader``, and the
wire format (``run._pack_train_batch`` on the host, ``_unpack_train_batch``
as the Trainer's ``batch_prepare``), as ``train-proposal`` and
``train-supervised`` assemble them."""

from __future__ import annotations

import torch

from . import backbones, stores, tasks

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def segmenter_config(cfg: dict):
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import SegmenterConfig
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    m = cfg["model"]
    dt = DTYPES[cfg["precision"]["compute"]]
    backbone, group = backbones.load(m)
    pd, dc = m["pixel_decoder"], m["decoder"]
    frozen = tuple(cfg["optimizer"]["freeze_keys"])
    msda = {}
    if cfg["msda"]["mode"] != "dense":
        msda = {"msda_mode": cfg["msda"]["mode"], "msda_band_radius": cfg["msda"]["band_radius"]}
    return SegmenterConfig(
        **backbone.program_config(group, dt),
        pixel_decoder=PixelDecoderConfig(conv_dim=pd["conv_dim"], mask_dim=pd["mask_dim"],
                                         transformer_layers=pd["transformer_layers"],
                                         transformer_ffn_dim=pd["transformer_ffn_dim"],
                                         n_heads=pd["n_heads"], n_points=pd["n_points"],
                                         dtype=dt, **msda),
        decoder=TransformerDecoderConfig(num_classes=dc["num_classes"],
                                         hidden_dim=dc["hidden_dim"],
                                         num_queries=dc["num_queries"],
                                         num_heads=dc["num_heads"],
                                         dim_feedforward=dc["dim_feedforward"],
                                         dec_layers=dc["dec_layers"], mask_dim=dc["mask_dim"],
                                         num_feature_levels=dc["num_feature_levels"], dtype=dt),
        freeze_backbone="backbone" in frozen, freeze_pixel_decoder="pixel_decoder" in frozen)


def criterion_config(cfg: dict):
    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig

    c = cfg["criterion"]
    return CriterionConfig(num_classes=c["num_classes"], num_points=c["num_points"],
                           oversample_ratio=c["oversample_ratio"],
                           importance_sample_ratio=c["importance_sample_ratio"],
                           point_mode=c["point_mode"],
                           matcher=MatcherConfig(num_points=c["num_points"],
                                                 point_mode=c["match_point_mode"]))


def build_trainer(cfg: dict, weights: dict, device, seed: int):
    """(model, trainer) with ``weights`` loaded, on ``device``."""
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.run import _unpack_train_batch

    seg = segmenter_config(cfg)
    model = MaskFormerSegmenter(seg, device=device, seed=0)
    model.load_state_dict(weights)
    o = cfg["optimizer"]
    opt = OptimizerConfig(base_lr=o["base_lr"], weight_decay=o["weight_decay"],
                          backbone_multiplier=o["backbone_multiplier"], clip_norm=o["clip_norm"],
                          freeze_keys=tuple(o["freeze_keys"]))
    loss_fn = tasks.load(cfg).loss_fn(cfg, seg, model, device)
    trainer = Trainer(loss_fn, model, opt, device=device,
                      seed=seed & 0xFFFF_FFFF, batch_prepare=_unpack_train_batch(
                          cfg["image_size"], device))
    return model, trainer


def build_loader(cfg: dict, traffic: dict, paths: dict, seed: int):
    """The program's DataLoader over the written image set."""
    from partdistillation_torch.data.loader import DataLoader

    seed = seed & 0x7FFF_FFFF
    items, mapper = stores.load(traffic).program_items(paths, cfg["image_size"],
                                                       cfg["mask_capacity"], seed)
    return DataLoader(items, mapper, traffic["batch"], shuffle=True, seed=seed, epochs=None,
                      num_workers=traffic["mapper_threads"], prefetch=traffic["prefetch"],
                      drop_last=True)


def pack(batch: dict) -> dict:
    """The host side of the wire format, as the train loop packs a batch."""
    from partdistillation_torch.run import _pack_train_batch

    return _pack_train_batch({k: v for k, v in batch.items() if k != "image_id"})
