"""The supervised / fewshot ablation: every query classified over the
configuration's part classes, the targets the ground-truth parts with their
classes (``models/meta_arch/supervised.py``)."""

from __future__ import annotations

from ..reference.loss import set_loss as reference_loss  # noqa: F401

FIELDS = ("masks", "valid", "labels")


def loss_fn(cfg: dict, seg, model, device):
    from partdistillation_torch.models.meta_arch.supervised import (SupervisedModelConfig,
                                                                      make_loss_fn)

    from ..program import criterion_config

    model_cfg = SupervisedModelConfig(segmenter=seg, criterion=criterion_config(cfg),
                                      num_part_classes=cfg["model"]["decoder"]["num_classes"])
    return make_loss_fn(model_cfg, model, device=device)


def targets(fields: dict) -> dict:
    return {"masks": fields["masks"], "valid": fields["valid"],
            "labels": fields["labels"].long()}
