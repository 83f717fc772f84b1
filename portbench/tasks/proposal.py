"""Stage 3's class-agnostic proposals: one foreground class, every target
part of class 0 (``models/meta_arch/proposal.py``)."""

from __future__ import annotations

import torch

from ..reference.loss import set_loss as reference_loss  # noqa: F401

FIELDS = ("masks", "valid")


def loss_fn(cfg: dict, seg, model, device):
    from partdistillation_torch.models.meta_arch.proposal import (ProposalModelConfig,
                                                                    make_loss_fn)

    from ..program import criterion_config

    model_cfg = ProposalModelConfig(segmenter=seg, criterion=criterion_config(cfg))
    return make_loss_fn(model_cfg, model, device=device)


def targets(fields: dict) -> dict:
    valid = fields["valid"]
    return {"masks": fields["masks"], "valid": valid,
            "labels": torch.zeros(valid.shape, dtype=torch.long, device=valid.device)}
