"""Model FLOPs of one step, counted once from shapes over the benchmark's
plain reference (never over the program's kernels).

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products and
convolutions of the reference's forward, its criterion at the configured
points (matched queries fixed, since a count needs shapes only) and, for a
training step, its backward, with the configuration's frozen parts under
``no_grad`` so that their backward is not counted. The tensors are on the
``meta`` device: nothing is computed. The f32 work (point sampling) is
counted like the rest and held against the bf16 peak.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import tasks
from .reference.model import Segmenter, is_frozen


def train_step_flops(cfg: dict, batch: int) -> int:
    frozen = cfg["optimizer"]["freeze_keys"]
    task = tasks.load(cfg)
    s, t = cfg["image_size"], cfg["mask_capacity"]
    crit = cfg["criterion"]
    layers = 1 + cfg["model"]["decoder"]["dec_layers"]
    with torch.device("meta"):
        model = Segmenter(cfg["model"], "f32", frozen)
        for n, p in model.named_parameters():
            p.requires_grad_(not is_frozen(n, frozen))
        images = torch.empty(batch, s, s, 3)
        fields = {"masks": torch.empty(batch, t, s, s), "valid": torch.ones(batch, t, dtype=bool),
                  "labels": torch.zeros(batch, t, dtype=torch.long)}
        tgt = task.targets({k: fields[k] for k in task.FIELDS})
        n_imp = int(crit["importance_sample_ratio"] * crit["num_points"])
        if crit["point_mode"] == "grid":
            noise = {"point_jitter": torch.empty(layers, batch, t, 2)}
        else:
            noise = {"point_fresh": torch.empty(layers, batch, t, crit["num_points"] - n_imp, 2)}
            if n_imp:
                noise["point_pool"] = torch.empty(
                    layers, batch, t, int(crit["num_points"] * crit["oversample_ratio"]), 2)
        idx = torch.arange(t).expand(layers, batch, t)
        with FlopCounterMode(display=False) as counter:
            out = model(images, None)
            total, _ = task.reference_loss(out, tgt, noise, crit, indices=idx)
            total.backward()
    return int(counter.get_total_flops())
