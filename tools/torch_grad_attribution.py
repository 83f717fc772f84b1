#!/usr/bin/env python3
"""Which kernel moves the unfrozen train step's gradients away from f32.

Builds ``chip_smoke.py``'s unfrozen path (full-width Swin-L with
``fused_proj``, 640^2, B=2, bf16, trunk unfrozen, DropPath 0.3, 12544 grid
points) at the seeded initial weights, batch, noise and matching of its
phase 8, and takes the same loss and gradients through:

* the f32 step through the plain versions (the reference),
* the plain-version bf16 step and the kernel bf16 step,
* the kernel step with one kernel at a time swapped for its plain version,
* the plain-version step with one kernel at a time left on the kernel.

For each it prints, per trunk group and the decoder, the distance to the
f32 gradient over the plain bf16 path's (the ratio that phase 8 holds to
1.5): its median, smallest and largest, and the loss's relative distance to
f32. A kernel whose swap alone brings the kernel step to the plain path's
distance (median ratio 1), and whose lone launch alone takes the plain path
away from it, is the one that moves the gradients. The forward's outputs at
each layer (Swin's four stages, the pixel decoder's mask features and
levels, the decoder's logits and mask logits) are read the same way.

Run from the repository root on one GPU:
``python3 tools/torch_grad_attribution.py --seeds 0 1 2``. Prints the card's
name and power limit, then one JSON line per (seed, step variant).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KERNELS = ("layer_norm", "fused_ln_mlp", "window_attention_proj", "fused_masked_attention",
           "msda_folded")


def _activations(model, store):
    """Forward hooks that keep each layer's outputs, f32, under ``store``."""
    def keep(prefix):
        def hook(_module, _inputs, out):
            if isinstance(out, dict):
                items = out.items()
            elif isinstance(out, (tuple, list)):
                items = [(f"{prefix}.mask_features", out[0])] + [
                    (f"{prefix}.level{i}", t) for i, t in enumerate(out[2])]
            store.update({(k if isinstance(out, (tuple, list)) else f"{prefix}.{k}"):
                          v.detach().float() for k, v in items
                          if hasattr(v, "detach") and v.is_floating_point()})
        return hook
    return [model.backbone.register_forward_hook(keep("swin")),
            model.sem_seg_head.pixel_decoder.register_forward_hook(keep("pixel_decoder")),
            model.sem_seg_head.predictor.register_forward_hook(keep("decoder"))]


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def attribute(seed: int):
    import torch

    from chip_smoke import (BATCH_SIZE, IMAGE_SIZE, UNFROZEN_STEPS, _trunk_parts,
                            compare_grads, f32_config, plain_versions, synthetic_train_batch,
                            unfrozen_config)
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    # phase 8's weights, batch, noise and matching
    cfg = unfrozen_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model, OptimizerConfig(freeze_keys=()), device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 2)
    batch = [synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE)
             for _ in range(UNFROZEN_STEPS)][0]
    t = loss_fn.device_batch(batch)
    noise = loss_fn.draw_noise(batch, trainer.generator)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)

    def step(lf, m):
        acts = {}
        hooks = _activations(m, acts)
        m.zero_grad(set_to_none=True)
        total, _ = lf(batch, noise)
        total.backward()
        for h in hooks:
            h.remove()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                 for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return total.item(), grads, acts

    cfg32 = f32_config(cfg)
    model32 = MaskFormerSegmenter(cfg32.segmenter, device="cuda", seed=seed).train()
    model32.load_state_dict(model.state_dict())
    with plain_versions():
        loss_32, grads_32, acts_32 = step(make_loss_fn(cfg32, model32, device="cuda"), model32)
    del model32
    with plain_versions():
        loss_p, grads_p, acts_p = step(loss_fn, model)
    plain_32 = compare_grads(grads_p, grads_32, _trunk_parts)
    del grads_p

    def report(name, swapped):
        with plain_versions(swapped):
            loss, grads, acts = step(loss_fn, model)
        ratios = {g: v["rel_err"] / max(plain_32[g]["rel_err"], 1e-12)
                  for g, v in compare_grads(grads, grads_32, _trunk_parts).items()}
        worst = max(ratios, key=ratios.get)
        print(json.dumps({
            "seed": seed, "step": name, "loss_rel_to_f32": abs(loss - loss_32) / abs(loss_32),
            "f32_ratio_median": statistics.median(ratios.values()),
            "f32_ratio_min": min(ratios.values()), "f32_ratio_max": ratios[worst],
            "worst_group": worst,
            "activations_rel_to_f32": {k: _rel(acts[k], acts_32[k]) for k in sorted(acts_32)},
        }), flush=True)

    print(json.dumps({"seed": seed, "step": "plain", "loss_rel_to_f32":
                      abs(loss_p - loss_32) / abs(loss_32),
                      "activations_rel_to_f32": {k: _rel(acts_p[k], acts_32[k])
                                                 for k in sorted(acts_32)}}), flush=True)
    report("kernels", ())
    for k in KERNELS:
        report(f"kernels, {k} plain", (k,))
    for k in KERNELS:
        report(f"plain, {k} kernel", tuple(n for n in KERNELS if n != k))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_grad_attribution: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for seed in args.seeds:
        attribute(seed)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
