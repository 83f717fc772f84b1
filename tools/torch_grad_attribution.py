#!/usr/bin/env python3
"""Which kernel moves a train step's gradients away from f32.

Builds ``chip_smoke.py``'s unfrozen path (full-width Swin-L with
``fused_proj``, 640^2, B=2, bf16, trunk unfrozen, DropPath 0.3, 12544 grid
points) at the seeded initial weights, batch, noise and matching of its
phase 8 or, with ``--frozen``, its frozen path (trunk frozen, Swin's
two-step window attention) at phase 7's point: after the four train steps
and the split step, first batch, the noise drawn after them and the matching
computed once. It takes the same loss and gradients through:

* the f32 step through the plain versions (the reference),
* the plain-version bf16 step and the kernel bf16 step,
* the kernel step with one kernel at a time swapped for its plain version,
* the plain-version step with one kernel at a time left on the kernel.

For each it prints, per trunk group and the decoder (``--frozen``: per
decoder group of phase 7, the cross-attention split into q / k / v / out /
norm), the distance to the f32 gradient over the plain bf16 path's (the
ratio that phases 7 and 8 hold): its median, smallest and largest, and the
loss's relative distance to f32. A kernel whose swap alone brings the kernel step to the plain path's
distance (median ratio 1), and whose lone launch alone takes the plain path
away from it, is the one that moves the gradients. The forward's outputs at
each layer (Swin's four stages, the pixel decoder's mask features and
levels, the decoder's logits and mask logits) are read the same way.

Run from the repository root on one GPU:
``python3 tools/torch_grad_attribution.py [--frozen] --seeds 0 1 2``. Prints the card's
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

# the kernel ops (ops/autograd.OPS) of each path; the masked attention's swap
# takes its backward kernel with it, and the frozen path runs Swin's two-step
# window attention
KERNELS = ("layer_norm", "ln_mlp", "window_attn_proj", "masked_attn", "msda")
FROZEN_KERNELS = ("layer_norm", "ln_mlp", "window_attn", "masked_attn", "msda")


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


def _unfrozen_point(seed: int):
    """Phase 8's model, loss, batch and noise with its matching, at the
    seeded initial weights."""
    import torch

    from chip_smoke import (BATCH_SIZE, IMAGE_SIZE, UNFROZEN_STEPS, synthetic_train_batch,
                            unfrozen_config)
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

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
    return cfg, model, loss_fn, batch, noise


def _frozen_point(seed: int):
    """Phase 7's model, loss, batch and noise with its matching: the calls of
    ``chip_smoke.train_path`` up to its comparison (four train steps, the
    noise of the split step, that step's update, the matching)."""
    import torch

    from chip_smoke import (BATCH_SIZE, FREEZE_KEYS, IMAGE_SIZE, TRAIN_STEPS,
                            synthetic_train_batch, train_config)
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = train_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model, OptimizerConfig(freeze_keys=FREEZE_KEYS),
                      device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 1)
    batches = [synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE) for _ in range(TRAIN_STEPS)]
    for b in batches:
        trainer.train_step(b)
    batch = batches[0]
    t = loss_fn.device_batch(batch)
    noise = loss_fn.draw_noise(batch, trainer.generator)
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn.criterion(loss_fn.forward(t, noise), t, noise)
    total.backward()
    trainer.apply_gradients()
    del total
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)
    return cfg, model, loss_fn, batch, noise


def attribute(seed: int, frozen: bool):
    import torch

    from chip_smoke import TRUNK, _decoder_parts, _trunk_parts, compare_grads, f32_config
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.ops.autograd import plain_versions

    cfg, model, loss_fn, batch, noise = (_frozen_point if frozen else _unfrozen_point)(seed)
    kernels = FROZEN_KERNELS if frozen else KERNELS
    parts = _decoder_parts if frozen else _trunk_parts
    # phase 7 compares the decoder's gradients only; phase 8 every parameter's
    keep = (lambda n: not n.startswith(TRUNK)) if frozen else (lambda n: True)
    path = "frozen" if frozen else "unfrozen"

    def step(lf, m):
        acts = {}
        hooks = _activations(m, acts)
        m.zero_grad(set_to_none=True)
        total, _ = lf(batch, noise)
        total.backward()
        for h in hooks:
            h.remove()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                 for n, p in m.named_parameters() if keep(n)}
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
    plain_32 = compare_grads(grads_p, grads_32, parts)

    def report(name, swapped):
        with plain_versions(swapped):
            loss, grads, acts = step(loss_fn, model)
        ratios = {g: v["rel_err"] / max(plain_32[g]["rel_err"], 1e-12)
                  for g, v in compare_grads(grads, grads_32, parts).items()}
        vs_plain = compare_grads(grads, grads_p, parts)
        worst = max(ratios, key=ratios.get)
        # the frozen path has few groups: each one's readings, as phase 7's
        by_group = {"by_group": {g: {**vs_plain[g], "f32_ratio": ratios[g]} for g in ratios}}
        print(json.dumps({
            "seed": seed, "path": path, "step": name,
            "loss_rel_to_f32": abs(loss - loss_32) / abs(loss_32),
            "loss_rel_to_plain": abs(loss - loss_p) / abs(loss_p),
            "f32_ratio_median": statistics.median(ratios.values()),
            "f32_ratio_min": min(ratios.values()), "f32_ratio_max": ratios[worst],
            "worst_group": worst,
            "vs_plain_largest_rel_err": max(v["rel_err"] for v in vs_plain.values()),
            "vs_plain_smallest_cosine": min(v["cosine"] for v in vs_plain.values()),
            **(by_group if frozen else {}),
            "activations_rel_to_f32": {k: _rel(acts[k], acts_32[k]) for k in sorted(acts_32)},
        }), flush=True)

    print(json.dumps({"seed": seed, "path": path, "step": "plain", "loss_rel_to_f32":
                      abs(loss_p - loss_32) / abs(loss_32),
                      "activations_rel_to_f32": {k: _rel(acts_p[k], acts_32[k])
                                                 for k in sorted(acts_32)}}), flush=True)
    report("kernels", ())
    for k in kernels:
        report(f"kernels, {k} plain", (k,))
    for k in kernels:
        report(f"plain, {k} kernel", tuple(n for n in kernels if n != k))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frozen", action="store_true",
                    help="phase 7's frozen path instead of phase 8's unfrozen one")
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
        attribute(seed, args.frozen)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
