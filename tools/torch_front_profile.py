#!/usr/bin/env python3
"""Where the time goes in the port's stage-2b dCRF and stage-1 CLIP scorer on
one GPU.

On ``chip_smoke.front_check_inputs`` (two 640^2 images, four jagged part
masks each in 8 slots, 16 boxes each), at the CLI's dCRF parameters
(10 iterations, stride 4, 9 labels, f32):
  * one ``run.make_refine_fn`` batch (B = 2) by parts with CUDA events over
    ``--repeats`` runs: the unpacking and unary, the window setup, the ten
    mean-field steps (the Gaussian blur, the bilateral apply, the rest),
    the argmax and packing;
  * one traced refine batch and one traced CLIP scorer batch (ViT-B/32
    bf16 from seeded weights, 2 x 16 crops against 22,000 text embeddings)
    with ``torch.profiler``: device time by kernel family and the device's
    idle share of the traced wall time.

Prints one JSON line per measurement and the card's name and power limit;
writes the Chrome traces under ``--out``. Run from the repository root:
``python3 tools/torch_front_profile.py``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_front_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from partdistillation_torch.models.meta_arch.labeling import (clip_region_scorer_device,
                                                                  clip_text_classifier_device)
    from partdistillation_torch.ops import dense_crf as crf
    from partdistillation_torch.run import make_refine_fn
    from partdistillation_torch.utils.bitpack import pack_bits, pack_bits_np, unpack_bits
    from torch_kmeans_profile import emit, trace

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = Path(args.out)
    images, boxes, (_, masks, valid) = cs.front_check_inputs(args.seed)
    size, slots = images.shape[1], masks.shape[1]
    p = crf.DenseCRFParams()
    refine = make_refine_fn(p, slots, size, torch.device("cuda"))
    wire = (images, pack_bits_np(masks), valid)
    for _ in range(2):
        refine(*wire)

    names = ("unary", "setup", "blur", "apply", "rest_of_step", "labels")
    parts = {k: [] for k in (*names, "total")}
    labels = 1 + torch.arange(slots, device="cuda")[:, None, None]
    with torch.inference_mode():
        for _ in range(args.repeats):
            marks = {k: 0.0 for k in names}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            first = torch.cuda.Event(enable_timing=True)
            first.record()

            def timed(name, fn):
                ev[0].record()
                out = fn()
                ev[1].record()
                torch.cuda.synchronize()
                marks[name] += ev[0].elapsed_time(ev[1])
                return out

            image = torch.as_tensor(images).cuda().float()
            m = unpack_bits(torch.as_tensor(wire[1]).cuda(), size)
            v = torch.as_tensor(valid).cuda()
            log_u = timed("unary", lambda: -crf.unary_from_masks(m, v, p.gt_prob))
            band, geom = timed("setup", lambda: crf._bilateral_conv_setup(
                image, p.bilateral_sxy, p.bilateral_srgb, p.bilateral_stride))
            q = torch.softmax(log_u, dim=-1)
            for _ in range(p.iters):
                g = timed("blur", lambda: crf.gaussian_blur(q, p.gauss_sxy))
                b = timed("apply", lambda: crf._bilateral_conv_apply(q, band, geom))
                q = timed("rest_of_step", lambda: torch.softmax(
                    log_u + p.gauss_compat * (g - q) + p.bilateral_compat * (b - q), dim=-1))
            timed("labels", lambda: pack_bits(q.argmax(-1)[:, None] == labels))
            last = torch.cuda.Event(enable_timing=True)
            last.record()
            torch.cuda.synchronize()
            for k in names:
                parts[k].append(marks[k])
            parts["total"].append(first.elapsed_time(last))
    emit({"phase": "dcrf_parts_ms_median", "card": smi, "batch_size": images.shape[0],
          "repeats": args.repeats, "iters": p.iters,
          **{k: float(np.median(v)) for k, v in parts.items()}})
    trace("dcrf", lambda: refine(*wire), out_dir, smi)

    vision, text = cs.clip_towers(args.seed, "cuda")
    text_emb = clip_text_classifier_device(text, cs.clip_prompts(args.seed, cs.CLIP_CLASSES))
    scorer = clip_region_scorer_device(vision, text_emb)
    for _ in range(2):
        scorer.batched(images, boxes)
    trace("clip_scorer", lambda: scorer.batched(images, boxes), out_dir, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
