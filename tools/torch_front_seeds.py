#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py`` phase 12's card-against-CPU limits.

For each seed: the CLIP ViT-B/32 towers from that seed (the vision tower in
bf16 on the card, the text tower in f32), the text embeddings of 22,000
synthetic prompts, and ``chip_smoke.front_check_inputs(seed)``: two
synthetic 640^2 images with 16 box masks each (boxes that shrink and grow
to 224^2, and an empty mask), scored on the card and in f32 on the CPU
(``chip_smoke.clip_card_vs_cpu``: sound and with the crop boxes
transposed); then the dCRF at the CLI's parameters on the same images'
four jagged part strips, on the card and on the CPU
(``chip_smoke.dcrf_card_vs_cpu``: sound and with the colour term dropped),
as phase 12 runs it.
Both TF32 flags are on throughout, as in phase 12. Prints one JSON line per
seed. On the card: ``python3 tools/torch_front_seeds.py --seeds 0 1 2``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from partdistillation_torch.models.meta_arch.labeling import clip_text_classifier_device

    if not torch.cuda.is_available():
        print("torch_front_seeds: no CUDA device", file=sys.stderr)
        return 2
    with cs.tf32_flags_on():
        for seed in args.seeds:
            vision, text = cs.clip_towers(seed, "cuda")
            prompts = cs.clip_prompts(seed, cs.CLIP_CLASSES)
            text_emb = clip_text_classifier_device(text, prompts)
            images, boxes, crf = cs.front_check_inputs(seed)
            print(json.dumps({
                "seed": seed,
                "text_card_vs_cpu_max_abs_diff": cs.text_card_vs_cpu(text, prompts[:64],
                                                                     text_emb[:64]),
                "clip": cs.clip_card_vs_cpu(vision, text_emb, images, boxes),
                "dcrf": cs.dcrf_card_vs_cpu(*crf)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
