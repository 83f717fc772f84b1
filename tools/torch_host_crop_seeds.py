#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py`` phase 15's host-crop CLIP check.

For each seed: the CLIP ViT-B/32 vision tower from that seed in bf16 on the
card and the f32 text tower's embeddings of 22,000 synthetic prompts (as
phase 12 builds them), and ``chip_smoke.front_check_inputs(seed)``: two
synthetic 640^2 images with 16 box masks each (boxes that shrink and grow
to 224^2, and an empty mask). The scorer with host crops (PIL's bilinear on
the uint8 image) against the device crops (JAX's antialiased linear
weights), the same tower and text (``chip_smoke.host_crops_vs_device``):
the share of equal class ids and the largest probability difference.
Prints one JSON line per seed. On the card:
``python3 tools/torch_host_crop_seeds.py --seeds 0 1 2``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
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
        print("torch_host_crop_seeds: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for seed in args.seeds:
        vision, text = cs.clip_towers(seed, "cuda")
        text_emb = clip_text_classifier_device(text, cs.clip_prompts(seed, cs.CLIP_CLASSES))
        images, boxes, _ = cs.front_check_inputs(seed)
        refs = {"phase12": {"vision": vision, "text_emb": text_emb, "images": images,
                            "masks": boxes}}
        print(json.dumps({"seed": seed, "card": card,
                          "host_crops_vs_device": cs.host_crops_vs_device(refs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
