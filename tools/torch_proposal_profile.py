#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's proposal inference on one GPU.

Builds the full-width model of ``chip_smoke.py`` (Swin-L, 6-layer MSDeformAttn
pixel decoder, 9-layer decoder, bf16, seeded random weights), warms it up,
then:
  * times each layer (backbone, pixel decoder, transformer decoder,
    post-processing) with CUDA events over ``--repeats`` runs;
  * traces one full ``make_inference_fn`` batch with ``torch.profiler`` and
    sums device time by kernel and by kernel family, with the device's idle
    share of the traced wall time.

Prints one JSON line per measurement and the card's name and power limit.
Writes the Chrome trace under ``--out``. Run from the repository root:
``python3 tools/torch_proposal_profile.py``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAMILIES = [  # (family, kernel-name pattern), first match wins
    ("layer_norm kernel", r"ln_rows_\w*kernel"),
    # #6's two launches: its attention and the shared GEMM's projection instance
    ("window_attention_proj kernels", r"window_attn_proj_kernel|ln_mlp_gemm_kernel<\d+, 2>"),
    # #2's backward: its own kernels and the LayerNorm pass that keeps the statistics
    ("fused_ln_mlp backward kernels", r"mlp_bwd_\w*kernel|ln_mlp_norm_kernel<true>"),
    ("fused_ln_mlp kernels", r"ln_mlp_\w*kernel"),
    ("window_attention kernel", r"window_attn_kernel"),
    ("msda_folded kernel", r"msda_folded_kernel"),
    ("msda_taps kernel", r"msda_taps_kernel"),
    ("masked_attention_bwd kernels", r"masked_attn_bwd_\w*kernel"),
    ("masked_attention kernels", r"masked_attn_\w*kernel"),
    ("matmul (cuBLAS/CUTLASS)", r"gemm|cutlass|cublas|xmma|sm90_|sm80_|s16816|splitK"),
    ("convolution (cuDNN)", r"conv|implicit|winograd|fprop"),
    ("gather / index", r"gather|index|scatter"),
    ("resize", r"upsample|interp"),
    ("reduction / softmax / norm", r"reduce|softmax|norm|argmax|max_|sum"),
    ("copy / cast", r"copy|cast|convert|transpose|permute|cat"),
]


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.I):
            return fam
    return "elementwise / other"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_proposal_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import full_config, synthetic_batch
    from partdistillation_torch.models.meta_arch.proposal import (
        _infer_one, make_inference_fn, normalize_images)
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.ops.instance_post import as_bool_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = full_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=args.seed)
    infer = make_inference_fn(cfg, model, device="cuda")
    batch = synthetic_batch(np.random.default_rng(args.seed), args.batch_size, args.image_size)
    for _ in range(2):
        infer(batch)
    torch.cuda.synchronize()

    # per-layer device time with CUDA events
    t = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    layers = {"backbone": [], "pixel_decoder": [], "transformer_decoder": [],
              "post_processing": [], "total": []}
    with torch.inference_mode():
        for _ in range(args.repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            feats = model.backbone(normalize_images(t["image"]))
            ev[1].record()
            mf, _, ms = model.sem_seg_head.pixel_decoder(feats)
            ev[2].record()
            out = model.sem_seg_head.predictor(ms, mf)
            ev[3].record()
            pm, om = as_bool_mask(t["part_masks"]), as_bool_mask(t["object_masks"])
            for i in range(args.batch_size):
                _infer_one(cfg, out["pred_logits"][i], out["pred_masks"][i], pm[i],
                           t["part_labels"][i], t["part_valid"][i], om[i],
                           t["object_valid"][i])
            ev[4].record()
            torch.cuda.synchronize()
            for j, name in enumerate(list(layers)[:4]):
                layers[name].append(ev[j].elapsed_time(ev[j + 1]))
            layers["total"].append(ev[0].elapsed_time(ev[4]))
    emit({"phase": "layers_ms_median", "card": smi, "repeats": args.repeats,
          **{k: float(np.median(v)) for k, v in layers.items()}})

    # one traced batch through the entry point
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.elapsed_us() / 1e3
            name = e.name
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += dur
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    fams = {}
    for name, (ms, n) in kernels.items():
        f = fams.setdefault(family(name), [0.0, 0])
        f[0] += ms
        f[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "trace", "card": smi, "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
          "kernel_launches": sum(v[1] for v in kernels.values()),
          "families_ms": {k: round(v[0], 4) for k, v in
                          sorted(fams.items(), key=lambda kv: -kv[1][0])},
          "families_launches": {k: v[1] for k, v in fams.items()},
          "top_kernels": [{"name": n[:90], "ms": round(v[0], 4), "launches": v[1]}
                          for n, v in top]})
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "proposal_inference_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
