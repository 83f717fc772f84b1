#!/usr/bin/env python3
"""Where the time goes in the port's k-means stages on one GPU.

Builds the full-width models of ``chip_smoke.py`` phase 11 at seeded random
weights: stage 2's bare Swin-L (bf16, k = 4) and stage 4's segmenter (the
stage-3 model, 200 queries) with a random 22,000 x 8 x 256 centroid bank.
Then:
  * stage 2 by parts with CUDA events over ``--repeats`` runs: the
    backbone, the feature map at 1/8 (res4 resized, concatenated), the
    masked k-means and the full-resolution labelling;
  * one traced batch of each entry point (``make_generation_fn``,
    ``make_cluster_fn``, ``make_label_fn`` in SAVE mode) with
    ``torch.profiler``: device time by kernel family and the device's idle
    share of the traced wall time.

Prints one JSON line per measurement and the card's name and power limit.
Writes the Chrome traces under ``--out``. Run from the repository root:
``python3 tools/torch_kmeans_profile.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def trace(name: str, fn, out_dir: Path, smi: str) -> None:
    """One traced call of ``fn``: device time by kernel family, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_proposal_profile import family

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, launches, busy = {}, 0, 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.elapsed_us() / 1e3
            f = fams.setdefault(family(e.name), [0.0, 0])
            f[0] += dur
            f[1] += 1
            busy += dur
            launches += 1
    emit({"phase": f"trace_{name}", "card": smi, "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
          "kernel_launches": launches,
          "families_ms": {k: round(v[0], 4) for k, v in
                          sorted(fams.items(), key=lambda kv: -kv[1][0])},
          "families_launches": {k: v[1] for k, v in fams.items()}})
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"{name}_trace.json"))


def lloyd_parts(x, mask, centroids, repeats: int, smi: str) -> None:
    """One Lloyd iteration of ``ops.kmeans.lloyd`` split by CUDA events: the
    distances (norms and the (N, D) x (D, k) product), the assignment
    (argmin, one-hot), the sums ((k, N) x (N, D)) and the update."""
    import torch

    from partdistillation_torch.ops.kmeans import pairwise_sqdist

    k = centroids.shape[1]
    valid = mask.float().unsqueeze(-1)
    clusters = torch.arange(k, device=x.device)
    parts = {"distances": [], "assignment": [], "sums": [], "update": []}
    with torch.inference_mode():
        for _ in range(repeats + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            dist = pairwise_sqdist(x, centroids)
            ev[1].record()
            onehot = (dist.argmin(-1).unsqueeze(-1) == clusters).float() * valid
            ev[2].record()
            sums = onehot.transpose(1, 2) @ x
            ev[3].record()
            counts = onehot.sum(1)
            torch.where(counts.unsqueeze(-1) > 0, sums / counts.clamp(min=1.0).unsqueeze(-1),
                        centroids)
            ev[4].record()
            torch.cuda.synchronize()
            for j, name in enumerate(parts):
                parts[name].append(ev[j].elapsed_time(ev[j + 1]))
    emit({"phase": "lloyd_iteration_ms_median", "card": smi, "shape": list(x.shape) + [k],
          **{name: float(np.median(v[1:])) for name, v in parts.items()}})


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
        print("torch_kmeans_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import RANK_CLUSTERS, RANK_OBJECTS, full_config, synthetic_batch
    from partdistillation_torch.models.meta_arch import part_ranking as pr
    from partdistillation_torch.models.meta_arch import proposal_generation as pg
    from partdistillation_torch.models.meta_arch.proposal import normalize_images
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.models.swin import swin_large_config
    from partdistillation_torch.ops.kmeans import masked_kmeans, seed_uniforms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = Path(args.out)
    b = args.batch_size
    batch = synthetic_batch(np.random.default_rng(args.seed), b, args.image_size)
    u = seed_uniforms(args.seed, range(b), 4)

    # stage 2
    gen_cfg = pg.ProposalGenerationConfig(swin=swin_large_config(dtype=torch.bfloat16))
    backbone = pg.make_backbone(gen_cfg.swin, device="cuda", seed=args.seed)
    gen_fn = pg.make_generation_fn(gen_cfg, backbone, device="cuda")
    gen_batch = {"image": batch["image"], "object_mask": batch["object_masks"][:, 0]}
    for _ in range(2):
        gen_fn(gen_batch, u)
    image = torch.as_tensor(batch["image"], device="cuda")
    obj = torch.as_tensor(gen_batch["object_mask"], device="cuda")
    parts = {"backbone": [], "features": [], "kmeans": [], "labelling": [], "total": []}
    with torch.inference_mode():
        for _ in range(args.repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            feats = backbone(normalize_images(image))
            ev[1].record()
            lo = torch.cat([feats["res3"], pg.resize_bilinear(feats["res4"],
                                                              *feats["res3"].shape[1:3])], -1)
            ev[2].record()
            _, h, w, d = lo.shape
            cents, _ = masked_kmeans(lo.reshape(b, h * w, d),
                                     pg.downsample_mask(obj, h, w).reshape(b, h * w),
                                     torch.as_tensor(u, device="cuda"))
            ev[3].record()
            for i in range(b):
                hi = pg.resize_bilinear(lo[i:i + 1], *obj.shape[1:])[0]
                (hi.float() @ cents[i].t()).argmax(-1)
            ev[4].record()
            torch.cuda.synchronize()
            for j, name in enumerate(list(parts)[:4]):
                parts[name].append(ev[j].elapsed_time(ev[j + 1]))
            parts["total"].append(ev[0].elapsed_time(ev[4]))
    emit({"phase": "propose_parts_ms_median", "card": smi, "repeats": args.repeats,
          "batch_size": b, **{k: float(np.median(v)) for k, v in parts.items()}})
    lloyd_parts(lo.reshape(b, h * w, d).float(), pg.downsample_mask(obj, h, w).reshape(b, h * w),
                cents, args.repeats, smi)
    trace("propose", lambda: gen_fn(gen_batch, u), out_dir, smi)
    del backbone, gen_fn, feats, lo
    torch.cuda.empty_cache()

    # stage 4
    seg = full_config().segmenter
    rank_cfg = pr.PartRankingConfig(segmenter=seg, num_clusters=RANK_CLUSTERS)
    model = MaskFormerSegmenter(seg, device="cuda", seed=args.seed)
    bank = torch.randn((RANK_OBJECTS, RANK_CLUSTERS, seg.decoder.hidden_dim),
                       generator=torch.Generator().manual_seed(args.seed)).cuda()
    rank_batch = {"image": batch["image"], "masks": batch["part_masks"],
                  "mask_valid": batch["part_valid"], "object_mask": batch["object_masks"][:, 0],
                  "object_label": np.array([4711, 21999][:b] + [0] * max(b - 2, 0)),
                  "mask_labels": np.zeros(batch["part_valid"].shape, np.int32)}
    cluster_fn = pr.make_cluster_fn(rank_cfg, model, device="cuda")
    label_fn = pr.make_label_fn(rank_cfg, model, pr.RankingMode.SAVE, device="cuda")
    for _ in range(2):
        cluster_fn(rank_batch)
        label_fn(rank_batch, bank)
    trace("rank_cluster", lambda: cluster_fn(rank_batch), out_dir, smi)
    trace("rank_save", lambda: label_fn(rank_batch, bank), out_dir, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
