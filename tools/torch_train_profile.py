#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's stage-3 and stage-5 train steps
on one GPU.

Builds the train path of ``chip_smoke.py`` (full-width Swin-L, 6-layer
MSDeformAttn pixel decoder, 9-layer decoder, bf16, trunk frozen, DropPath
0.3, 12544 grid points, seeded random weights; with ``--unfrozen`` its
unfrozen path: trunk trained, Swin's window attention fused with its output
projection; with ``--distill`` the stage-5 step of its phase 10: banded
sampling and the 22,000 x 8 + 1 column part head, two images of classes
4711 and 21999), warms it up, then:
  * splits ``--repeats`` steps into forward / criterion + matching /
    backward / optimizer with CUDA events (the calls ``Trainer.train_step``
    makes), and times the matcher's host round trip (device costs, one copy
    each way, the host LSAP) and the host LSAP alone;
  * traces one ``Trainer.train_step`` with ``torch.profiler`` and sums
    device time by kernel and by kernel family, with the device's idle share
    of the traced wall time.

Prints one JSON line per measurement and the card's name and power limit.
Writes the Chrome trace under ``--out``. Run from the repository root:
``python3 tools/torch_train_profile.py``.
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--unfrozen", action="store_true",
                    help="profile chip_smoke.py's unfrozen train path")
    ap.add_argument("--distill", action="store_true",
                    help="profile chip_smoke.py's stage-5 train step (the part head)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (BATCH_SIZE, DISTILL_PARTS, FREEZE_KEYS, IMAGE_SIZE,
                            distill_config, synthetic_train_batch, train_config,
                            unfrozen_config)
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.losses.lsap import solve_lsap_batch
    from partdistillation_torch.losses.matcher import match_costs
    from partdistillation_torch.losses.criterion import supervised_layers
    from partdistillation_torch.models.meta_arch import part_distillation, proposal
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from tools.torch_proposal_profile import family

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    rng = np.random.default_rng(args.seed)
    batch = synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE)
    if args.distill:
        cfg, meta, path = distill_config(), part_distillation, "distill"
        batch["labels"] = rng.integers(0, DISTILL_PARTS, batch["valid"].shape).astype(np.int32)
        batch["gt_object_class"] = np.array([4711, 21999][:BATCH_SIZE], np.int32)
    else:
        cfg, meta = (unfrozen_config() if args.unfrozen else train_config()), proposal
        path = "unfrozen" if args.unfrozen else "frozen"
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=args.seed)
    loss_fn = meta.make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model,
                      OptimizerConfig(freeze_keys=() if args.unfrozen else FREEZE_KEYS),
                      device="cuda", seed=args.seed)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()

    # per-phase device-timeline time with CUDA events
    phases = {"forward": [], "criterion_and_matching": [], "backward": [], "optimizer": [],
              "total": []}
    t = loss_fn.device_batch(batch)
    for _ in range(args.repeats):
        noise = loss_fn.draw_noise(batch, trainer.generator)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        outputs = loss_fn.forward(t, noise)
        ev[1].record()
        total, _ = loss_fn.criterion(outputs, t, noise)
        ev[2].record()
        total.backward()
        ev[3].record()
        trainer.apply_gradients()
        ev[4].record()
        torch.cuda.synchronize()
        for j, name in enumerate(list(phases)[:4]):
            phases[name].append(ev[j].elapsed_time(ev[j + 1]))
        phases["total"].append(ev[0].elapsed_time(ev[4]))
    emit({"phase": "train_step_ms_median", "path": path, "card": smi, "repeats": args.repeats,
          **{k: float(np.median(v)) for k, v in phases.items()}})

    # the matcher's host round trip, and the host LSAP alone
    with torch.no_grad():
        outputs = loss_fn.forward(t, noise)
        targets = loss_fn.targets(t)
        layers = supervised_layers(outputs)
        round_trip, host = [], []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_fn.match(outputs, t, noise)
            torch.cuda.synchronize()
            round_trip.append((time.perf_counter() - t0) * 1e3)
            costs = torch.stack([match_costs(o["pred_logits"], o["pred_masks"], targets,
                                             noise["match_jitter"][i], cfg.criterion.matcher)
                                 for i, o in enumerate(layers)]).cpu().numpy()
            t0 = time.perf_counter()
            solve_lsap_batch(costs)
            host.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "matching_ms_median", "card": smi, "problems": int(np.prod(costs.shape[:2])),
          "problem_shape": list(costs.shape[2:]), "round_trip": float(np.median(round_trip)),
          "host_lsap": float(np.median(host))})
    del outputs

    # one traced train step through the entry point
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    fams = {}
    for name, (ms, n) in kernels.items():
        f = fams.setdefault(family(name), [0.0, 0])
        f[0] += ms
        f[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "trace", "path": path, "card": smi, "wall_ms": wall_ms,
          "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
          "kernel_launches": sum(v[1] for v in kernels.values()),
          "families_ms": {k: round(v[0], 4) for k, v in
                          sorted(fams.items(), key=lambda kv: -kv[1][0])},
          "families_launches": {k: v[1] for k, v in fams.items()},
          "top_kernels": [{"name": n[:90], "ms": round(v[0], 4), "launches": v[1]}
                          for n, v in top]})
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"proposal_train_step_{path}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
