#!/usr/bin/env python3
"""The port's multi-GPU train steps at full width, two ranks on one card.

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      tools/torch_ddp_check.py [--seeds 0 1 2] [--out FILE]

Both ranks run on ``cuda:0`` and join a gloo group (NCCL refuses two ranks
on one GPU), so every collective runs on CUDA tensors through gloo; a
collective gloo refuses raises and the run fails. Per seed:

1. stage 3 (``chip_smoke.train_config``: Swin-L bf16, trunk frozen, DropPath
   0.3, 12544 points): the data-parallel step (``Trainer`` on a (2, 1) mesh,
   B = 1 a rank) against one process's step at B = 2 on the same weights,
   batch, noise and matching, the two images' valid counts unequal (6 and
   2): the total loss (the group mean) and each decoder group's gradient
   after the sync (``chip_smoke.compare_grads``), held to the limits below;
   then the same step with the mask count left per rank, which must miss
   them. The gradient all-reduce's time (``grad_sync_s``, CUDA events) is
   read beside the step's;
2. stage 5 (``chip_smoke.distill_config``: the 22,000 x 8 + 1 column head):
   one step with the head split over both ranks (a (1, 2) mesh) against the
   unsharded step on the same batch, noise and matching: the loss, the
   gradient norm and the head's gradient on the batch's live rows (this
   rank's hidden slice), held to the limits below.

Rank 0 prints one JSON line a seed (and writes them to ``--out``); the exit
code is 1 if a check failed. The limits are about twice the largest
readings of sound runs at seeds 0-2 on an H100 80GB HBM3 at 700 W (this
script, ``--seeds 0 1 2``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEVICE = "cuda:0"
VALID_COUNTS = (6, 2)  # valid masks of the global batch's two images
DISTILL_CLASSES = (4711, 21999)
# Stage 3, data parallel against one process: the sound step read at most
# 0.00357 in the loss, 0.207 and cosine 0.9804 in a decoder group (seed 1,
# the cross-attention's k projection; 0.054 / 0.9986 and 0.043 / 0.9991 at
# seeds 0 and 2): bf16 noise, the kernels seeing a batch of one where the
# reference sees two. The planted per-rank mask count read 0.018-0.051 in
# the loss and cosine 0.932-0.952, outside both limits at every seed.
DDP_LOSS_REL_ERR_LIMIT = 0.0072
DDP_GRAD_REL_ERR_LIMIT, DDP_GRAD_COSINE_LIMIT = 0.42, 0.96
# Stage 5, head sharded against unsharded: the loss read equal at seeds 0-2,
# the head's live-row gradient at most 6.5e-8 and cosine 1 - 1.8e-7, the
# gradient norm 3.3e-5 (its other groups come from a second backward).
HEAD_LOSS_REL_ERR_LIMIT = 1e-6
HEAD_GRAD_REL_ERR_LIMIT, HEAD_GRAD_COSINE_LIMIT = 1.5e-7, 0.9999996
HEAD_GRAD_NORM_REL_ERR_LIMIT = 7e-5


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _global_batch(seed: int, distill: bool) -> dict:
    import chip_smoke as cs

    rng = np.random.default_rng(seed + 1)
    batch = cs.synthetic_train_batch(rng, 2, cs.IMAGE_SIZE)
    for i, n in enumerate(VALID_COUNTS):
        batch["valid"][i, n:] = False
    if distill:
        batch["labels"] = rng.integers(0, cs.DISTILL_PARTS, batch["valid"].shape)
        batch["gt_object_class"] = np.asarray(DISTILL_CLASSES)
    return batch


def _fixed_noise(loss_fn, batch: dict, seed: int) -> dict:
    """The B = 2 step's noise and its matching, computed once."""
    import torch

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    noise = loss_fn.draw_noise(batch, g)
    t = loss_fn.device_batch(batch)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)
    return noise


def _rows(batch: dict, noise: dict, d: int) -> tuple:
    """Data rank ``d``'s image of the B = 2 batch and noise."""
    b = {k: v[d:d + 1] for k, v in batch.items()}
    n = {"drop_keep": noise["drop_keep"][..., d:d + 1],
         **{k: noise[k][:, d:d + 1] for k in ("match_jitter", "point_jitter", "indices")}}
    return b, n


def _step(trainer, batch: dict, noise: dict) -> tuple:
    """One ``train_step``; returns (metrics, its seconds, the gradients the
    update started from)."""
    import torch

    grads, opt = {}, trainer.optimizer
    real = opt.step

    def step():
        grads.update({n: p.grad.detach().clone() for n, p in zip(opt.names, opt.params)})
        return real()

    opt.step = step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch, noise)
    torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0, grads


def stage3(seed: int, mesh) -> dict:
    import chip_smoke as cs
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = cs.train_config()
    model = MaskFormerSegmenter(cfg.segmenter, device=DEVICE, seed=seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _global_batch(seed, distill=False)

    def trainer(group=None, m=None, local=()):
        model.load_state_dict(init)
        loss_fn = make_loss_fn(cfg, model, device=DEVICE, group=group)
        loss_fn.local = local
        return Trainer(loss_fn, model, OptimizerConfig(freeze_keys=cs.FREEZE_KEYS),
                       device=DEVICE, seed=seed, mesh=m)

    ref = trainer()
    noise = _fixed_noise(ref.loss_fn, batch, seed)
    ref_metrics, ref_s, ref_grads = _step(ref, batch, noise)
    local_batch, local_noise = _rows(batch, noise, mesh.data_index)
    out = {"valid_counts": list(VALID_COUNTS), "single_process_step_s": ref_s,
           "total_loss_single_process_b2": ref_metrics["total_loss"]}
    for name, local in (("ddp", ()), ("planted_local_num_masks", ("num_masks",))):
        metrics, seconds, grads = _step(trainer(mesh.data_group, mesh, local),
                                        local_batch, local_noise)
        groups = cs.compare_grads(grads, ref_grads)
        loss_rel = _rel(metrics["total_loss"], ref_metrics["total_loss"])
        out[name] = {"total_loss": metrics["total_loss"], "total_loss_rel_err": loss_rel,
                     "groups": groups, "step_s": seconds,
                     "grad_sync_s": metrics["grad_sync_s"],
                     "grad_sync_share": metrics["grad_sync_s"] / seconds,
                     "ok": loss_rel <= DDP_LOSS_REL_ERR_LIMIT and all(
                         g["rel_err"] <= DDP_GRAD_REL_ERR_LIMIT
                         and g["cosine"] >= DDP_GRAD_COSINE_LIMIT for g in groups.values())}
    out["synced_gradient_bytes"] = sum(g.numel() * g.element_size() for g in grads.values())
    del model, init
    return out


def stage5(seed: int, mesh) -> dict:
    import torch

    import chip_smoke as cs
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.part_distillation import (
        PART_HEAD_WEIGHT, make_loss_fn, shard_part_head)
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.parallel.mesh import take_shard

    cfg = cs.distill_config()
    batch = _global_batch(seed, distill=True)
    results = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        model = MaskFormerSegmenter(cfg.segmenter, device=DEVICE, seed=seed)
        sharded = shard_part_head(model, m) if m is not None else {}
        trainer = Trainer(make_loss_fn(cfg, model, device=DEVICE), model,
                          OptimizerConfig(freeze_keys=cs.FREEZE_KEYS), device=DEVICE,
                          seed=seed, mesh=m, sharded=sharded)
        if name == "unsharded":
            noise = _fixed_noise(trainer.loss_fn, batch, seed)
            cols = model.sem_seg_head.predictor.live_columns(
                torch.as_tensor(batch["gt_object_class"], device=DEVICE)).flatten()
        metrics, seconds, grads = _step(trainer, batch, noise)
        results[name] = (metrics, seconds, grads[PART_HEAD_WEIGHT][cols])
        del model, trainer, grads
    (m_u, s_u, g_u), (m_s, s_s, g_s) = results["unsharded"], results["sharded"]
    a, b = g_s.flatten(), take_shard(g_u, mesh.model_index, mesh.n_model, dim=1).flatten()
    out = {"classes": list(DISTILL_CLASSES), "live_rows": int(cols.numel()),
           "total_loss_unsharded": m_u["total_loss"], "total_loss_sharded": m_s["total_loss"],
           "total_loss_rel_err": _rel(m_s["total_loss"], m_u["total_loss"]),
           "grad_norm_rel_err": _rel(m_s["grad_norm"], m_u["grad_norm"]),
           "head_grad_rel_err": ((a - b).norm() / b.norm()).item(),
           "head_grad_cosine": (a @ b / (a.norm() * b.norm())).item(),
           "step_s_unsharded": s_u, "step_s_sharded": s_s}
    out["ok"] = (out["total_loss_rel_err"] <= HEAD_LOSS_REL_ERR_LIMIT
                 and out["grad_norm_rel_err"] <= HEAD_GRAD_NORM_REL_ERR_LIMIT
                 and out["head_grad_rel_err"] <= HEAD_GRAD_REL_ERR_LIMIT
                 and out["head_grad_cosine"] >= HEAD_GRAD_COSINE_LIMIT)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=None, help="rank 0 writes its JSON lines here")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from partdistillation_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        print("torch_ddp_check: no CUDA device", file=sys.stderr)
        return 2
    if "RANK" not in os.environ:
        print("torch_ddp_check: run it under torchrun (two ranks)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(minutes=10))
    try:
        if dist.get_world_size() != 2:
            raise SystemExit("torch_ddp_check needs a world of 2")
        data_mesh, model_mesh = make_mesh(2, 1), make_mesh(1, 2)
        lines = []
        for seed in args.seeds:
            s3 = stage3(seed, data_mesh)
            torch.cuda.empty_cache()
            s5 = stage5(seed, model_mesh)
            torch.cuda.empty_cache()
            line = {"seed": seed, "device": torch.cuda.get_device_name(0),
                    "backend": "gloo, CUDA tensors, 2 ranks on one card",
                    "stage3_data_parallel": s3, "stage5_head_sharded": s5,
                    "limits": {"ddp_loss_rel_err": DDP_LOSS_REL_ERR_LIMIT,
                               "ddp_grad_rel_err": DDP_GRAD_REL_ERR_LIMIT,
                               "ddp_grad_cosine": DDP_GRAD_COSINE_LIMIT,
                               "head_loss_rel_err": HEAD_LOSS_REL_ERR_LIMIT,
                               "head_grad_norm_rel_err": HEAD_GRAD_NORM_REL_ERR_LIMIT,
                               "head_grad_rel_err": HEAD_GRAD_REL_ERR_LIMIT,
                               "head_grad_cosine": HEAD_GRAD_COSINE_LIMIT},
                    "ok": (s3["ddp"]["ok"] and not s3["planted_local_num_masks"]["ok"]
                           and s5["ok"])}
            lines.append(line)
            if dist.get_rank() == 0:
                print(json.dumps(line), flush=True)
        if dist.get_rank() == 0 and args.out:
            Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
        return 0 if all(x["ok"] for x in lines) else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
