#!/usr/bin/env python3
"""The stage CLIs on several GPUs of one host through NCCL, against world 1.

  python3 tools/torch_nccl_world.py [--gpus 4] [--steps 4] [--seed 0]
  python3 tools/torch_nccl_world.py --tiny --device cpu   # the same runs over gloo

Over ``chip_smoke.cli_dataset`` and ``chip_smoke.stage4_store`` (8 synthetic
JPEGs of two synsets; the full-size default on ``cuda``, the tiny f32 model
with ``--tiny --device cpu``), each run a ``torchrun --standalone`` launch of
``python -m partdistillation_torch.run``:

1. ``train-proposal`` for ``--steps`` steps at B = 2 a rank, at world 1 and
   world 2 (the split's two classes, one a data rank): step s, steady img/s
   of the global batch, and at world 2 the gradient all-reduce's time
   (``grad_sync_s``) and share of the step;
2. ``train-distillation`` at world ``--gpus`` with ``n_model_shards=2``
   (gpus / 2 data ranks x 2 model ranks, the head's hidden dimension split
   in two): the same numbers, and the checkpoint's head whole;
3. ``eval-proposal`` (the world-2 checkpoint) and ``distill-eval`` (the
   world-``gpus`` checkpoint, its head sharded again) at world 1 and world
   ``gpus``: the metrics must be equal;
4. ``rank --phases cluster,save`` at world ``gpus``: one store shard a rank,
   whose records together cover the split once.

Prints one JSON line a run and a last summary line; exits 1 if a check
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

METRICS = ("C-mIoU", "A-mIoU", "C-mACC", "A-mACC", "C-mIoPred", "A-mIoPred")


def torchrun(nproc: int, argv, out_dir: str, tag: str) -> list:
    """``argv`` on ``nproc`` ranks; returns each rank's last JSON line (the
    ranks' own logs are kept under ``out_dir``)."""
    logs = os.path.join(out_dir, tag)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "--log-dir", logs, "--redirects", "1", "--tee", "0",
         "-m", "partdistillation_torch.run", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{tag} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = []
    for rank in range(nproc):
        found = sorted(Path(logs).rglob(f"{rank}/stdout.log"))
        text = found[-1].read_text()
        lines.append(json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1]))
    print(json.dumps({"run": tag, "ranks": nproc, "wall_s": round(wall, 3),
                      "rank0": lines[0]}), flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from partdistillation_torch.data.pseudo_store import PseudoLabelStore

    device = [] if args.device == "cuda" else ["--device", args.device]
    if args.device == "cuda":
        if torch.cuda.device_count() < args.gpus:
            print(f"torch_nccl_world: {torch.cuda.device_count()} GPU(s), {args.gpus} asked",
                  file=sys.stderr)
            return 2
        from partdistillation_torch.utils import native_lib

        native_lib.build_library()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    tiny = ["--tiny", *device] if args.tiny else device
    size = ["data.image_size=64"] if args.tiny else []
    head = ["--num-object-classes", str(cs.DISTILL_OBJECTS), "--num-parts",
            str(cs.DISTILL_PARTS)]
    g = args.gpus
    failures, summary = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        ov = cs.cli_dataset(tmp, args.seed)
        extra, _ = cs.stage4_store(tmp, args.seed)
        ov += extra + size + [f"data.batch_size={cs.CLI_BATCH}", "log_every=1",
                              "checkpoint_every=1000"]
        train = {}
        for world in (1, 2):
            res = torchrun(world, ["train-proposal", *tiny, "--set", *ov,
                                   f"max_iters={args.steps}", f"checkpoint_dir={tmp}/p{world}"],
                           tmp, f"train_proposal_world{world}")
            train[world] = res[0]
            if any(r["steps"] != args.steps for r in res):
                failures.append(f"train-proposal world {world}: {res}")
        distill = torchrun(g, ["train-distillation", *tiny, *head, "--set", *ov,
                               f"max_iters={args.steps}", f"checkpoint_dir={tmp}/d{g}",
                               "n_model_shards=2"], tmp, f"train_distillation_world{g}")
        saved = torch.load(f"{tmp}/d{g}/part_distillation/model_{args.steps:08d}.pt",
                           map_location="cpu", weights_only=True)["model"]
        head_shape = list(saved["sem_seg_head.predictor.part_class_embed.weight"].shape)
        del saved
        evals = {}
        for name, argv, world1 in (
                ("eval_proposal", ["eval-proposal", *tiny, "--trainer-checkpoint",
                                   f"{tmp}/p2/proposal", "--set", *ov], []),
                ("distill_eval", ["distill-eval", *tiny, *head, "--num-gt-parts",
                                  str(cs.DISTILL_GT_PARTS), "--trainer-checkpoint",
                                  f"{tmp}/d{g}/part_distillation", "--set", *ov,
                                  "n_model_shards=2"], ["n_model_shards=1"])):
            one = torchrun(1, [*argv, f"checkpoint_dir={tmp}/{name}1", *world1], tmp,
                           f"{name}_world1")[0]
            many = torchrun(g, [*argv, f"checkpoint_dir={tmp}/{name}{g}"], tmp,
                            f"{name}_world{g}")
            keys = [k for k in one if k.startswith(("AR@", "# instances")) or k in METRICS]
            want = json.dumps({k: one[k] for k in keys})
            if not keys or any(json.dumps({k: r[k] for k in keys}) != want for r in many):
                failures.append(f"{name}: world {g} {many[0]} against world 1 {one}")
            evals[name] = {k: one[k] for k in keys}
        rank_root = os.path.join(tmp, "rank_labels")
        os.makedirs(rank_root)
        os.symlink(os.path.join(tmp, "pseudo_labels", "proposals_dcrf"),
                   os.path.join(rank_root, "proposals_dcrf"))
        torchrun(g, ["rank", *tiny, "--allow-random-init", "--num-object-classes",
                     str(cs.DISTILL_OBJECTS), "--set", *ov, f"paths.root={rank_root}",
                     f"checkpoint_dir={tmp}/r{g}"], tmp, f"rank_world{g}")
        store = os.path.join(rank_root, "part_masks_with_class")
        shards = sorted(p for p in os.listdir(store) if p.endswith(".pdrec"))
        ids = [r["image_id"] for r in PseudoLabelStore(store)]
        n_items = len(cs.CLI_CODES) * cs.CLI_IMAGES_PER_CLASS
        if len(shards) != g or len(ids) != len(set(ids)) or len(ids) > n_items:
            failures.append(f"rank store: shards {shards}, ids {ids}")
        keys = ("step_s", "images_per_sec_steady", "loader_wait_s", "grad_sync_s")
        summary = {
            "train_proposal": {f"world{w}": {k: train[w].get(k) for k in keys}
                               for w in (1, 2)},
            "train_proposal_grad_sync_share": train[2]["grad_sync_s"] / train[2]["step_s"],
            "train_distillation": {f"world{g}_model2": {k: distill[0].get(k) for k in keys}},
            "train_distillation_grad_sync_share":
                distill[0]["grad_sync_s"] / distill[0]["step_s"],
            "head_shape_in_checkpoint": head_shape, "eval_metrics_world1": evals,
            "rank_shards": len(shards), "rank_records": len(ids)}
    print(json.dumps({"summary": summary, "failures": failures,
                      "device": torch.cuda.get_device_name(0) if args.device == "cuda"
                      else args.device, "gpus": g}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
