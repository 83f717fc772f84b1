"""Ranks of the multi-process tests, run as subprocesses over gloo.

``run_ranks(case, world, tmp, *args)`` starts ``world`` processes of this
file, each joining a gloo group through a ``FileStore`` in ``tmp`` (or, for
the cases that go through ``engine.launch.initialize``, torchrun's
variables with a port found at run time), runs ``case`` and writes its
result to ``tmp/rank{r}.pt``; every process has a time limit, so a hung rank
fails its test. The cases hold the data-parallel step and the sharded part
head against the single-process step on the same weights, batch and noise.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def spawn(argvs, envs, timeout: int = TIMEOUT_S) -> list:
    """Run one process per argv (with its extra env) from the repository
    root; returns their stdout. Every process must exit 0 within
    ``timeout`` seconds, else all are killed and the call raises."""
    procs = [subprocess.Popen(argv, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                                                   "OMP_NUM_THREADS": "2", **env},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}"
    return [out for out, _ in outs]


def run_ranks(case: str, world: int, tmp: Path, *args: str, timeout: int = TIMEOUT_S) -> list:
    """``case`` on ``world`` gloo ranks; returns each rank's result."""
    import torch

    port = free_port()
    spawn([[sys.executable, __file__, case, str(r), str(world), str(tmp), *args]
           for r in range(world)],
          [torchrun_env(r, world, port) for r in range(world)], timeout)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- the ranks


def _join_file_store(rank: int, world: int, tmp: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(str(tmp / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)


def case_collectives(rank: int, world: int, tmp: Path) -> dict:
    """``initialize`` from torchrun's variables, then the gathers, the
    barrier and the mesh layouts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from partdistillation_torch.engine import launch
    from partdistillation_torch.parallel.mesh import (copy_to_group, make_mesh,
                                                      reduce_from_group)

    owned = launch.initialize("cpu", timeout=GROUP_TIMEOUT)
    ragged = [np.full((rank + 1, 3 * rank + 1), rank, np.float32) for _ in range(rank + 2)]
    gathered = launch.all_gather_objects({"rank": rank, "ragged": ragged})
    launch.barrier()
    layouts = {}
    for n_data, n_model in ((world, 1), (1, world)):
        mesh = make_mesh(n_data, n_model)
        layouts[(n_data, n_model)] = {
            "data_index": mesh.data_index, "model_index": mesh.model_index,
            "data_ranks": (dist.get_process_group_ranks(mesh.data_group)
                           if mesh.data_group is not None else None),
            "model_ranks": (dist.get_process_group_ranks(mesh.model_group)
                            if mesh.model_group is not None else None)}
    # the head's pair of functions: identity / sum forward, sum / identity backward
    mesh = make_mesh(1, world)
    x = torch.arange(4.0, requires_grad=True)
    y = reduce_from_group(copy_to_group(x, mesh.model_group) * (rank + 1), mesh.model_group)
    (y * torch.arange(4.0)).sum().backward()
    out = {"owned": owned, "index": launch.process_index(), "count": launch.process_count(),
           "main": launch.is_main_process(), "gathered": gathered, "layouts": layouts,
           "head_fwd": y.detach(), "head_grad": x.grad}
    launch.teardown()
    return out


def case_dies(rank: int, world: int, tmp: Path) -> dict:
    """Rank 1 dies after joining; rank 0's next gather must raise."""
    from partdistillation_torch.engine import launch

    launch.initialize("cpu", timeout=GROUP_TIMEOUT)
    launch.barrier()
    if rank == 1:
        os._exit(3)
    launch.all_gather_objects(rank)
    return {"survived": True}


# ---------------------------------------------------------------- train steps

B, T, SIZE, QUERIES, POINTS = 2, 6, 64, 8, 256
VALID = ((1, 1, 1, 1, 1, 0), (1, 1, 0, 0, 0, 0))  # unequal valid counts per rank
NUM_OBJ, PARTS = 16, 4


def _model_cfg(kind: str):
    """The tiny f32 segmenter of the CLIs' ``--tiny`` and its loss config:
    ``frozen`` / ``unfrozen`` stage 3 (DropPath 0.3 when unfrozen),
    ``distill``, stage 5 with the part head, or ``supervised``, the
    supervised ablation (trunk unfrozen, DropPath 0.3, PARTS classes, the
    criterion's random point mode)."""
    import dataclasses

    from partdistillation_torch import run
    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig
    from partdistillation_torch.models.meta_arch.part_distillation import (
        PartDistillationConfig)
    from partdistillation_torch.models.meta_arch.proposal import ProposalModelConfig
    from partdistillation_torch.models.meta_arch.supervised import SupervisedModelConfig

    distill, supervised = kind == "distill", kind == "supervised"
    classes = PARTS if distill or supervised else 1
    seg = run._segmenter_cfg(True, num_classes=classes, num_queries=QUERIES,
                             num_object_classes=NUM_OBJ if distill else 0, num_parts=PARTS,
                             freeze_trunk=kind not in ("unfrozen", "supervised"))
    if kind in ("unfrozen", "supervised"):
        seg = dataclasses.replace(seg, swin=dataclasses.replace(seg.swin, drop_path_rate=0.3))
    crit = CriterionConfig(num_classes=classes, num_points=POINTS,
                           importance_sample_ratio=0.75 if supervised else 0.0,
                           matcher=MatcherConfig(num_points=POINTS))
    if distill:
        return seg, PartDistillationConfig(segmenter=seg, criterion=crit, num_parts=PARTS)
    if supervised:
        return seg, SupervisedModelConfig(segmenter=seg, criterion=crit, num_part_classes=PARTS)
    return seg, ProposalModelConfig(segmenter=seg, criterion=crit)


def _batch(kind: str) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    masks = np.zeros((B, T, SIZE, SIZE), np.float32)
    for b in range(B):
        for t in range(T):
            y, x = rng.integers(0, SIZE - 16, 2)
            h, w = rng.integers(8, 24, 2)
            masks[b, t, y:y + h, x:x + w] = 1.0
    batch = {"image": torch.as_tensor(rng.uniform(0, 255, (B, SIZE, SIZE, 3)), dtype=torch.float32),
             "masks": torch.as_tensor(masks), "valid": torch.as_tensor(np.asarray(VALID, bool))}
    if kind in ("distill", "supervised"):
        batch["labels"] = torch.as_tensor(rng.integers(0, PARTS, (B, T)))
    if kind == "distill":
        batch["gt_object_class"] = torch.as_tensor([3, NUM_OBJ - 1])
    return batch


def _setup(kind: str, mesh=None, local=()):
    """A fresh model at seed 0 and its Trainer on ``mesh`` (one process
    without one), the head sharded over the mesh's model group."""
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch import part_distillation, proposal, supervised
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    seg, cfg = _model_cfg(kind)
    model = MaskFormerSegmenter(seg, device="cpu", seed=0)
    meta = {"distill": part_distillation, "supervised": supervised}.get(kind, proposal)
    loss = meta.make_loss_fn(cfg, model, device="cpu",
                             group=mesh.data_group if mesh is not None else None)
    loss.local = local
    sharded = part_distillation.shard_part_head(model, mesh) if mesh is not None else {}
    freeze = () if kind in ("unfrozen", "supervised") else ("backbone", "pixel_decoder")
    return Trainer(loss, model, OptimizerConfig(freeze_keys=freeze), device="cpu", mesh=mesh,
                   sharded=sharded)


def _global_noise(kind: str, batch: dict) -> dict:
    """The single-process step's noise at B = 2 and its matching (fixed, so
    that both steps match alike)."""
    import torch

    trainer = _setup(kind)
    noise = trainer.loss_fn.draw_noise(batch, torch.Generator().manual_seed(0))
    t = trainer.loss_fn.device_batch(batch)
    with torch.no_grad():
        noise["indices"] = trainer.loss_fn.match(trainer.loss_fn.forward(t, noise), t, noise)
    return noise


def _share(batch: dict, noise: dict, d: int, n: int) -> tuple:
    """Data rank ``d``'s rows of the global batch and noise."""
    per = B // n
    rows = slice(d * per, (d + 1) * per)
    local_batch = {k: v[rows] for k, v in batch.items()}
    local_noise = {k: v[..., rows] if k == "drop_keep" else v[:, rows] for k, v in noise.items()}
    return local_batch, local_noise


def _step(trainer, batch: dict, noise: dict) -> dict:
    """One train step; returns its metrics, the gradients the update starts
    from (after the data-parallel sync, before the clip) and the trainable
    parameters after it."""
    grads, opt = {}, trainer.optimizer
    real = opt.step

    def step():
        for n, p in zip(opt.names, opt.params):
            grads[n] = p.grad.detach().clone() if p.grad is not None else None
        return real()

    opt.step = step
    metrics = trainer.train_step(batch, noise)
    params = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    return {"metrics": metrics, "grads": grads, "params": params}


def case_ddp_step(rank: int, world: int, tmp: Path, kind: str) -> dict:
    """The data-parallel step (B = 1 a rank) against the single-process
    step at B = 2, and the same with each normaliser left per rank."""
    from partdistillation_torch.parallel.mesh import make_mesh

    _join_file_store(rank, world, tmp)
    batch = _batch(kind)
    noise = _global_noise(kind, batch)
    ref = _step(_setup(kind), batch, noise)
    mesh = make_mesh(world, 1)
    local_batch, local_noise = _share(batch, noise, mesh.data_index, mesh.n_data)
    out = {"ref": ref}
    for name, local in (("ddp", ()), ("local_num_masks", ("num_masks",)),
                        ("local_class_weight", ("class_weight",))):
        out[name] = _step(_setup(kind, mesh, local), local_batch, local_noise)
    return out


def case_head_shards(rank: int, world: int, tmp: Path) -> dict:
    """Stage 5 at (data 1, model ``world``): the sharded step against the
    unsharded one, then each layout's checkpoint resumed in the other."""
    import torch

    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.part_distillation import PART_HEAD_WEIGHT
    from partdistillation_torch.parallel.mesh import make_mesh

    _join_file_store(rank, world, tmp)
    batch = _batch("distill")
    noise = _global_noise("distill", batch)
    mesh = make_mesh(1, world)
    whole, sharded = _setup("distill"), _setup("distill", mesh)
    out = {"ref": _step(whole, batch, noise), "sharded": _step(sharded, batch, noise),
           "model_index": mesh.model_index}

    def moments(trainer: Trainer) -> dict:
        i = trainer.optimizer.names.index(PART_HEAD_WEIGHT)
        state = trainer.optimizer.adam.state_dict()["state"][i]
        return {k: state[k].clone() for k in ("exp_avg", "exp_avg_sq")}

    whole.checkpoint_dir, sharded.checkpoint_dir = tmp / "whole", tmp / "sharded"
    whole.save()
    sharded.save()
    resumed = {}
    for name, source, m in (("sharded_into_whole", "sharded", None),
                            ("whole_into_sharded", "whole", mesh)):
        trainer = _setup("distill", m)
        trainer.checkpoint_dir = tmp / source
        assert trainer.resume_or_load()
        resumed[name] = {"head": dict(trainer.model.named_parameters())[PART_HEAD_WEIGHT]
                         .detach().clone(), "moments": moments(trainer),
                         "params": {n: p.detach().clone() for n, p in
                                    zip(trainer.optimizer.names, trainer.optimizer.params)},
                         "step": trainer.step}
    out.update(resumed=resumed, moments={"whole": moments(whole), "sharded": moments(sharded)},
               files=sorted(p.name for p in (tmp / "sharded").glob("*.pt")),
               saved_head_shape=tuple(torch.load(next((tmp / "sharded").glob("*.pt")),
                                                 weights_only=True)["model"]
                                      [PART_HEAD_WEIGHT].shape))
    return out


# ---------------------------------------------------------------- CLIs


def case_cli(rank: int, world: int, tmp: Path, argvs_json: str) -> list:
    """The CLI commands of a json file, one after another, in one process
    group (``initialize`` from torchrun's variables; ``run.main`` finds the
    group made and leaves it). Returns each command's JSON lines."""
    import contextlib
    import io
    import json

    from partdistillation_torch import run
    from partdistillation_torch.engine import launch

    assert launch.initialize("cpu", timeout=GROUP_TIMEOUT)
    results = []
    for argv in json.loads(Path(argvs_json).read_text()):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run.main(argv)
        results.append([json.loads(line) for line in out.getvalue().splitlines()
                        if line.startswith("{")])
    launch.teardown()
    return results


CASES = {"collectives": case_collectives, "dies": case_dies, "ddp_step": case_ddp_step,
         "head_shards": case_head_shards, "cli": case_cli}


def main(argv) -> None:
    import torch

    case, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    result = CASES[case](rank, world, tmp, *argv[4:])
    torch.save(result, tmp / f"rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1:])
