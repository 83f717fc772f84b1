"""Training engine: eager train step on one GPU a rank, checkpoints.

Counterpart of the JAX package's ``engine/trainer.py``: a train step is
forward + criterion (``loss_fn``), backward, and the clipped AdamW (or SGD)
update (``engine/optim.py``); its metrics are every loss, ``total_loss`` and
``grad_norm`` (the global gradient norm before clipping). The step's
randomness comes from the loss's ``draw_noise`` and a ``torch.Generator``
seeded by (``seed``, the rank's data index). Checkpoints are ``torch.save``
files with resume-if-exists semantics (the newest of at most three is
resumed). ``batch_prepare`` is the wire-format hook: it turns the batch as
the host sends it (uint8 images, bit-packed masks) into the loss's batch on
the device before each step, as the JAX package's
``Trainer(batch_prepare=...)`` does inside its compiled step.

The backward and the update run inside ``torch.profiler.record_function``
scopes named ``backward`` and ``optimizer``. The JAX package's profile
attributes each backward op to the forward scope it differentiates, through
the compiled program's metadata; autograd runs the backward on its own
thread with no link to the forward's scopes, so here the backward is one
scope of its own (``utils/profiling.summarize_trace`` matches a scope to the
kernels launched while it is open on any thread of the process).

On a ``mesh`` (``parallel/mesh.py``) with several data ranks the step is
data parallel, as DDP: the parameters start from data rank 0's, the
trainable gradients are averaged over the data group in buckets before the
clip and the update (``grad_sync_s`` times that), and the logged losses are
the group's means. Parameters named in ``sharded`` (the stage-5 head, split
over the model group) are gathered whole into the checkpoint, with their
AdamW moments, and sliced again on resume, so a run resumes at any
``n_model_shards``. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import resolve_device
from ..parallel.mesh import Mesh, allreduce_mean_, gather_shards, take_shard
from .launch import all_gather_objects, barrier, is_main_process
from .optim import Optimizer, OptimizerConfig

__all__ = ["Trainer"]

logger = logging.getLogger("partdistillation_torch")
_KEEP = 3
_MOMENTS = ("exp_avg", "exp_avg_sq", "momentum_buffer")  # the optimizer state a shard splits


class Trainer:
    """Owns the model's optimizer state, the step count and the checkpoints.
    ``loss_fn(batch, noise) -> (total, losses)`` with a ``draw_noise(batch,
    generator)`` method (``make_loss_fn``)."""

    def __init__(self, loss_fn, model: torch.nn.Module, optimizer_cfg: OptimizerConfig,
                 device=None, seed: int = 0, checkpoint_dir: Optional[str] = None,
                 batch_prepare: Optional[Callable] = None, mesh: Optional[Mesh] = None,
                 sharded: Optional[Dict[str, int]] = None):
        self.device = resolve_device(device)
        self.mesh = mesh or Mesh()
        self.sharded = dict(sharded or {})  # parameter name -> the dimension it is split on
        self.batch_prepare = batch_prepare
        self.loss_fn = loss_fn
        self.model = model.to(self.device).train()
        self.optimizer = Optimizer(self.model.named_parameters(), optimizer_cfg,
                                   self.mesh.model_group, self.sharded)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + (self.mesh.data_index << 32))
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.step = 0
        if self.mesh.n_data > 1:
            with torch.no_grad():
                for t in [*self.model.parameters(), *self.model.buffers()]:
                    dist.broadcast(t, src=self.mesh.data_src, group=self.mesh.data_group)

    def apply_gradients(self) -> torch.Tensor:
        """The optimizer update from the parameters' gradients; returns the
        global gradient norm before clipping."""
        norm = self.optimizer.step()
        self.step += 1
        return norm

    def sync_gradients(self) -> None:
        """Average the trainable parameters' gradients over the data group
        (a parameter without one counts as zero, as in the update)."""
        for p in self.optimizer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        allreduce_mean_([p.grad for p in self.optimizer.params], self.mesh.data_group,
                        self.mesh.n_data)

    def train_step(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, float]:
        """One step on ``batch`` (through ``batch_prepare`` when set);
        ``noise`` defaults to a fresh draw."""
        if self.batch_prepare is not None:
            batch = self.batch_prepare(batch)
        if noise is None:
            noise = self.loss_fn.draw_noise(batch, self.generator)
        self.model.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(batch, noise)
        with record_function("backward"):
            total.backward()
        losses = {**losses, "total_loss": total}
        values = torch.stack([v.detach().float() for v in losses.values()])
        timing = None
        if self.mesh.n_data > 1:
            timing = self._timed(self.sync_gradients)
            dist.all_reduce(values, group=self.mesh.data_group)
            values = values / self.mesh.n_data
        with record_function("optimizer"):
            norm = self.apply_gradients()
        metrics = dict(zip([*losses, "grad_norm"],
                           torch.cat([values, norm.float()[None]]).tolist()))
        if timing is not None:
            metrics["grad_sync_s"] = timing()
        return metrics

    def _timed(self, fn) -> Callable[[], float]:
        """Run ``fn``; returns a function that gives its seconds on the
        device (CUDA events, read once the step has synchronised) or on the
        host clock on the CPU."""
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            return lambda: start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
        return lambda: seconds

    # --- checkpoints (resume-if-exists) ---

    def _checkpoints(self):
        return sorted(self.checkpoint_dir.glob("model_*.pt")) if self.checkpoint_dir else []

    def _map_sharded(self, model_state: Dict, opt_state: Dict, fn):
        """The two state dicts with every sharded parameter and its AdamW
        moments (or SGD momentum) replaced by ``fn(tensor, dim)`` (the live
        state untouched)."""
        model_state = dict(model_state)
        kind = "adam" if "adam" in opt_state else "sgd"
        inner = dict(opt_state[kind])
        inner["state"] = dict(inner["state"])
        for name, dim in self.sharded.items():
            model_state[name] = fn(model_state[name], dim)
            i = self.optimizer.names.index(name)
            if i in inner["state"]:
                inner["state"][i] = {k: fn(v, dim) if k in _MOMENTS else v
                                     for k, v in inner["state"][i].items()}
        return model_state, {**opt_state, kind: inner}

    def save(self) -> Path:
        """Write the checkpoint of this step (rank 0; every rank takes part
        in the gathers and waits until it is written)."""
        if self.checkpoint_dir is None:
            raise ValueError("Trainer.save: no checkpoint_dir")
        model_state, opt_state = self.model.state_dict(), self.optimizer.state_dict()
        if self.mesh.n_model > 1:
            model_state, opt_state = self._map_sharded(
                model_state, opt_state,
                lambda t, dim: gather_shards(t, self.mesh.model_group, dim))
        generators = [self.generator.get_state()]
        if self.mesh.n_data > 1:
            generators = all_gather_objects(generators[0], self.mesh.data_group)
        path = self.checkpoint_dir / f"model_{self.step:08d}.pt"
        if is_main_process():
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            state = {"step": self.step, "model": model_state, "optimizer": opt_state,
                     "generator": generators[0]}
            if len(generators) > 1:
                state["generators"] = generators
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self._checkpoints()[:-_KEEP]:
                old.unlink()
        barrier()
        return path

    def resume_or_load(self) -> bool:
        """Restore the newest checkpoint if one exists; True if resumed. A
        checkpoint written at another data size restores every rank's
        weights and moments, and the ranks keep their fresh generators. A
        checkpoint whose tensors have other shapes than the model's (another
        head width) raises ValueError, naming them."""
        found = self._checkpoints()
        if not found:
            return False
        state = torch.load(found[-1], map_location=self.device, weights_only=True)
        model_state, opt_state = state["model"], state["optimizer"]
        if self.mesh.n_model > 1:
            model_state, opt_state = self._map_sharded(
                model_state, opt_state,
                lambda t, dim: take_shard(t, self.mesh.model_index, self.mesh.n_model, dim))
        own = self.model.state_dict()
        other = [k for k, v in model_state.items()
                 if k in own and tuple(v.shape) != tuple(own[k].shape)]
        if other:
            raise ValueError(f"{found[-1]} holds {len(other)} tensors of other shapes than this "
                             f"model's (e.g. {other[0]}: {tuple(model_state[other[0]].shape)} "
                             f"there, {tuple(own[other[0]].shape)} here); refusing to resume")
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(opt_state)
        generators = state.get("generators", [state["generator"]])
        if len(generators) == self.mesh.n_data:
            self.generator.set_state(generators[self.mesh.data_index].cpu())
        else:
            logger.warning("checkpoint written at %d data rank(s), resumed at %d: the noise "
                           "generators start afresh", len(generators), self.mesh.n_data)
        self.step = int(state["step"])
        logger.info("resumed from checkpoint step %d", self.step)
        return True
