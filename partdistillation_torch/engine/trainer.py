"""Training engine: one device, eager train step, checkpoints.

Counterpart of the JAX package's ``engine/trainer.py`` without the mesh: a
train step is forward + criterion (``loss_fn``), backward, and the clipped
AdamW update (``engine/optim.py``); its metrics are every loss,
``total_loss`` and ``grad_norm`` (the global gradient norm before clipping).
The step's randomness comes from the loss's ``draw_noise`` and a
``torch.Generator`` seeded with ``seed``. Checkpoints are ``torch.save``
files with resume-if-exists semantics (the newest of at most three is
resumed). ``batch_prepare`` is the wire-format hook: it turns the batch as
the host sends it (uint8 images, bit-packed masks) into the loss's batch on
the device before each step, as the JAX package's
``Trainer(batch_prepare=...)`` does inside its compiled step. Several
devices (DDP) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from .optim import AdamW, OptimizerConfig

__all__ = ["Trainer"]

logger = logging.getLogger("partdistillation_torch")
_KEEP = 3


class Trainer:
    """Owns the model's optimizer state, the step count and the checkpoints.
    ``loss_fn(batch, noise) -> (total, losses)`` with a ``draw_noise(batch,
    generator)`` method (``make_loss_fn``)."""

    def __init__(self, loss_fn, model: torch.nn.Module, optimizer_cfg: OptimizerConfig,
                 device=None, seed: int = 0, checkpoint_dir: Optional[str] = None,
                 batch_prepare: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.batch_prepare = batch_prepare
        self.loss_fn = loss_fn
        self.model = model.to(self.device).train()
        self.optimizer = AdamW(self.model.named_parameters(), optimizer_cfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.step = 0

    def apply_gradients(self) -> torch.Tensor:
        """The optimizer update from the parameters' gradients; returns the
        global gradient norm before clipping."""
        norm = self.optimizer.step()
        self.step += 1
        return norm

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
        total.backward()
        metrics = {**losses, "total_loss": total, "grad_norm": self.apply_gradients()}
        values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    # --- checkpoints (resume-if-exists) ---

    def _checkpoints(self):
        return sorted(self.checkpoint_dir.glob("model_*.pt")) if self.checkpoint_dir else []

    def save(self) -> Path:
        if self.checkpoint_dir is None:
            raise ValueError("Trainer.save: no checkpoint_dir")
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = self.checkpoint_dir / f"model_{self.step:08d}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({"step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "generator": self.generator.get_state()}, tmp)
        os.replace(tmp, path)
        for old in self._checkpoints()[:-_KEEP]:
            old.unlink()
        return path

    def resume_or_load(self) -> bool:
        """Restore the newest checkpoint if one exists; True if resumed."""
        found = self._checkpoints()
        if not found:
            return False
        state = torch.load(found[-1], map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())
        self.step = int(state["step"])
        logger.info("resumed from checkpoint step %d", self.step)
        return True
