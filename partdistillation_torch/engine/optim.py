"""Optimizer of the train steps: the JAX package's ``engine/optim.py`` optax
chain at the settings every train CLI uses, on ``torch.optim.AdamW``.

  * parameters whose name contains a freeze key are frozen (never updated);
  * ``backbone`` parameters learn at ``BACKBONE_MULTIPLIER`` x the rate;
  * no weight decay for tensors of ndim <= 1 and for relative-position
    tables, absolute position embeddings and query / level embeddings;
  * the gradient is clipped to a global norm of ``CLIP_NORM`` first, as
    optax's ``clip_by_global_norm`` does it (``g`` if ``|g| < c``, else
    ``g * c / |g|``; no epsilon added to the norm), over every gradient;
  * AdamW (0.9 / 0.999 / 1e-8, decoupled weight decay: the same update as
    optax's decay-then-scale), at the multistep schedule's rate evaluated at
    the number of updates made before this one.
Parameters that get no gradient count as a zero gradient, as the JAX
package's ``stop_gradient`` zeros do. With parameters sharded over a model
group (``sharded``, the stage-5 head's hidden slices), the global norm counts
each shard once (their squared norms summed over ``model_group``) and the
replicated parameters once. SGD, the poly schedule and the other
optimizer settings come with the CLIs that set them (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Iterable, Tuple

import torch
import torch.distributed as dist

__all__ = ["OptimizerConfig", "param_label", "learning_rate", "AdamW"]

BASE_LR, WEIGHT_DECAY, BACKBONE_MULTIPLIER, CLIP_NORM = 1e-4, 0.05, 0.1, 0.01
LR_STEPS, LR_GAMMA = (40000, 45000), 0.1  # detectron2 WarmupMultiStepLR; its warmup factor
                                          # 1.0 makes the warmup the identity
_NO_DECAY_KEYS = ("relative_position_bias_table", "absolute_pos_embed", "query_feat",
                  "query_embed", "level_embed")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    freeze_keys: Tuple[str, ...] = ()


def param_label(name: str, param: torch.Tensor, cfg: OptimizerConfig) -> str:
    """frozen | backbone_decay | backbone_nodecay | head_decay | head_nodecay."""
    name = name.lower()
    if any(k in name for k in cfg.freeze_keys):
        return "frozen"
    group = "backbone" if "backbone" in name else "head"
    no_decay = param.dim() <= 1 or any(k in name for k in _NO_DECAY_KEYS)
    return f"{group}_{'nodecay' if no_decay else 'decay'}"


def learning_rate(step: int) -> float:
    """The multistep schedule's rate after ``step`` updates."""
    return BASE_LR * LR_GAMMA ** sum(step >= s for s in LR_STEPS)


def _squared_norm(tensors, device) -> torch.Tensor:
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(torch._foreach_norm(tensors)).float().square().sum()


class AdamW:
    """Clipped AdamW over the named parameters of a model, by parameter group.
    ``names[i]`` is the name of ``params[i]``, the parameter whose moments
    the state dict keeps under index i."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig,
                 model_group=None, sharded: Collection[str] = ()):
        named = dict(named_params)
        self.labels = {n: param_label(n, p, cfg) for n, p in named.items()}
        self.all_params = list(named.values())
        self.model_group = model_group
        self.sharded = [named[n] for n in sharded]
        groups: Dict[str, list] = {}
        for n, p in named.items():
            if self.labels[n] != "frozen":
                groups.setdefault(self.labels[n], []).append((n, p))
        self.names = [n for ps in groups.values() for n, _ in ps]
        self.params = [p for ps in groups.values() for _, p in ps]
        self.count = 0
        self.adam = torch.optim.AdamW(
            [{"params": [p for _, p in ps],
              "weight_decay": WEIGHT_DECAY if label.endswith("_decay") else 0.0,
              "lr_mult": BACKBONE_MULTIPLIER if label.startswith("backbone") else 1.0}
             for label, ps in groups.items()],
            lr=BASE_LR, betas=(0.9, 0.999), eps=1e-8, fused=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping (a 0-dim f32 tensor)."""
        device = self.all_params[0].device
        if self.model_group is None:
            grads = [p.grad for p in self.all_params if p.grad is not None]
            norm = torch.zeros((), dtype=torch.float32, device=device)
            if grads:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
        else:
            shards = {id(p) for p in self.sharded}
            sq = _squared_norm([p.grad for p in self.sharded if p.grad is not None], device)
            dist.all_reduce(sq, group=self.model_group)
            norm = torch.sqrt(sq + _squared_norm(
                [p.grad for p in self.all_params if p.grad is not None and id(p) not in shards],
                device))
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_mul_([p.grad for p in self.params],
                            CLIP_NORM / torch.clamp(norm, min=CLIP_NORM))
        lr = learning_rate(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.adam.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.adam.load_state_dict(state["adam"])
