"""Optimizer of the train steps: the JAX package's ``engine/optim.py`` optax
chain, with its ``OptimizerConfig`` fields.

  * parameters whose name contains a freeze key are frozen (never updated);
  * ``backbone`` parameters learn at ``backbone_multiplier`` x the rate;
  * no weight decay for tensors of ndim <= 1 and for relative-position
    tables, absolute position embeddings and query / level embeddings;
  * with ``clip_norm > 0`` the gradient is first clipped to that global norm,
    as optax's ``clip_by_global_norm`` does it (``g`` if ``|g| < c``, else
    ``g * c / |g|``; no epsilon added to the norm), over every gradient;
  * ``adamw`` (the default): ``torch.optim.AdamW`` (0.9 / 0.999 / 1e-8,
    decoupled weight decay: the same update as optax's decay-then-scale);
    ``sgd``: optax's ``add_decayed_weights`` then ``sgd`` with momentum,
    written out: ``t = momentum * t + (g + decay * w)``, ``w -= rate * t``
    (optax's trace, which starts from zero and is not dampened);
  * the rate is ``learning_rate(step, cfg)``, JAX's ``build_schedule``
    (multistep or poly decay with a linear warm-up), at the number of
    updates made before this one.
Parameters that get no gradient count as a zero gradient, as the JAX
package's ``stop_gradient`` zeros do. With parameters sharded over a model
group (``sharded``, the stage-5 head's hidden slices), the global norm counts
each shard once (their squared norms summed over ``model_group``) and the
replicated parameters once. The defaults are every train CLI's settings.
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Iterable, Tuple

import torch
import torch.distributed as dist

__all__ = ["OptimizerConfig", "param_label", "learning_rate", "Optimizer", "AdamW"]

_NO_DECAY_KEYS = ("relative_position_bias_table", "absolute_pos_embed", "query_feat",
                  "query_embed", "level_embed")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adamw"  # adamw | sgd
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    backbone_multiplier: float = 0.1
    momentum: float = 0.9
    clip_norm: float = 0.01
    freeze_keys: Tuple[str, ...] = ()
    # schedule (detectron2's WarmupMultiStepLR / WarmupPolyLR); the default
    # warm-up factor 1.0 makes the warm-up the identity
    schedule: str = "multistep"  # multistep | poly
    max_iter: int = 50000
    steps: Tuple[int, ...] = (40000, 45000)
    gamma: float = 0.1
    warmup_iters: int = 10
    warmup_factor: float = 1.0
    poly_power: float = 0.9


def param_label(name: str, param: torch.Tensor, cfg: OptimizerConfig) -> str:
    """frozen | backbone_decay | backbone_nodecay | head_decay | head_nodecay."""
    name = name.lower()
    if any(k in name for k in cfg.freeze_keys):
        return "frozen"
    group = "backbone" if "backbone" in name else "head"
    no_decay = param.dim() <= 1 or any(k in name for k in _NO_DECAY_KEYS)
    return f"{group}_{'nodecay' if no_decay else 'decay'}"


def learning_rate(step: int, cfg: OptimizerConfig = OptimizerConfig()) -> float:
    """The schedule's rate after ``step`` updates (JAX's ``build_schedule``)."""
    if cfg.schedule not in ("multistep", "poly"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    warm = 1.0
    if step < cfg.warmup_iters:
        warm = cfg.warmup_factor + (1 - cfg.warmup_factor) * step / max(cfg.warmup_iters, 1)
    if cfg.schedule == "poly":
        frac = min(max(step / max(cfg.max_iter, 1), 0.0), 1.0)
        return cfg.base_lr * (1.0 - frac) ** cfg.poly_power * warm
    return cfg.base_lr * cfg.gamma ** sum(step >= s for s in cfg.steps) * warm


def _squared_norm(tensors, device) -> torch.Tensor:
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(torch._foreach_norm(tensors)).float().square().sum()


class Optimizer:
    """The clipped AdamW or SGD update over the named parameters of a model,
    by parameter group. ``names[i]`` is the name of ``params[i]``, the
    parameter whose moments (or momentum) the state dict keeps under i."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig,
                 model_group=None, sharded: Collection[str] = ()):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        learning_rate(0, cfg)  # refuses an unknown schedule before any step
        named = dict(named_params)
        self.cfg = cfg
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
        self.groups = [{"params": [p for _, p in ps],
                        "weight_decay": cfg.weight_decay if label.endswith("_decay") else 0.0,
                        "lr_mult": cfg.backbone_multiplier if label.startswith("backbone")
                        else 1.0}
                       for label, ps in groups.items()]
        if cfg.optimizer == "adamw":
            self.adam = torch.optim.AdamW(self.groups, lr=cfg.base_lr, betas=(0.9, 0.999),
                                          eps=1e-8, fused=True)
        else:
            self.momentum = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping (a 0-dim f32 tensor)."""
        cfg = self.cfg
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
        if cfg.clip_norm > 0:
            torch._foreach_mul_([p.grad for p in self.params],
                                cfg.clip_norm / torch.clamp(norm, min=cfg.clip_norm))
        lr = learning_rate(self.count, cfg)
        if cfg.optimizer == "adamw":
            for group in self.adam.param_groups:
                group["lr"] = lr * group["lr_mult"]
            self.adam.step()
        else:
            self._sgd(lr)
        self.count += 1
        return norm

    def _sgd(self, lr: float) -> None:
        i = 0
        for group in self.groups:
            params = group["params"]
            trace = self.momentum[i:i + len(params)]
            i += len(params)
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_mul_(trace, self.cfg.momentum)
            torch._foreach_add_(trace, grads)
            torch._foreach_add_(params, trace, alpha=-lr * group["lr_mult"])

    def state_dict(self) -> Dict:
        if self.cfg.optimizer == "adamw":
            return {"count": self.count, "adam": self.adam.state_dict()}
        return {"count": self.count,
                "sgd": {"state": {i: {"momentum_buffer": t} for i, t in enumerate(self.momentum)}}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        if self.cfg.optimizer == "adamw":
            self.adam.load_state_dict(state["adam"])
            return
        for i, t in enumerate(self.momentum):
            t.copy_(state["sgd"]["state"][i]["momentum_buffer"])


# the name the train steps have used since the optimizer was AdamW only
AdamW = Optimizer
