"""Metric logging: JSONL always, TensorBoard and wandb when available.

The port's own copy of the JAX package's ``engine/metrics.py``:

  * JSONL (``metrics.jsonl`` in the log dir), always on; each line is
    {"step": N, "wall": t, **scalars};
  * TensorBoard via torch.utils.tensorboard when importable;
  * wandb when importable AND WANDB_PROJECT (or explicit project=) is set.

Only rank 0 of torch.distributed (or the only process) writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["MetricLogger", "print_csv_format"]


class MetricLogger:
    def __init__(self, log_dir: str, project: Optional[str] = None,
                 run_name: Optional[str] = None, enabled: Optional[bool] = None):
        if enabled is None:
            import torch.distributed as dist

            enabled = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self.enabled = enabled
        self.log_dir = log_dir
        self._t0 = time.time()
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
        except Exception:  # noqa: BLE001 — tensorboard is optional
            self._tb = None
        project = project or os.environ.get("WANDB_PROJECT")
        if project:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name,
                                         dir=log_dir, resume="allow")
            except Exception:  # noqa: BLE001 — wandb is optional
                self._wandb = None

    def log(self, scalars: Dict[str, float], step: int):
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in scalars.items()}
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def print_csv_format(results: Dict[str, float], task: str = "eval") -> str:
    """The reference's copy-pasteable CSV metric block
    (d2 print_csv_format, part_ranking_train_net.py:131)."""
    keys = sorted(results)
    lines = [f"[{task}] metrics:",
             ",".join(keys),
             ",".join(f"{results[k]:.4f}" for k in keys)]
    out = "\n".join(lines)
    print(out)
    return out
