"""Process-group launch and host-level collectives of multi-GPU runs.

Counterpart of the JAX package's ``engine/launch.py`` on ``torch.distributed``:
the ranks are started by ``torchrun`` (one process per GPU), which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.

* ``initialize(device)`` joins the process group when those variables are
  set and does nothing otherwise: NCCL for a ``cuda`` entry point (after
  ``torch.cuda.set_device(LOCAL_RANK)``), gloo for ``cpu``. A failed
  initialisation raises; nothing carries on as a single process.
* ``process_index`` / ``process_count`` / ``is_main_process`` / ``barrier``
  are the rank-0 gating and the sync points (1 process without a group).
* ``all_gather_objects`` gathers any picklable object from every rank of a
  group, ordered by rank: the evaluators' ragged record lists and the
  per-rank dictionaries go through it. Without a process group it raises.

Preemption safety is the pipeline's own, as in the JAX package: stores skip
written ids and trainers resume from their newest checkpoint.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "teardown", "process_index", "process_count", "is_main_process",
           "barrier", "all_gather_objects", "DEFAULT_TIMEOUT"]

logger = logging.getLogger("partdistillation_torch")

# how long a collective waits for its peers before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def initialize(device=None, timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group ``torchrun`` describes in the environment.
    Returns True when this call created the group (the caller then tears it
    down with :func:`teardown`), False when there is nothing to join or a
    group already exists. ``device`` is the entry point's device: ``cuda``
    (the default) takes NCCL, ``cpu`` gloo."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torchrun started a cuda run but torch.cuda.is_available() "
                               "is False")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL: a cuda run cannot join its "
                               "process group")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timeout or DEFAULT_TIMEOUT)
    logger.info("torch.distributed initialised: rank %d of %d (%s, local rank %d)",
                rank, world, backend, local_rank)
    return True


def teardown() -> None:
    """Destroy the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default)."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def all_gather_objects(obj, group=None) -> list:
    """Every rank's ``obj`` (picklable), ordered by rank within ``group``
    (the world by default). Raises without a process group: a caller that
    asked for a gather is not run as a single process."""
    if not dist.is_initialized():
        raise RuntimeError("all_gather_objects needs an initialised process group "
                           "(launch with torchrun)")
    if dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
