"""The (data, model) process mesh of multi-GPU runs and its collectives.

Counterpart of the JAX package's ``parallel/mesh.py`` with one process per
GPU: the ``data`` axis is data parallelism (each data rank reads its own
shard of the items, and the train step's gradients are averaged over it, as
DDP does), the optional ``model`` axis splits the stage-5 part head
(``num_object_classes * num_parts + 1`` columns) along its hidden dimension,
as the JAX package's ``giant_head_rule`` shards its (hidden, cols) kernel
with ``P("model", None)``. Ranks are laid out data-major, as JAX's
``devices.reshape(n_data, n_model)``: rank = d * n_model + m.

The JAX CLI fits its mesh to one host's devices (``run._fit_mesh``: data
size = gcd(devices / n_model, batch)); here each process owns one GPU, so
``data.batch_size`` is one rank's batch and the global batch is
batch_size x n_data.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "copy_to_group", "reduce_from_group", "allreduce_mean_",
           "gather_shards", "take_shard"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (n_data, n_model) mesh. ``data_group`` holds
    the ranks that share this rank's model index (None when n_data is 1),
    ``model_group`` those that share its data index (None when n_model is
    1)."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_src(self) -> int:
        """Global rank of data index 0 in this rank's data group."""
        return self.model_index


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank without a
    group). ``n_data`` defaults to world / n_model; a world that is not
    n_data x n_model raises. Every rank must call it (it creates the
    groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_model < 1 or world % n_model:
        raise ValueError(f"a world of {world} process(es) is not divisible by "
                         f"n_model_shards={n_model}")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data} data x {n_model} model) does not cover a world "
                         f"of {world} process(es)")
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    if n_data > 1:  # every rank creates every group, in the same order
        for mi in range(n_model):
            g = dist.new_group([di * n_model + mi for di in range(n_data)])
            data_group = g if mi == m else data_group
    if n_model > 1:
        for di in range(n_data):
            g = dist.new_group([di * n_model + mi for mi in range(n_model)])
            model_group = g if di == d else model_group
    return Mesh(n_data, n_model, d, m, data_group, model_group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, replicated on every rank of ``group``, whose
    gradient is the sum of the ranks' gradients (each rank reads its own
    slice of it)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient reaches each rank's
    partial term unchanged."""
    return _ReduceFromGroup.apply(x, group)


_BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket


@torch.no_grad()
def allreduce_mean_(tensors: Iterable[torch.Tensor], group, size: int) -> None:
    """Average ``tensors`` in place over ``group`` (``size`` ranks): one
    all-reduce per bucket of about 25 MB of one dtype, DDP's gradient sync."""
    buckets, open_buckets = [], {}  # open_buckets: (dtype, device) -> [tensors, bytes]
    for t in tensors:
        nbytes, key = t.numel() * t.element_size(), (t.dtype, t.device)
        cur = open_buckets.get(key)
        if cur is None or (cur[0] and cur[1] + nbytes > _BUCKET_BYTES):
            cur = open_buckets[key] = [[], 0]
            buckets.append(cur[0])
        cur[0].append(t)
        cur[1] += nbytes
    for chunk in buckets:
        flat = torch.cat([t.reshape(-1) for t in chunk])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        offset = 0
        for t in chunk:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def gather_shards(shard: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's equal slice along ``dim``, in rank
    order within ``group``."""
    parts = [torch.empty_like(shard) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def take_shard(full: torch.Tensor, index: int, count: int, dim: int) -> torch.Tensor:
    """Slice ``index`` of ``count`` equal slices of ``full`` along ``dim``
    (a copy); a size that ``count`` does not divide raises."""
    if full.shape[dim] % count:
        raise ValueError(f"dimension {dim} of {tuple(full.shape)} does not split into "
                         f"{count} equal shards")
    return full.chunk(count, dim=dim)[index].clone()
