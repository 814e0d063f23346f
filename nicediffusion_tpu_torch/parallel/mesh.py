"""The ('data', 'model') mesh and data-parallel placement over a
torch.distributed process group.

Counterpart of nicediffusion_tpu/parallel/mesh.py. One process drives one
card. :func:`make_mesh` lays the processes out as JAX's
``devices.reshape(num_data, num_model)`` does, the model coordinate fastest
(``rank = d * num_model + m``), and gives each process its data group (the
ranks of its model coordinate) and its model group (the ranks of its data
coordinate): a :class:`Mesh`. What the JAX module's shardings do, these
helpers do by hand:

  * ``P('data')`` -> :func:`shard_rows`: rank r of W holds rows
    ``[r*B/W, (r+1)*B/W)`` of a global batch of B;
  * the gather of a sharded result -> :func:`gather_rows`, onto rank 0,
    through CPU tensors (gloo) whatever the group's backend for CUDA;
  * ``replicated`` -> :func:`broadcast_module_` from rank 0;
  * the gradient all-reduce XLA emits -> :func:`all_reduce_mean_`, flat
    buckets, one ``all_reduce(SUM)`` each, then a divide by W.

Without a process group every helper acts as a group of one: rank 0 of 1,
and :func:`make_mesh` gives a mesh of one. ``all_reduce_mean_`` and
``gather_rows`` take an optional ``group`` (the data group, under tensor
parallelism); the model group's collectives are in parallel/tensor.py.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "rank", "world", "shard_rows", "gather_rows",
           "broadcast_module_", "all_reduce_mean_", "barrier"]

BUCKET_BYTES = 25 * 2**20  # DDP's default bucket size


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if world() > 1:
        dist.barrier()


class Mesh:
    """This process's place in a (num_data, num_model) mesh: its
    coordinates ``data_rank`` and ``model_rank``, and the process groups of
    its two axes, ``data_group`` and ``model_group``: the default group for
    an axis that spans every process, None for an axis of one process among
    several or without a process group (no collective runs over it).
    Copying a model that holds the mesh keeps the one mesh."""

    def __init__(self, num_data: int, num_model: int, data_rank: int = 0, model_rank: int = 0,
                 data_group=None, model_group=None):
        self.num_data, self.num_model = num_data, num_model
        self.data_rank, self.model_rank = data_rank, model_rank
        self.data_group, self.model_group = data_group, model_group

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return (f"Mesh(data {self.data_rank} of {self.num_data}, model {self.model_rank} of "
                f"{self.num_model})")


def _axis_group(ranks: list[int], n: int):
    """The process group of ``ranks``: the default group for all ``n``, None
    for one rank, else a new group (every rank makes every group, in the
    same order)."""
    if len(ranks) == n:
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


def make_mesh(num_data: int | None = None, num_model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over the process group, model coordinate
    fastest (``rank = d * num_model + m``). ``num_data`` defaults to the
    world size over ``num_model``; ``num_data * num_model`` must be the
    world size. Every rank calls it, in the same order as its other calls
    that make groups."""
    n = world()
    if num_model < 1 or n % num_model:
        raise ValueError(f"num_model {num_model} must divide the process count {n}")
    if num_data is None:
        num_data = n // num_model
    if num_data * num_model != n:
        raise ValueError(f"a mesh of {num_data} x {num_model} needs {num_data * num_model} "
                         f"processes, the group has {n}")
    d, m = divmod(rank(), num_model)
    mesh = Mesh(num_data, num_model, d, m)
    if not dist.is_initialized():
        return mesh
    for dd in range(num_data):
        group = _axis_group([dd * num_model + mm for mm in range(num_model)], n)
        if dd == d:
            mesh.model_group = group
    for mm in range(num_model):
        group = _axis_group([dd * num_model + mm for dd in range(num_data)], n)
        if mm == m:
            mesh.data_group = group
    return mesh


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of the global batch ``x`` (a view), the layout
    of ``P('data')``. Raises ValueError when ``world`` does not divide the
    batch."""
    b = x.shape[0]
    if b % world:
        raise ValueError(f"global batch {b} must divide process count {world}")
    n = b // world
    return x[rank * n:(rank + 1) * n]


def gather_rows(local: torch.Tensor, group=None) -> torch.Tensor | None:
    """The global batch on the group's first rank (rank order, as
    :func:`shard_rows` cut it), None on the other ranks. Every rank of
    ``group`` (default: all) passes the same shape. The rows travel as CPU
    tensors, so the gather runs over gloo under either backend; the result
    is a CPU tensor."""
    local = local.detach().cpu().contiguous()
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return local
    n, first = dist.get_world_size(group), dist.get_global_rank(group or dist.group.WORLD, 0)
    parts = [torch.empty_like(local) for _ in range(n)] if rank() == first else None
    dist.gather(local, parts, dst=first, group=group)
    return torch.cat(parts) if parts is not None else None


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Overwrite every parameter and buffer of ``module`` with rank
    ``src``'s, in place (the counterpart of placing parameters replicated).
    Returns ``module``."""
    if world() > 1:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=src)
    return module


def _buckets(tensors: Sequence[torch.Tensor], limit: int):
    """Consecutive runs of ``tensors`` of one dtype and device, each of at
    most ``limit`` bytes (a larger tensor is a bucket of its own)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + t.numel() * t.element_size() > limit):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * t.element_size()
    if bucket:
        yield bucket


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> Sequence[torch.Tensor]:
    """Replace each tensor by its mean over the ranks of ``group`` (default:
    all), in place: the tensors are packed into flat buckets of up to
    ``BUCKET_BYTES``, each bucket is summed by one ``all_reduce`` and
    divided by the group's size, and the results are copied back. In a
    group of one the collective runs and changes nothing; without a process
    group nothing runs. Returns ``tensors``."""
    if not dist.is_initialized():
        return tensors
    n = dist.get_world_size(group)
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])
    return tensors
