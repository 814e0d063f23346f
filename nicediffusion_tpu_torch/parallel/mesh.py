"""Data-parallel placement over a torch.distributed process group.

Counterpart of nicediffusion_tpu/parallel/mesh.py. torch has no mesh
object: one process drives one card, and the data axis is the process
group. What the JAX module's shardings do, these helpers do by hand:

  * ``P('data')`` -> :func:`shard_rows`: rank r of W holds rows
    ``[r*B/W, (r+1)*B/W)`` of a global batch of B;
  * the gather of a sharded result -> :func:`gather_rows`, onto rank 0,
    through CPU tensors (gloo) whatever the group's backend for CUDA;
  * ``replicated`` -> :func:`broadcast_module_` from rank 0;
  * the gradient all-reduce XLA emits -> :func:`all_reduce_mean_`, flat
    buckets, one ``all_reduce(SUM)`` each, then a divide by W.

Without a process group every helper acts as a group of one: rank 0 of 1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["rank", "world", "shard_rows", "gather_rows", "broadcast_module_",
           "all_reduce_mean_", "barrier"]

BUCKET_BYTES = 25 * 2**20  # DDP's default bucket size


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of the global batch ``x`` (a view), the layout
    of ``P('data')``. Raises ValueError when ``world`` does not divide the
    batch."""
    b = x.shape[0]
    if b % world:
        raise ValueError(f"global batch {b} must divide process count {world}")
    n = b // world
    return x[rank * n:(rank + 1) * n]


def gather_rows(local: torch.Tensor) -> torch.Tensor | None:
    """The global batch on rank 0 (rank order, as :func:`shard_rows` cut
    it), None on the other ranks. Every rank passes the same shape. The
    rows travel as CPU tensors, so the gather runs over gloo under either
    backend; the result is a CPU tensor."""
    local = local.detach().cpu().contiguous()
    if world() == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(world())] if rank() == 0 else None
    dist.gather(local, parts, dst=0)
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


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Replace each tensor by its mean over the ranks, in place: the tensors
    are packed into flat buckets of up to ``BUCKET_BYTES``, each bucket is
    summed by one ``all_reduce`` and divided by the world size, and the
    results are copied back. In a group of one the collective runs and
    changes nothing; without a group nothing runs. Returns ``tensors``."""
    if not dist.is_initialized():
        return tensors
    n = world()
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(n)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])
    return tensors
