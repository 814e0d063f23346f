"""Tensor-parallel collectives over a mesh's model group, as autograd Functions.

What GSPMD inserts in the JAX package for the Megatron-paired shardings
(parallel/sharding.py), written out. A tensor is either *replicated* (the
same whole tensor on every rank of the model group) or *sharded* (rank m
holds its contiguous slice m of one dimension). Gradients follow the same
rule: the gradient of a replicated tensor is the whole gradient on every
rank, that of a shard is the rank's slice of it.

  * :func:`copy_to_model`: replicated -> the input of a column-parallel
    layer. Forward the identity; backward the all-reduce (SUM) of the
    gradient, since each rank's columns give only part of it.
  * :func:`reduce_from_model`: the partial sums of a row-parallel layer ->
    replicated. Forward the all-reduce (SUM); backward the identity.
  * :func:`gather_from_model`: sharded -> replicated, the shards
    concatenated in rank order. Backward the rank's own slice of the
    incoming gradient: everything after the gather is replicated, so every
    rank already holds the whole gradient (a reduce-scatter would multiply
    it by the group's size).
  * :func:`scatter_to_model`: replicated -> the rank's slice (a view).
    Backward the gather of the slices' gradients.

Every collective is ``all_reduce`` or the list form of ``all_gather``:
gloo has both for CUDA tensors (several ranks sharing one card run over
gloo, since NCCL refuses two ranks on one device), and no CUDA
``reduce_scatter``. A mesh whose model axis has one rank runs none.

``stats`` counts the collectives by (kind, pass) and the bytes of the
tensors they return; with ``stats.timed`` set it also synchronizes the card
around each one and adds up their seconds (for readings only: the syncs
cost time).
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

__all__ = ["copy_to_model", "reduce_from_model", "gather_from_model", "scatter_to_model",
           "stats"]


class CollectiveStats:
    """Collectives by (``"all_reduce"`` or ``"all_gather"``, ``"forward"``
    or ``"backward"``): ``counts``, ``bytes`` of their results and, while
    ``timed``, ``seconds``."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.counts = collections.Counter()
        self.bytes = collections.Counter()
        self.seconds = collections.Counter()

    def run(self, kind, phase, fn, out: torch.Tensor):
        """Run the collective ``fn``, which fills ``out``, and count it."""
        sync = self.timed and out.is_cuda
        if sync:
            torch.cuda.synchronize(out.device)
            t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize(out.device)
            self.seconds[kind, phase] += time.perf_counter() - t0
        self.counts[kind, phase] += 1
        self.bytes[kind, phase] += out.numel() * out.element_size()


stats = CollectiveStats()


def _all_reduce(x, mesh, phase):
    out = x.contiguous().clone()
    stats.run("all_reduce", phase,
              lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.model_group), out)
    return out


def _all_gather(x, dim, mesh, phase):
    x = x.contiguous()
    out = torch.empty((mesh.num_model, *x.shape), dtype=x.dtype, device=x.device)
    stats.run("all_gather", phase,
              lambda: dist.all_gather(list(out), x, group=mesh.model_group), out)
    return torch.cat(list(out), dim=dim)


def _slice(x, dim, mesh):
    n = x.shape[dim] // mesh.num_model
    return x.narrow(dim, mesh.model_rank * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh, "forward")

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _slice(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh, "backward"), None, None


def _active(mesh) -> bool:
    return mesh is not None and mesh.num_model > 1


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (replicated) as the input of a column-parallel layer."""
    return _CopyToModel.apply(x, mesh) if _active(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model group of the ranks' partial ``x``: replicated."""
    return _ReduceFromModel.apply(x, mesh) if _active(mesh) else x


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The model group's shards ``x`` concatenated in rank order along
    ``dim``: replicated."""
    return _GatherFromModel.apply(x, dim % x.ndim, mesh) if _active(mesh) else x


def scatter_to_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The rank's slice of the replicated ``x`` along ``dim`` (a view)."""
    return _ScatterToModel.apply(x, dim % x.ndim, mesh) if _active(mesh) else x
