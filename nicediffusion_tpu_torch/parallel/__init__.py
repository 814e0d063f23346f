"""Data parallelism over torch.distributed (counterpart of nicediffusion_tpu/parallel):
one process per GPU, the batch split into row shards, parameters broadcast
from rank 0, gradients averaged over the ranks."""

from .mesh import (  # noqa: F401
    all_reduce_mean_,
    barrier,
    broadcast_module_,
    gather_rows,
    rank,
    shard_rows,
    world,
)
from .multihost import backend_for, maybe_initialize_distributed, process_local_batch_size  # noqa: F401
