"""Data and tensor parallelism over torch.distributed (counterpart of
nicediffusion_tpu/parallel): one process per GPU, laid out as a (data,
model) mesh; the batch split into row shards over the data axis, the
Megatron-paired layers' weights over the model axis (sharding.py, tensor.py),
parameters broadcast from rank 0, gradients averaged over the data axis."""

from .mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean_,
    barrier,
    broadcast_module_,
    gather_rows,
    make_mesh,
    rank,
    shard_rows,
    world,
)
from .multihost import backend_for, maybe_initialize_distributed, process_local_batch_size  # noqa: F401
