"""Multi-process readiness: one process per GPU, torchrun's model.

Counterpart of nicediffusion_tpu/parallel/multihost.py. A data-parallel run
starts one process per GPU (``python -m torch.distributed.run
--nproc_per_node N ...``, or any launcher that sets the same environment),
and each process calls :func:`maybe_initialize_distributed` before it first
touches a card.

Environment contract (set by torchrun on every process):
  WORLD_SIZE   total process count (its presence enables initialisation)
  RANK         this process's index
  LOCAL_RANK   its index on this host: the card it drives
  MASTER_ADDR, MASTER_PORT   the rendezvous of ``env://``

Data contract, as in the JAX package: ``batch_size`` everywhere is the
GLOBAL batch; each process feeds ``batch_size // world`` rows a step (its
loader yields its local share, seeded by its rank) and the gradients are
averaged over the processes (training/trainer.py).

Backends: with a card, ``"cpu:gloo,cuda:nccl"``, so the gradients (CUDA
tensors) go over NCCL and the host-side gathers and broadcasts (CPU
tensors) over gloo; on the CPU, gloo. NCCL refuses two ranks on one card,
so a run of several ranks sharing one card asks for ``backend="gloo"``,
which stages CUDA tensors through the host for ``all_reduce`` and
``broadcast``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "process_local_batch_size", "backend_for"]

# how long a collective waits for the other ranks before it raises: a rank
# that dies fails the others by this timeout at the latest
COLLECTIVE_TIMEOUT_S = 600.0


def maybe_initialize_distributed(backend: str | None = None, init_method: str = "env://") -> bool:
    """Join the process group that torchrun's environment describes.

    Without ``WORLD_SIZE`` it does nothing and returns False, as the JAX
    version does without ``JAX_COORDINATOR``; it also returns False when the
    group exists already (idempotent). Otherwise it sets the current CUDA
    device to ``cuda:LOCAL_RANK`` (where there is a card), initialises the
    default group with ``backend`` (see the module docstring for the
    default) and returns True. A failed rendezvous raises; nothing falls
    back to a single process; a collective waits COLLECTIVE_TIMEOUT_S at most.
    """
    if dist.is_initialized() or not os.environ.get("WORLD_SIZE"):
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return True


def process_local_batch_size(global_batch_size: int) -> int:
    """Per-process share of a global batch (the data contract above)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % n:
        raise AssertionError(f"global batch {global_batch_size} must divide process count {n}")
    return global_batch_size // n


def backend_for(device_type: str) -> str | None:
    """The backend the default group sends ``device_type`` tensors over
    ("nccl", "gloo"), or None without a group."""
    if not dist.is_initialized():
        return None
    config = dist.get_backend_config()
    if ":" not in config:  # one backend for every device
        return config
    return dict(part.split(":") for part in config.split(",")).get(device_type)
