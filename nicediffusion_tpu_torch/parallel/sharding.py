"""Tensor-parallel parameter sharding rules for the UNet, in torch names.

The port's copy of nicediffusion_tpu/parallel/sharding.py's ``_spec_for``
(the Megatron pairing), in the layouts the port keeps (OIHW convs, Linear
``(O, I)``, Conv1d ``(O, I, 1)`` for ``qkv_nin`` and ``proj_out``). A
parameter is sharded on one dimension over the mesh's model axis of size
``tp``, or replicated (None):

  * ``in_conv`` (column-parallel): weight and bias on dim 0, the output
    channels;
  * ``out_norm``: weight and bias on dim 0. GroupNorm's 32 groups are the
    major factor of the channels, so when ``tp`` divides 32 a shard holds
    ``32 // tp`` whole groups and its statistics stay local;
  * ``out_conv`` (row-parallel): weight on dim 1, the input channels; bias
    replicated (added once, after the all-reduce);
  * ``qkv_nin`` (column-parallel): weight and bias on dim 0; the (B, N, 3C)
    activation is gathered before the attention kernel, since a contiguous
    shard of the fused 3C layout mixes q, k and v of several heads;
  * ``proj_out`` (row-parallel): weight on dim 1; bias replicated;
  * the other 2-D weights, the timestep MLP's Linear layers: dim 0 (the
    output features); their biases replicated, as in the JAX table;
  * everything else replicated: ``in_norm``, ``step_embedding``, ``skip``,
    the Up/Downsample convs, the stem, the head, GroupNorms outside the
    pairs, the class embedding.

The residual block's three (``in_conv``, ``out_norm``, ``out_conv``) are
sharded only when ``32 % tp == 0`` (pairing) and ``tp`` divides the
dimension; ``qkv_nin``, ``proj_out`` and the MLP only need the dimension to
divide. The model's blocks read the table (models/unet.py
``shard_module_``) and run paired or replicated accordingly.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

__all__ = ["GN_GROUPS", "shard_dim", "unet_param_shard_dims", "shard_params",
           "gather_params", "shard_tensor", "gather_tensor"]

# the UNet's GroupNorm group count (nn.GroupNorm(32, C) in the reference)
GN_GROUPS = 32


def shard_dim(name: str, shape, tp: int) -> int | None:
    """The dimension of the parameter ``name`` (torch state-dict name) of
    ``shape`` sharded over a model axis of ``tp``, or None (replicated)."""
    if tp == 1:
        return None
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    shape = tuple(shape)
    paired = GN_GROUPS % tp == 0

    def on(dim):
        return dim if shape[dim] % tp == 0 else None

    if parent == "in_conv":
        return on(0) if paired else None
    if parent == "out_norm":
        return on(0) if paired and len(shape) == 1 else None
    if parent == "out_conv":
        return on(1) if paired and leaf == "weight" else None
    if parent in ("step_embedding", "skip", "in_norm", "conv", "norm", "class_embedding"):
        return None
    if parent == "qkv_nin":
        return on(0)
    if parent == "proj_out":
        return on(1) if leaf == "weight" else None
    if leaf == "weight" and len(shape) == 2:
        return on(0)  # the timestep MLP's Linear: its output features
    return None


def _named_shapes(model_or_state_dict):
    if isinstance(model_or_state_dict, torch.nn.Module):
        return {n: p.shape for n, p in model_or_state_dict.named_parameters()}
    return {n: v.shape for n, v in model_or_state_dict.items()}


def unet_param_shard_dims(model_or_state_dict, tp: int) -> dict[str, int | None]:
    """``{name: dim or None}`` for every parameter of an unsharded
    DiffusionModel (or of its full state dict)."""
    return {n: shard_dim(n, s, tp) for n, s in _named_shapes(model_or_state_dict).items()}


def shard_tensor(t: torch.Tensor, dim: int | None, mesh) -> torch.Tensor:
    """The mesh rank's contiguous slice of the whole ``t`` on ``dim`` (a
    copy), or ``t`` itself where ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.num_model
    return t.narrow(dim, mesh.model_rank * n, n).contiguous()


def gather_tensor(t: torch.Tensor, dim: int | None, mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``t`` on ``dim``, on
    every rank of the model group (every one calls it); ``t`` itself where
    ``dim`` is None."""
    if dim is None or mesh.num_model == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.num_model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh,
                 dims: Mapping[str, int | None] | None = None) -> dict[str, torch.Tensor]:
    """The mesh rank's shards of a full state dict, by ``dims`` (default:
    the table over the state dict's own shapes)."""
    if dims is None:
        dims = unet_param_shard_dims(state_dict, mesh.num_model)
    return {n: shard_tensor(v, dims.get(n), mesh) for n, v in state_dict.items()}


def gather_params(local_state_dict: Mapping[str, torch.Tensor], mesh,
                  dims: Mapping[str, int | None]) -> dict[str, torch.Tensor]:
    """The full state dict from every model rank's shards, by ``dims`` (the
    table of the unsharded model: a sharded model keeps it as ``tp_dims``),
    on every rank of the model group. It loads with ``strict=True`` into an
    unsharded model."""
    return {n: gather_tensor(v, dims.get(n), mesh) for n, v in local_state_dict.items()}
