"""Checkpoint loading into the port's state dict.

Reads the two weight files a user has for this model family:

  * a torch ``.pt`` / ``.pth`` / ``.ckpt`` state dict, with raw OpenAI
    guided-diffusion names or the original reference's converted names
    (both map onto the port's names through the rename map);
  * the JAX package's flat ``.npz`` (nicediffusion_tpu.utils.checkpoint.
    save_params_npz: flax tree paths joined by ``::``), converted from the
    flax layout to the torch one.

The result loads into nicediffusion_tpu_torch.DiffusionModel, or for a
classifier checkpoint (``*_classifier.pt``, or the ``.npz`` of the JAX
EncoderUNet's tree) into nicediffusion_tpu_torch.EncoderUNet, with
``strict=True``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .convert import flax_params_to_torch_state_dict, rename_guided_diffusion_keys
from .device import resolve_device

__all__ = ["load_state_dict"]

_SEP = "::"


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_state_dict(
    path: str, device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """Load a ``.pt``-family or ``.npz`` checkpoint as a port state dict of
    tensors on ``device`` (``None`` means the CUDA card, utils/device.py)."""
    device = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as data:
            tree = _unflatten({k: data[k] for k in data.files})
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in flax_params_to_torch_state_dict(tree).items()
        }
    if path.endswith((".pt", ".pth", ".ckpt")):
        sd = torch.load(path, map_location=device, weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return {rename_guided_diffusion_keys(k): v for k, v in sd.items()}
    raise ValueError(f"unrecognised checkpoint format: {path}")

