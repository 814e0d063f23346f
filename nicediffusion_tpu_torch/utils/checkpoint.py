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

:func:`save_params_npz` writes a nested tree as that flat ``.npz`` (the JAX
package's keys), and :func:`load_npz_tree` reads one back as the tree; with
utils/convert.py's calibration converters they keep the ``--int8_calibration``
file, which either package can read: :func:`save_calibration`,
:func:`load_calibration`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .convert import (
    calibration_to_flax,
    flax_calibration_to_torch,
    flax_params_to_torch_state_dict,
    rename_guided_diffusion_keys,
)
from .device import resolve_device

__all__ = ["load_state_dict", "save_params_npz", "load_npz_tree", "save_calibration",
           "load_calibration"]

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


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            out[_SEP.join(prefix + (k,))] = np.asarray(v)
    return out


def save_params_npz(tree: Mapping, path: str) -> None:
    """Save a nested tree of arrays (or tensors) as a flat ``.npz``, keys
    joined by ``::``: nicediffusion_tpu.utils.checkpoint.save_params_npz's
    format, which its ``load_params`` reads."""
    np.savez(path, **_flatten(tree))


def load_npz_tree(path: str) -> dict:
    """A flat ``.npz`` of ``::``-joined keys as the nested tree of numpy
    arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def save_calibration(calib: Mapping[str, torch.Tensor], path: str) -> None:
    """An int8 calibration (``{layer name: absmax}``) as the JAX package's
    'calib' tree in an ``.npz``."""
    save_params_npz(calibration_to_flax(calib), path)


def load_calibration(path: str, device: torch.device | str | None = None
                     ) -> dict[str, torch.Tensor]:
    """An int8 calibration ``.npz`` written by either package ->
    ``{layer name: absmax}`` of f32 scalars on ``device`` (None: the card)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device)
            for k, v in flax_calibration_to_torch(load_npz_tree(path)).items()}


def load_state_dict(
    path: str, device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """Load a ``.pt``-family or ``.npz`` checkpoint as a port state dict of
    tensors on ``device`` (``None`` means the CUDA card, utils/device.py)."""
    device = resolve_device(device)
    if path.endswith(".npz"):
        tree = load_npz_tree(path)
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

