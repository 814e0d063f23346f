"""Parameter-name and layout conversion between the three weight families.

Numpy-only copy of the conversion half of nicediffusion_tpu/utils/convert.py.
The port's module tree keeps the original torch reference's parameter names
(``downsampling.{i}.{j}.in_norm.weight``, ``qkv_nin`` as a Conv1d
``(O, I, 1)`` weight, ...), so:

  * a raw OpenAI guided-diffusion state dict loads after
    :func:`rename_guided_diffusion_keys` (reference utils.py:265-292);
  * the JAX package's flax parameter tree loads after
    :func:`flax_params_to_torch_state_dict` (HWIO -> OIHW, Dense (I, O) ->
    Linear (O, I) or Conv1d (O, I, 1), GN ``scale`` -> ``weight``);
  * :func:`convert_torch_state_dict` goes the other way, torch names ->
    flax tree, so the port's weights can drive the JAX model;
  * :func:`train_state_to_torch` carries a whole JAX ``TrainState`` across:
    parameters, EMA parameters and optax AdamW's ``mu``, ``nu`` and ``count``
    become the port's model and EMA state dicts and the ``state`` half of
    ``torch.optim.AdamW.state_dict()`` (``exp_avg``, ``exp_avg_sq``,
    ``step``);
  * :func:`gn_silu_conv3x3_args_to_torch` turns the arrays of a call to the
    JAX package's fused GN+SiLU+conv kernel into the port's arguments;
  * static int8 state: :func:`calibration_to_flax` and
    :func:`flax_calibration_to_torch` carry a calibration (one absmax per
    int8 layer: the port's ``{layer name: absmax}``, the JAX package's
    'calib' tree) both ways, and :func:`flax_quant_to_torch` turns the JAX
    package's frozen 'quant' tree (``kernel_q`` HWIO or (I, O) int8,
    ``inv_act``, ``deq``) into the port's buffers, ``kernel_q`` in the int8
    conv kernel's (F, k, k, C) layout;
  * the super-resolution UNet's flax tree goes through
    :func:`flax_params_to_torch_state_dict` as the UNet's does (only its
    ``in_channels`` differ), and :func:`flax_rrdb_to_torch_state_dict` turns
    the JAX ``RRDBNet`` tree (``body_{i}``, HWIO kernels) into basicsr's
    names and layout, which models/rrdb.py loads.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import numpy as np

__all__ = [
    "rename_guided_diffusion_keys",
    "convert_torch_state_dict",
    "flax_params_to_torch_state_dict",
    "train_state_to_torch",
    "gn_silu_conv3x3_args_to_torch",
    "calibration_to_flax",
    "flax_calibration_to_torch",
    "flax_quant_to_torch",
    "flax_rrdb_to_torch_state_dict",
]

# rename bare `qkv` -> `qkv_nin` but leave `qkv_nin` (idempotence) and the
# attention pool's `qkv_proj` (classifier checkpoints) untouched
_QKV_RE = re.compile(r"qkv(?!_nin|_proj)")

# Containers whose integer-indexed torch children become flax ``layers_{j}``
# children of the *same-named* flax module (nn.Sequential analogues).
_SEQ_CONTAINERS = {"step_embed", "out", "middle_block"}
# Containers whose integer-indexed torch children become separate flax
# modules named ``{container}_{i}`` (nn.ModuleList analogues), each of which
# is a StepSequential with ``layers_{j}`` children.
_LIST_CONTAINERS = {"downsampling", "upsampling"}


def rename_guided_diffusion_keys(name: str) -> str:
    """Rename a raw OpenAI guided-diffusion parameter name to the reference's
    naming (reference utils.py:265-292). A no-op for already-converted names.
    """
    for old, new in (
        ("input_blocks", "downsampling"),
        ("output_blocks", "upsampling"),
        ("in_layers.0", "in_norm"),
        ("in_layers.2", "in_conv"),
        ("emb_layers.1", "step_embedding"),
        ("out_layers.0", "out_norm"),
        ("out_layers.3", "out_conv"),
        ("skip_connection", "skip"),
        ("time_embed", "step_embed"),
        ("label_emb", "class_embedding"),
    ):
        name = name.replace(old, new)
    # qkv -> qkv_nin, made idempotent (already-converted reference
    # checkpoints use qkv_nin; a naive replace would yield qkv_nin_nin).
    return _QKV_RE.sub("qkv_nin", name)


def _flax_path(torch_name: str) -> tuple[list[str], str]:
    """Translate a torch parameter path to (flax module path, leaf name).

    e.g. 'downsampling.3.0.in_norm.weight'
         -> (['downsampling_3', 'layers_0', 'in_norm'], 'weight')
    """
    parts = torch_name.split(".")
    leaf = parts[-1]
    parts = parts[:-1]
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in _LIST_CONTAINERS:
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
            if i < len(parts) and parts[i].isdigit():
                out.append(f"layers_{parts[i]}")
                i += 1
        elif p in _SEQ_CONTAINERS:
            out.append(p)
            i += 1
            if i < len(parts) and parts[i].isdigit():
                out.append(f"layers_{parts[i]}")
                i += 1
        else:
            out.append(p)
            i += 1
    return out, leaf


def _torch_path(mods: Sequence[str]) -> list[str]:
    """Flax module path -> torch module path, the inverse of :func:`_flax_path`:
    ``['downsampling_3', 'layers_0', 'in_norm']`` -> ``['downsampling', '3',
    '0', 'in_norm']``."""
    out: list[str] = []
    for m in mods:
        stem, _, idx = m.rpartition("_")
        if stem in _LIST_CONTAINERS and idx.isdigit():
            out += [stem, idx]
        elif stem == "layers" and idx.isdigit():
            out.append(idx)
        else:
            out.append(m)
    return out


def _convert_leaf(path: list[str], leaf: str, value: np.ndarray):
    """Transpose/rename one torch tensor into its flax (name, array) form."""
    module = path[-1] if path else ""
    if leaf == "bias":
        return "bias", value
    if leaf == "positional_embedding":
        # AttentionPool2d stores (C, N+1); flax uses token-major (N+1, C)
        return "positional_embedding", value.T
    assert leaf == "weight", f"unexpected leaf {leaf} at {'.'.join(path)}"
    if module == "class_embedding":
        return "embedding", value
    if value.ndim == 4:  # Conv2d OIHW -> HWIO
        return "kernel", value.transpose(2, 3, 1, 0)
    if value.ndim == 3:  # Conv1d (O, I, 1) -> Dense (I, O)
        return "kernel", value[:, :, 0].T
    if value.ndim == 2:  # Linear (O, I) -> Dense (I, O)
        return "kernel", value.T
    if value.ndim == 1:  # GroupNorm weight -> scale
        return "scale", value
    raise ValueError(f"cannot convert {'.'.join(path)}.{leaf} shape {value.shape}")


def convert_torch_state_dict(sd: Mapping[str, Any]) -> dict:
    """Convert a torch-named state dict (name -> tensor/ndarray) to a flax
    params tree matching nicediffusion_tpu.models.DiffusionModel (or, from an
    EncoderUNet state dict, nicediffusion_tpu.models.classifier.EncoderUNet)."""
    params: dict = {}
    for name, tensor in sd.items():
        value = np.asarray(
            tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor
        )
        name = rename_guided_diffusion_keys(name)
        path, leaf = _flax_path(name)
        leaf, value = _convert_leaf(path, leaf, value)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return params


def flax_params_to_torch_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """Flax params tree -> torch-named state dict of numpy arrays, loadable
    into nicediffusion_tpu_torch.DiffusionModel (or EncoderUNet, from the JAX
    classifier's tree) with ``strict=True``. The attention pool's
    ``positional_embedding`` goes back to torch's (C, N+1) and its
    ``qkv_proj`` / ``c_proj`` to Conv1d (O, I, 1) weights."""
    out: dict[str, np.ndarray] = {}

    def emit(path: list[str], node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                emit(path + [k], v)
            return
        value = np.asarray(node)
        *mods, leaf = path
        torch_mods = _torch_path(mods)
        if leaf in ("scale", "embedding"):
            name = "weight"
        elif leaf == "positional_embedding":
            name, value = leaf, value.T  # back to (C, N+1)
        elif leaf == "kernel":
            name = "weight"
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif mods and mods[-1] in ("qkv_nin", "proj_out", "qkv_proj", "c_proj"):
                value = value.T[:, :, None]  # Dense -> Conv1d (O, I, 1)
            else:
                value = value.T
        else:
            name = leaf
        out[".".join(torch_mods + [name])] = value

    emit([], params)
    return out


def train_state_to_torch(
    params: Mapping, ema_params: Mapping, mu: Mapping, nu: Mapping, count: int,
    param_names: Sequence[str],
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], dict[int, dict[str, np.ndarray]]]:
    """Numpy trees of a JAX ``TrainState`` -> (model state dict, EMA state
    dict, AdamW per-parameter state).

    ``mu`` and ``nu`` are the first and second moments of optax's
    ``ScaleByAdamState`` (params-shaped trees) and ``count`` its update
    count. ``param_names`` is the port model's ``named_parameters()`` order,
    which is the order ``torch.optim.AdamW`` numbers its state by. The three
    results are what ``Trainer.load_train_state`` takes. Moments share their
    parameter's layout, so they go through the same transposes.
    """
    exp_avg = flax_params_to_torch_state_dict(mu)
    exp_avg_sq = flax_params_to_torch_state_dict(nu)
    adamw_state = {}
    if count > 0:  # torch keeps no state for a parameter before its first update
        adamw_state = {
            i: {
                "step": np.asarray(count, np.float32),
                "exp_avg": np.ascontiguousarray(exp_avg[name]),
                "exp_avg_sq": np.ascontiguousarray(exp_avg_sq[name]),
            }
            for i, name in enumerate(param_names)
        }

    def state_dict(tree):
        return {k: np.ascontiguousarray(v)
                for k, v in flax_params_to_torch_state_dict(tree).items()}

    return state_dict(params), state_dict(ema_params), adamw_state


def gn_silu_conv3x3_args_to_torch(
    x, gamma, beta, kernel, bias, es=None, eb=None,
) -> tuple[np.ndarray, ...]:
    """Arrays of a call to nicediffusion_tpu's ``gn_silu_conv3x3`` (x NHWC,
    GN affine (C,), HWIO kernel (3, 3, C, F), bias (F,), AdaGN rows (B, C) or
    None) -> the positional arguments of the port's
    ``ops.kernels.resblock.gn_silu_conv3x3`` as numpy arrays. Only the
    kernel changes layout, to torch's OIHW (F, C, 3, 3); absent rows are
    left out."""
    out = [np.asarray(x), np.asarray(gamma), np.asarray(beta),
           np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)), np.asarray(bias)]
    if es is not None:
        out += [np.asarray(es), np.asarray(eb)]
    return tuple(out)


def calibration_to_flax(calib: Mapping[str, Any]) -> dict:
    """The port's ``{layer name: absmax}`` -> the JAX package's merged 'calib'
    tree (``{..., 'in_conv': {'absmax': f32 scalar}}``), which its
    ``save_params_npz`` / ``load_params`` and ``freeze_int8`` take."""
    tree: dict = {}
    for name, value in calib.items():
        path, _ = _flax_path(name + ".absmax")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        value = value.detach().cpu().numpy() if hasattr(value, "detach") else value
        node["absmax"] = np.asarray(value, np.float32).reshape(())
    return tree


def _leaves(tree: Mapping, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def flax_calibration_to_torch(tree: Mapping) -> dict[str, np.ndarray]:
    """A JAX 'calib' tree (merged scalars, or the tuples flax's ``sow``
    leaves) -> the port's ``{layer name: absmax}`` of f32 scalars."""
    out = {}
    for (*mods, leaf), value in _leaves(tree):
        if leaf != "absmax":
            raise ValueError(f"unexpected calibration leaf {'/'.join([*mods, leaf])}")
        if isinstance(value, tuple):
            value = value[0]
        out[".".join(_torch_path(mods))] = np.asarray(value, np.float32).reshape(())
    return out


def flax_quant_to_torch(tree: Mapping) -> dict[str, dict[str, np.ndarray]]:
    """The JAX package's frozen 'quant' tree -> ``{layer name: {"kernel_q",
    "inv_act", "deq"}}`` for ``DiffusionModel.load_int8_state``: a conv's
    HWIO ``kernel_q`` becomes (F, kh, kw, C), a dense layer's (I, O) becomes
    (O, 1, 1, I); the scales are unchanged."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for (*mods, leaf), value in _leaves(tree):
        value = np.array(value)  # a writable copy of a (read-only) device array
        if leaf == "kernel_q":
            value = value.transpose(3, 0, 1, 2) if value.ndim == 4 else value.T[:, None, None, :]
            value = np.ascontiguousarray(value)
        elif leaf not in ("inv_act", "deq"):
            raise ValueError(f"unexpected quant leaf {'/'.join([*mods, leaf])}")
        out.setdefault(".".join(_torch_path(mods)), {})[leaf] = value
    return out


def flax_rrdb_to_torch_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's ``RRDBNet`` params tree -> basicsr-named state dict
    of numpy arrays (``body_{i}.rdb{j}.conv{k}`` -> ``body.{i}.rdb{j}.conv{k}``,
    HWIO kernels -> OIHW weights), the inverse of the JAX package's
    ``convert_esrgan_state_dict``; loads into models/rrdb.py's RRDBNet with
    ``strict=True``."""
    out: dict[str, np.ndarray] = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        if mods[0].startswith("body_"):
            mods = ["body", mods[0][len("body_"):]] + list(mods[1:])
        if leaf == "kernel":
            leaf, value = "weight", np.asarray(value).transpose(3, 2, 0, 1)
        out[".".join(mods + [leaf])] = np.asarray(value)
    return out
