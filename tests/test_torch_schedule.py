"""The port's schedule tables are bit-equal to the JAX package's, and the
port imports nothing of JAX."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from nicediffusion_tpu.ops.schedule import DiffusionSchedule as JaxSchedule  # noqa: E402
from nicediffusion_tpu_torch.ops.schedule import DiffusionSchedule  # noqa: E402

_KEPT = [0, 3, 17, 40, 99, 250, 511, 800, 999]


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine", "constant"])
@pytest.mark.parametrize("respacing", ["even", "karras", "indices"])
def test_schedule_tables_bit_equal(beta_schedule, respacing):
    kw = dict(original_num_steps=1000, rescaled_num_steps=25,
              beta_schedule=beta_schedule)
    if respacing == "indices":
        kw["timestep_indices"] = _KEPT
    else:
        kw["respacing"] = respacing
    ours = DiffusionSchedule.create(**kw)
    ref = JaxSchedule.create(**kw)
    for field in dataclasses.fields(JaxSchedule):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            assert np.array_equal(a, b), field.name
        else:
            assert a == b, field.name


def test_presets_and_derivations_match_jax():
    """utils/config.py is a copy: same presets, same path dispatch, same
    derivation rules."""
    from nicediffusion_tpu.utils import config as jcfg
    from nicediffusion_tpu_torch.utils import config as tcfg

    assert tcfg.MODEL_PRESETS == jcfg.MODEL_PRESETS
    assert tcfg.DIFFUSION_PRESETS == jcfg.DIFFUSION_PRESETS
    for path in ("64x64_diffusion.pt", "128x128_diffusion.pt",
                 "256x256_diffusion.pt", "EMNIST_model_params.pt"):
        assert tcfg.preset_for_path(path) == jcfg.preset_for_path(path)
    for var_type in ("learned_interpolation", "small"):
        for guidance in ("classifier_free", None):
            margs = {"in_channels": 3, "num_classes": 10,
                     "attention_resolutions": "8/16", "channel_mult": "1/2/4"}
            dargs = {"sampling_var_type": var_type, "guidance_method": guidance}
            ours, ref = dict(margs), dict(margs)
            tcfg.apply_derivations(ours, dargs)
            jcfg.apply_derivations(ref, dargs)
            assert ours == ref


def test_rename_map_matches_jax():
    from nicediffusion_tpu.utils.convert import rename_guided_diffusion_keys as jrename
    from nicediffusion_tpu_torch.utils.convert import rename_guided_diffusion_keys

    for name in ("input_blocks.1.0.in_layers.0.weight", "output_blocks.5.1.qkv.weight",
                 "time_embed.2.bias", "label_emb.weight", "middle_block.1.qkv_nin.bias",
                 "output_blocks.2.0.skip_connection.weight", "out.2.weight",
                 "input_blocks.3.0.emb_layers.1.weight", "input_blocks.3.0.out_layers.3.bias"):
        assert rename_guided_diffusion_keys(name) == jrename(name)


_ROOT = pathlib.Path(__file__).resolve().parents[1]
_PORT_SOURCES = sorted(
    str(p.relative_to(_ROOT)) for p in (_ROOT / "nicediffusion_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("source", _PORT_SOURCES)
def test_port_source_imports_no_jax_and_nothing_of_the_jax_package(source):
    """The port and its smoke script import torch and numpy, never jax, flax,
    optax or the JAX package (not even a module of it that imports no JAX)."""
    tree = ast.parse((_ROOT / source).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                              "nicediffusion_tpu"), f"{source}: {name}"
