"""The port's UNet against the JAX package's, on the CPU, in f32.

A JAX DiffusionModel is initialised, every parameter is replaced by seeded
numpy values (none left at zero, so the zero-initialised output convs and
projections take part), the tree goes through the port's converter and
loads strict, and the NHWC forwards must agree to the repo's 1e-3 bar.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.utils.checkpoint import load_state_dict  # noqa: E402
from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    convert_torch_state_dict,
    flax_params_to_torch_state_dict,
)

# The suite runs several pytest workers side by side, and every worker
# imports this module. torch's default of one intra-op thread per core would
# oversubscribe the host many times over; the tiny models here need no more.
torch.set_num_threads(2)

# ragged attention N (28x28 input, attention at 7x7 -> N = 49), AdaGN,
# resblock up/down, [q|k|v] layout, CFG's extra null-class row
CFG_ADA = dict(
    resolution=28, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(7,), channel_mult=(1, 1, 2),
    num_heads=2, split_qkv_first=True, resblock_updown=True,
    use_adaptive_gn=True, num_classes=5 + 1,
)
# additive embedding, conv resampling, interleaved qkv layout, attention at
# two levels, heads from num_head_channels, unconditional
CFG_PLAIN = dict(
    resolution=16, in_channels=3, model_channels=32, out_channels=3,
    num_res_blocks=1, attention_resolutions=(8, 16), channel_mult=(1, 2),
    num_head_channels=32, split_qkv_first=False, resblock_updown=False,
    use_adaptive_gn=False, num_classes=None,
)
# average-pool downsampling, conv-less upsampling
CFG_NO_CONV = dict(CFG_PLAIN, conv_resample=False, attention_resolutions=(8,))
# heads as wide as openai_128's: 2 heads over 256, 384 and 512 channels give
# head dims 128, 192 and 256, with attention at all three levels
CFG_WIDE_HEADS = dict(
    resolution=8, in_channels=3, model_channels=128, out_channels=6,
    num_res_blocks=1, attention_resolutions=(8, 4, 2), channel_mult=(2, 3, 4),
    num_heads=2, split_qkv_first=True, resblock_updown=True,
    use_adaptive_gn=True, num_classes=7,
)
# openai_128's widths at one head, cut to an 8x8 model: 1 head over 256, 384
# and 512 channels gives head dims 256, 384 and 512 (the chunked build above
# 256 on the card)
CFG_HEAD_DIMS_ABOVE_256 = dict(CFG_WIDE_HEADS, num_heads=1)
# --model_channels 96 --num_heads 4: head dims 24, 48 and 96, between K1's
# builds (each runs on the next one up on the card)
CFG_HEAD_DIMS_BETWEEN_BUILDS = dict(
    resolution=8, in_channels=3, model_channels=96, out_channels=6,
    num_res_blocks=1, attention_resolutions=(8, 4, 2), channel_mult=(1, 2, 4),
    num_heads=4, split_qkv_first=True, resblock_updown=True,
    use_adaptive_gn=True, num_classes=7,
)


def random_jax_params(cfg, seed=0):
    """A JAX model's parameter tree with every leaf replaced by seeded,
    non-zero, fan-in-scaled numpy values."""
    model = JaxModel(**cfg)
    res, cin = cfg["resolution"], cfg["in_channels"]
    y = jnp.zeros((1,), jnp.int32) if cfg["num_classes"] else None
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, cin)),
                           jnp.zeros((1,), jnp.int32), y)
    )["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        shape = leaf.shape
        if path[-1] == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif path[-1] == "scale":
            v = 1.0 + 0.2 * rng.normal(size=shape)
        elif path[-1] == "embedding":
            v = rng.normal(size=shape)
        else:
            v = 0.2 * rng.normal(size=shape)
        flat[path] = v.astype(np.float32)
    return model, traverse_util.unflatten_dict(flat)


def port_model(cfg, params, **kw):
    model = DiffusionModel(**cfg, device="cpu", **kw)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_params_to_torch_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def inputs(cfg, batch=3, seed=1):
    rng = np.random.default_rng(seed)
    res, cin = cfg["resolution"], cfg["in_channels"]
    x = rng.normal(size=(batch, res, res, cin)).astype(np.float32)
    t = rng.integers(0, 1000, size=(batch,)).astype(np.int32)
    y = (rng.integers(0, cfg["num_classes"], size=(batch,)).astype(np.int32)
         if cfg["num_classes"] else None)
    return x, t, y


def forward_both(cfg, jmodel, params, model, seed=1):
    x, t, y = inputs(cfg, seed=seed)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, t, y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    None if y is None else torch.from_numpy(y).long())
    return out, ref


@pytest.mark.parametrize("cfg", [CFG_ADA, CFG_PLAIN, CFG_NO_CONV, CFG_WIDE_HEADS,
                                 CFG_HEAD_DIMS_BETWEEN_BUILDS, CFG_HEAD_DIMS_ABOVE_256],
                         ids=["ada_updown_ragged", "additive_interleaved", "no_conv_resample",
                              "head_dims_128_192_256", "head_dims_24_48_96",
                              "head_dims_256_384_512"])
@pytest.mark.parametrize("kernels", [True, False])
def test_forward_matches_jax(cfg, kernels):
    jmodel, params = random_jax_params(cfg)
    model = port_model(cfg, params, kernels=kernels)
    out, ref = forward_both(cfg, jmodel, params, model)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(ref).max() > 1e-2  # the zero-init layers were filled
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    assert np.abs(out.numpy() - ref).max() < 1e-4


def test_bf16_forward_tracks_jax():
    """bf16 compute with f32 parameters, as flax ``dtype=bfloat16``; the
    two frameworks round at different places, so the bar is loose."""
    jmodel, params = random_jax_params(CFG_ADA)
    jmodel = JaxModel(**CFG_ADA, dtype=jnp.bfloat16)
    model = port_model(CFG_ADA, params, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out, ref = forward_both(CFG_ADA, jmodel, params, model)
    assert out.dtype == torch.float32
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() < 0.05 * scale


def test_state_dict_round_trips_to_flax():
    """The port's names map back onto the flax tree exactly."""
    _, params = random_jax_params(CFG_PLAIN)
    model = port_model(CFG_PLAIN, params)
    back = convert_torch_state_dict(model.state_dict())
    flat_a = traverse_util.flatten_dict(back)
    flat_b = traverse_util.flatten_dict(params)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_b:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


@pytest.mark.parametrize("preset,count", [
    ("EMNIST", 17_989_442), ("openai_64", 295_904_454),
    ("openai_128", 421_529_606), ("openai_256", 553_838_086),
])
def test_preset_parameter_counts(preset, count):
    """BASELINE.md's counts, built on the meta device (nothing allocated);
    the same model with CFG's null class has one embedding row more."""
    cfg = dict(MODEL_PRESETS[preset])
    model = DiffusionModel(**cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count
    cfg["num_classes"] += 1
    model = DiffusionModel(**cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count + 4 * cfg["model_channels"]


def test_checkpoints_load(tmp_path):
    """The JAX package's .npz and a raw-OpenAI-named .pt both load strict
    into the port and give the JAX forward."""
    jmodel, params = random_jax_params(CFG_ADA, seed=3)
    npz = str(tmp_path / "params.npz")
    save_params_npz(params, npz)
    model = DiffusionModel(**CFG_ADA, device="cpu").eval()
    model.load_state_dict(load_state_dict(npz, device="cpu"), strict=True)
    out, ref = forward_both(CFG_ADA, jmodel, params, model)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)

    raw_names = (
        ("downsampling", "input_blocks"), ("upsampling", "output_blocks"),
        ("in_norm", "in_layers.0"), ("in_conv", "in_layers.2"),
        ("step_embedding", "emb_layers.1"), ("out_norm", "out_layers.0"),
        ("out_conv", "out_layers.3"), ("skip", "skip_connection"),
        ("step_embed", "time_embed"), ("class_embedding", "label_emb"),
        ("qkv_nin", "qkv"),
    )
    raw = {}
    for k, v in model.state_dict().items():
        for ours, theirs in raw_names:
            k = k.replace(ours, theirs)
        raw[k] = v.clone()
    assert "input_blocks.1.0.in_layers.0.weight" in raw
    pt = str(tmp_path / "64x64_raw.pt")
    torch.save(raw, pt)
    again = DiffusionModel(**CFG_ADA, device="cpu")
    again.load_state_dict(load_state_dict(pt, device="cpu"), strict=True)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("option", ["use_remat", "quantized", "quantized_attention", "winograd"])
def test_unported_model_options_raise(option):
    if option == "use_remat":  # ported with the training path: it builds now
        assert DiffusionModel(**CFG_PLAIN, use_remat=True, device="meta").use_remat
        return
    if option in ("quantized", "quantized_attention"):  # static int8: builds now
        from nicediffusion_tpu_torch.models.unet import Int8Conv, Int8Dense

        model = DiffusionModel(**CFG_PLAIN, **{option: True}, device="meta")
        kinds = {type(m) for m in model.int8_layers().values()}
        # as in JAX, quantized_attention acts only together with quantized
        assert kinds == ({Int8Conv} if option == "quantized" else set())
        both = DiffusionModel(**CFG_PLAIN, quantized=True, quantized_attention=True,
                              device="meta")
        assert {type(m) for m in both.int8_layers().values()} == {Int8Conv, Int8Dense}
        assert list(both.state_dict()) == list(DiffusionModel(**CFG_PLAIN, device="meta")
                                              .state_dict())
        return
    # winograd: ported; WinogradConv at JAX's sites (the stem, in_conv,
    # out_conv, the Upsample conv), Conv2d for the head, the 1x1 skips and the
    # stride-2 Downsample conv; the state dict unchanged
    from nicediffusion_tpu_torch.models.unet import Conv2d, WinogradConv

    model = DiffusionModel(**CFG_PLAIN, **{option: True}, device="meta")
    kinds = {n: type(m) for n, m in model.named_modules() if isinstance(m, Conv2d)}
    assert kinds["downsampling.0.0"] is WinogradConv and kinds["out.2"] is Conv2d
    for name, kind in kinds.items():
        k, stride = model.get_submodule(name).weight.shape[-1], model.get_submodule(name).stride
        assert (kind is WinogradConv) == (k == 3 and stride == 1 and name != "out.2"), name
    assert any(n.endswith("in_conv") for n in kinds) and any(
        n.startswith("upsampling") and n.endswith(".conv") and kinds[n] is WinogradConv
        for n in kinds)
    assert list(model.state_dict()) == list(DiffusionModel(**CFG_PLAIN, device="meta")
                                            .state_dict())


def test_device_none_means_the_card():
    """No device given: the card, and an error naming the argument where
    there is none; never a silent CPU model."""
    if torch.cuda.is_available():
        model = DiffusionModel(**CFG_PLAIN)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device"):
            DiffusionModel(**CFG_PLAIN)
        with pytest.raises(RuntimeError, match="device"):
            load_state_dict("weights.npz")
    assert next(DiffusionModel(**CFG_PLAIN, device="cpu").parameters()).device.type == "cpu"
