"""Static int8 serving in the port against the JAX package, on the CPU.

The same numpy-seeded inputs and weights go through nicediffusion_tpu's
ops/quant.py and Int8Conv/Int8Dense and through the port's: the quantizers
bit for bit, the freeze to the ulp, the int8 layers (static and dynamic, k 1
and 3, stride 1 and 2) to 1e-6 of the largest output, the calibration's
absmax to 1e-5, a whole quantized UNet with the JAX package's frozen state
carried across, a DDIM chain, the ``.npz`` calibration file both ways, and the
sampling entry point with ``--dtype int8 --int8_calibration``. On CPU tensors
the int8 conv runs its plain version (exact float64 sums); the kernel itself
is held to that version on the card (tests/test_torch_kernels.py).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.models.unet import Int8Conv as JaxInt8Conv  # noqa: E402
from nicediffusion_tpu.models.unet import Int8Dense as JaxInt8Dense  # noqa: E402
from nicediffusion_tpu.ops import quant as jq  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import load_params, save_params_npz  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.models.unet import Int8Conv, Int8Dense  # noqa: E402
from nicediffusion_tpu_torch.ops import quant as tq  # noqa: E402
from nicediffusion_tpu_torch.utils.checkpoint import load_calibration, save_calibration  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    calibration_to_flax,
    flax_calibration_to_torch,
    flax_quant_to_torch,
)

from test_torch_unet import port_model, random_jax_params  # noqa: E402

# tests/test_quant.py's small UNet: AdaGN, resblock up/down, attention at 8x8
CFG = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
    num_heads=2, num_classes=5, use_adaptive_gn=True, resblock_updown=True,
)
# conv resampling: the stride-2 Downsample conv and the Upsample conv are int8 too
CFG_CONV_RESAMPLE = dict(CFG, resblock_updown=False, use_adaptive_gn=False)
DIFF = dict(
    original_num_steps=20, rescaled_num_steps=6, sampling_var_type="learned_interpolation",
    loss_type="hybrid", beta_schedule="cosine", guidance_method="classifier_free",
    guidance_strength=0.8,
)


def ulp_diff(a, b):
    """The largest distance in f32 ulps between two f32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def t_(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


# ---------------------------------------------------------------- quantizers

@pytest.mark.parametrize("shape", [(3, 3, 24, 40), (1, 1, 40, 24), (48, 96)],
                         ids=["conv3", "conv1", "dense"])
def test_weight_quantizer_matches_jax(shape):
    """Per-output-channel weights: int8 bit-equal, scales to 0 ulp; the port
    quantizes its own layout (OIHW, (O, I)) along axis 0."""
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 0.3
    w[..., 3] = 0.0  # an all-zero channel: the 1e-12 clamp
    ref_q, ref_s = jq.quantize_weight_channelwise(jnp.asarray(w))
    torch_w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    w_q, s = tq.quantize_weight_channelwise(t_(torch_w), axis=0)
    back = w_q.numpy().transpose(2, 3, 1, 0) if w.ndim == 4 else w_q.numpy().T
    np.testing.assert_array_equal(back, np.asarray(ref_q))
    assert ulp_diff(s.numpy(), ref_s) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_quantizer_matches_jax(dtype):
    x = np.random.default_rng(2).normal(size=(2, 7, 5, 24)).astype(np.float32) * 3
    xj = jnp.asarray(x, dtype)
    ref_q, ref_s = jq.quantize_activation(xj)
    x_q, s = tq.quantize_activation(t_(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(ref_q))
    assert ulp_diff(s.numpy(), ref_s) == 0


@pytest.mark.parametrize("absmax", [3.7, 1e-8, (2.5,)], ids=["plain", "clamped", "sow_tuple"])
def test_static_quant_triple_matches_jax(absmax):
    """The freeze: kernel_q bit-equal, inv_act and deq within 1 ulp."""
    w = np.random.default_rng(3).normal(size=(3, 3, 16, 40)).astype(np.float32)
    ref = jq.static_quant_triple(jnp.asarray(w), absmax)
    w_q, inv_act, deq = tq.static_quant_triple(t_(w.transpose(3, 2, 0, 1)), absmax, axis=0)
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0), np.asarray(ref[0]))
    assert ulp_diff(inv_act.numpy(), ref[1]) <= 1
    assert ulp_diff(deq.numpy(), ref[2]) <= 1


def test_plain_int8_conv_sums_are_exact():
    """The plain version's s32 sums against integer arithmetic, at sums far
    past f32's 2^24: the float64 conv holds every partial sum exactly."""
    rng = np.random.default_rng(4)
    x_q = rng.integers(-127, 128, size=(2, 5, 6, 300)).astype(np.int8)
    x_q[0] = 127  # 127 * 127 * 9 * 300 at its interior pixels
    k_q = rng.integers(-127, 128, size=(7, 3, 3, 300)).astype(np.int8)
    k_q[0] = 127
    _, sums = tq.int8_conv_plain(t_(x_q), t_(k_q), None, torch.ones(7), None, 1,
                                 torch.float32, raw=True)
    xp = np.pad(x_q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros((2, 5, 6, 7), np.int64)
    for dy in range(3):
        for dx in range(3):
            ref += np.einsum("bhwc,fc->bhwf", xp[:, dy:dy + 5, dx:dx + 6], k_q[:, dy, dx].astype(np.int64))
    assert sums.dtype == torch.int32 and np.abs(ref).max() > 2 ** 24
    np.testing.assert_array_equal(sums.numpy(), ref)


def test_kernel_layout():
    """A conv's (F, C, k, k) and a dense layer's (O, I) or (O, I, 1) -> the
    kernel's (F, k, k, C)."""
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.int8).reshape(2, 3, 3, 3)
    assert torch.equal(tq.kernel_layout(w), w.permute(0, 2, 3, 1))
    d = torch.arange(6, dtype=torch.int8).reshape(2, 3)
    assert tq.kernel_layout(d).shape == (2, 1, 1, 3)
    assert torch.equal(tq.kernel_layout(d[:, :, None]), tq.kernel_layout(d))


# ---------------------------------------------------------------- layers

LAYERS = [("conv", 3, 1), ("conv", 3, 2), ("conv", 1, 1), ("conv", 1, 2), ("dense", 1, 1)]


def _layer_pair(kind, k, stride, c=24, f=40, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "conv":
        kernel = rng.normal(size=(k, k, c, f)).astype(np.float32) / np.sqrt(k * k * c)
        jm = JaxInt8Conv(features=f, kernel_size=k, stride=stride)
        tm = Int8Conv(c, f, k, stride, device="cpu")
        tm.weight.data = t_(kernel.transpose(3, 2, 0, 1))
        x = rng.normal(size=(2, 9, 7, c)).astype(np.float32)
    else:
        kernel = rng.normal(size=(c, f)).astype(np.float32) / np.sqrt(c)
        jm = JaxInt8Dense(features=f)
        tm = Int8Dense(c, f, conv1d_weight=True, device="cpu")
        tm.weight.data = t_(kernel.T[:, :, None])
        x = rng.normal(size=(2, 13, c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    tm.bias.data = t_(bias)
    return jm, {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, tm, x


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("kind,k,stride", LAYERS, ids=["k3s1", "k3s2", "k1s1", "k1s2", "dense"])
def test_int8_layer_matches_jax(kind, k, stride, mode):
    """Int8Conv/Int8Dense, frozen (static) or not (dynamic), within 1e-6 of
    the largest output of the JAX package's module on the same input."""
    jm, params, tm, x = _layer_pair(kind, k, stride)
    absmax = float(np.abs(x).max()) * 0.8  # some inputs clip at +-127
    if mode == "static":
        _, qv = jm.apply({"params": params, "calib": {"absmax": jnp.float32(absmax)}},
                         jnp.asarray(x), mutable=["quant"])
        ref = np.asarray(jm.apply({"params": params, "quant": qv["quant"]}, jnp.asarray(x)))
        tm.freeze(torch.tensor(absmax))
        np.testing.assert_array_equal(
            tm.kernel_q.numpy(),
            flax_quant_to_torch({"m": qv["quant"]})["m"]["kernel_q"])
    else:
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(t_(x)).numpy()
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    err = np.abs(out - ref).max()
    assert err <= 1e-6 * np.abs(ref).max(), err


def test_int8_layer_records_absmax_and_computes_in_float():
    """Recording: the float conv's output, and the running max |x|."""
    _, _, tm, x = _layer_pair("conv", 3, 1)
    with torch.no_grad():
        float_out = super(Int8Conv, tm).forward(t_(x))
        tm.recording = True
        out = tm(t_(x))
        tm(t_(x) * 0.5)
    assert torch.equal(out, float_out)
    assert float(tm.absmax) == float(np.abs(x).max())


# ---------------------------------------------------------------- the model

def _jax_model_and_port(cfg, quantized_attention=False, seed=0):
    """(JAX float model, JAX quantized model, params, port quantized model)
    with tests/test_quant.py's weights: every leaf 0.05 N(0, 1), seeded."""
    jfloat = JaxModel(**cfg)
    res, cin = cfg["resolution"], cfg["in_channels"]
    shapes = jax.eval_shape(
        lambda: jfloat.init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, cin)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    )["params"]
    rng = np.random.default_rng(seed)
    params = traverse_util.unflatten_dict(
        {path: (0.05 * rng.normal(size=leaf.shape)).astype(np.float32)
         for path, leaf in traverse_util.flatten_dict(shapes).items()})
    jq_model = JaxModel(**cfg, quantized=True, quantized_attention=quantized_attention)
    model = port_model(cfg, params, quantized=True, quantized_attention=quantized_attention)
    return jfloat, jq_model, params, model


def _check_jax_freeze(model, jmodel, params, jcalib):
    """Every frozen layer of ``model`` against the JAX package's: kernel_q
    bit-equal to freeze_int8's (jitted); inv_act and deq within 1 ulp of
    static_quant_triple run eagerly on the same layer. XLA's jit rewrites the
    freeze's divisions (JAX's own jitted and eager triples differ by up to 3
    ulps), so the ulp bar is held against the eager triple."""
    frozen = flax_quant_to_torch(jq.freeze_int8(jmodel, params, jcalib)["quant"])
    flat = traverse_util.flatten_dict(params)
    calib = flax_calibration_to_torch(jcalib)
    for name, m in model.int8_layers().items():
        np.testing.assert_array_equal(m.kernel_q.numpy(), frozen[name]["kernel_q"],
                                      err_msg=name)
        (*path, _), = traverse_util.flatten_dict(calibration_to_flax({name: 0.0}))
        _, inv_act, deq = jq.static_quant_triple(flat[(*path, "kernel")], calib[name])
        assert ulp_diff(m.inv_act.numpy(), inv_act) <= 1, name
        assert ulp_diff(m.deq.numpy(), deq) <= 1, name


def _jax_calibration_inputs(seed=7, batch=2, cfg=CFG):
    """(x, mapped t, y) triples from numpy: both packages see these."""
    rng = np.random.default_rng(seed)
    out = []
    for t in (999, 500, 60):
        x = rng.normal(size=(2 * batch, cfg["resolution"], cfg["resolution"],
                             cfg["in_channels"])).astype(np.float32)
        y = np.concatenate([rng.integers(1, cfg["num_classes"], size=batch), np.zeros(batch)])
        out.append((x, np.full((2 * batch,), t, np.int32), y.astype(np.int32)))
    return out


def _to_torch_inputs(inputs):
    return [(t_(x), t_(t).long(), t_(y).long()) for x, t, y in inputs]


@pytest.mark.parametrize("cfg", [CFG, CFG_CONV_RESAMPLE], ids=["updown", "conv_resample"])
@pytest.mark.parametrize("quantized_attention", [False, True], ids=["convs", "convs_and_attn"])
def test_collect_calibration_matches_jax(cfg, quantized_attention):
    """The same layers record the same absmax (rtol 1e-5); merging the
    calibrations of two runs gives the calibration over both inputs."""
    _, jmodel, params, model = _jax_model_and_port(cfg, quantized_attention)
    inputs = _jax_calibration_inputs(cfg=cfg)
    ref = flax_calibration_to_torch(jq.collect_calibration(jmodel, params, inputs))
    torch_inputs = _to_torch_inputs(inputs)
    calib = tq.collect_calibration(model, torch_inputs)
    assert sorted(calib) == sorted(ref) == sorted(model.int8_layers())
    for name in ref:
        np.testing.assert_allclose(calib[name].numpy(), ref[name], rtol=1e-5, atol=0,
                                   err_msg=name)
    merged = tq.merge_calibrations([tq.collect_calibration(model, torch_inputs[:1]),
                                    tq.collect_calibration(model, torch_inputs[1:])])
    assert all(torch.equal(merged[name], calib[name]) for name in calib)


@pytest.mark.parametrize("cfg,quantized_attention",
                         [(CFG, False), (CFG, True), (CFG_CONV_RESAMPLE, False),
                          (CFG_CONV_RESAMPLE, True)],
                         ids=["updown", "updown_attn", "conv_resample", "conv_resample_attn"])
def test_quantized_unet_forward_matches_jax(cfg, quantized_attention, capsys):
    """A whole quantized forward with the JAX package's frozen 'quant' state
    carried across.

    Every int8 layer is held on the activation it met inside JAX's forward
    (recorded by flax's method interception): its output within 1e-6 of the
    largest. End to end the outputs must correlate above 0.9999. The end-to-
    end max abs is printed, not gated: float noise of 1e-6 between the
    packages (GroupNorm, pooling, attention) can flip a .5 rounding of one
    int8 activation, a whole step, and everything downstream moves with it
    (measured 1.5e-6 of std(ref) with no flip, up to 0.044 with one)."""
    import flax.linen as nn

    _, jmodel, params, model = _jax_model_and_port(cfg, quantized_attention)
    variables = jq.build_int8_variables(jmodel, params, _jax_calibration_inputs(cfg=cfg))
    model.load_int8_state(flax_quant_to_torch(variables["quant"]))
    x, t, y = _jax_calibration_inputs(seed=11, cfg=cfg)[1]

    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, (JaxInt8Conv, JaxInt8Dense)) and context.method_name == "__call__":
            seen[".".join(_torch_names(context.module.path))] = (np.asarray(args[0]),
                                                                 np.asarray(out))
        return out

    with nn.intercept_methods(record):
        ref = np.asarray(jmodel.apply(variables, x, t, y))
    layers = model.int8_layers()
    assert sorted(seen) == sorted(layers)
    with torch.no_grad():
        for name, (inp, layer_ref) in seen.items():
            layer_out = layers[name](t_(inp)).numpy()
            assert np.abs(layer_out - layer_ref).max() <= 1e-6 * np.abs(layer_ref).max(), name
        out = model(t_(x), t_(t).long(), t_(y).long()).numpy()
    err = np.abs(out - ref).max() / ref.std()
    corr = np.corrcoef(out.ravel(), ref.ravel())[0, 1]
    with capsys.disabled():
        print(f"\n[int8 forward, resblock_updown={cfg['resblock_updown']}, quantized_attention="
              f"{quantized_attention}] {len(seen)} int8 layers within 1e-6; end to end max "
              f"|out - ref| / std(ref) {err:.3g}, corrcoef {corr:.8f}")
    assert np.isfinite(out).all() and ref.std() > 0.01 and corr > 0.9999


def _torch_names(flax_path):
    """A flax module path -> the port's module name parts."""
    from nicediffusion_tpu_torch.utils.convert import _torch_path

    return _torch_path(list(flax_path))


def test_freeze_from_port_calibration_matches_jax_freeze():
    """The port's freeze gives the JAX package's buffers for the same
    calibration (_check_jax_freeze)."""
    _, jmodel, params, model = _jax_model_and_port(CFG, quantized_attention=True)
    jcalib = jq.collect_calibration(jmodel, params, _jax_calibration_inputs())
    tq.freeze_int8(model, {k: t_(v) for k, v in flax_calibration_to_torch(jcalib).items()})
    _check_jax_freeze(model, jmodel, params, jcalib)


def test_quantized_model_loads_float_checkpoints_strict(tmp_path):
    """quantized=True keeps the float parameter names: float state dicts,
    the JAX package's .npz and a converted .pt load with strict=True, and the
    frozen buffers stay out of the state dict."""
    from nicediffusion_tpu_torch.utils.checkpoint import load_state_dict

    float_model = DiffusionModel(**CFG, device="cpu")
    q = DiffusionModel(**CFG, quantized=True, quantized_attention=True, device="cpu")
    assert list(q.state_dict()) == list(float_model.state_dict())
    q.load_state_dict(float_model.state_dict(), strict=True)
    _, params = random_jax_params(CFG)
    npz = str(tmp_path / "m.npz")
    save_params_npz(params, npz)
    q.load_state_dict(load_state_dict(npz, device="cpu"), strict=True)
    pt = str(tmp_path / "m.pt")
    torch.save(q.state_dict(), pt)
    q.load_state_dict(load_state_dict(pt, device="cpu"), strict=True)
    q.freeze_int8({name: torch.tensor(1.0) for name in q.int8_layers()})
    assert list(q.state_dict()) == list(float_model.state_dict())
    assert all(m.kernel_q.dtype == torch.int8 for m in q.int8_layers().values())


def test_frozen_ddim_chain_tracks_jax_and_composes_with_the_levers():
    """A DDIM eta-0 chain with the JAX package's frozen state carried across
    correlates above 0.999 with JAX's chain; the max stack (frozen int8,
    encoder_cache 2, guidance_interval (0.2, 0.7)) stays finite and
    correlated with the exact float chain (the JAX test's 0.9) and with
    JAX's own stacked chain."""
    jfloat, jmodel, params, model = _jax_model_and_port(CFG)
    serving = jq.build_int8_variables(jmodel, params, _jax_calibration_inputs())
    model.load_int8_state(flax_quant_to_torch(serving["quant"]))
    kw = dict(DIFF, use_ddim=True, ddim_eta=0.0)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    y = np.array([1, 3], np.int32)
    jd = JaxDiffusion(model=jmodel, **kw)
    td = Diffusion(model=model, **kw)
    levers = dict(encoder_cache=2, guidance_interval=(0.2, 0.7))
    runs = {}
    for name, lv in (("plain", {}), ("stack", levers)):
        runs["jax", name] = np.asarray(jd.denoise(serving, jax.random.PRNGKey(0),
                                                  x=jnp.asarray(x), y=jnp.asarray(y), **lv))
        runs["port", name] = td.denoise(torch.Generator().manual_seed(0), x=t_(x),
                                        y=t_(y).long(), **lv).numpy()
    exact = np.asarray(JaxDiffusion(model=jfloat, **kw).denoise(
        params, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y)))

    def corr(a, b):
        return np.corrcoef(a.ravel(), b.ravel())[0, 1]

    assert corr(runs["port", "plain"], runs["jax", "plain"]) > 0.999
    assert np.isfinite(runs["port", "stack"]).all()
    assert corr(runs["port", "stack"], runs["jax", "stack"]) > 0.999
    assert corr(runs["port", "stack"], exact) > 0.9


def test_calibration_npz_round_trips_both_ways(tmp_path):
    """Port writes, JAX's load_params + freeze_int8 read it: kernel_q
    bit-equal to the port's; and JAX writes, the port reads and freezes:
    kernel_q bit-equal to JAX's, inv_act and deq within 1 ulp."""
    _, jmodel, params, model = _jax_model_and_port(CFG, quantized_attention=True)
    inputs = _jax_calibration_inputs()
    # port -> JAX: load_params + freeze_int8 on the port's file
    calib = tq.collect_calibration(model, _to_torch_inputs(inputs))
    path = str(tmp_path / "port_calib.npz")
    save_calibration(calib, path)
    tq.freeze_int8(model, calib)
    _check_jax_freeze(model, jmodel, params, load_params(path))
    # JAX -> port: save_params_npz of JAX's calibration, read and frozen here
    jcalib = jq.collect_calibration(jmodel, params, inputs)
    path = str(tmp_path / "jax_calib.npz")
    save_params_npz(jcalib, path)
    loaded = load_calibration(path, device="cpu")
    assert loaded.keys() == model.int8_layers().keys()
    tq.freeze_int8(model, loaded)
    _check_jax_freeze(model, jmodel, params, jcalib)
    # the converters invert each other
    back = flax_calibration_to_torch(calibration_to_flax(loaded))
    assert all(float(back[k]) == float(v) for k, v in loaded.items())


def test_calibration_inputs_span_the_chain():
    """The draw runs the dynamic path (no layer frozen, none recording);
    the inputs are CFG-doubled at num_points rescaled steps, the last pure
    noise."""
    model = DiffusionModel(**CFG, quantized=True, device="cpu").eval()
    d = Diffusion(model=model, **DIFF)
    inputs = tq.calibration_inputs(d, torch.Generator().manual_seed(0),
                                   y=torch.tensor([1, 2]), batch_size=2, num_points=3)
    assert [tuple(x.shape) for x, _, _ in inputs] == [(4, 16, 16, 1)] * 3
    n = d.rescaled_num_steps
    assert [t[0].item() for _, t, _ in inputs] == d.timestep_map[[0, n // 2, n - 1]].tolist()
    assert inputs[0][2].tolist() == [1, 2, 0, 0]
    assert all(m.kernel_q is None and m.absmax is None for m in model.int8_layers().values())


def test_sample_cli_int8_calibrates_saves_and_reloads(tmp_path):
    """The entry point with --dtype int8: calibrate (the dynamic draw),
    save --int8_calibration, freeze and serve; a second run loads the file
    without drawing and gives the same images bit for bit."""
    from nicediffusion_tpu_torch.scripts import sample

    cfg = dict(CFG, num_classes=10)  # CFG's null class: --num_classes 9
    _, params = random_jax_params(cfg, seed=3)
    model_path = str(tmp_path / "tiny_model.npz")
    save_params_npz(params, model_path)
    calib_path = str(tmp_path / "calib.npz")
    argv = ["--model_path", model_path, "--custom", "--resolution", "16", "--model_channels",
            "32", "--channel_mult", "1/2", "--num_res_blocks", "1", "--attention_resolutions",
            "8", "--in_channels", "1", "--num_heads", "2", "--num_classes", "9",
            "--resblock_updown", "--use_adaptive_gn", "--rescaled_num_steps", "4",
            "--original_num_steps", "40", "--beta_schedule", "cosine", "--sampling_var_type",
            "learned_interpolation", "--guidance_method", "classifier_free",
            "--guidance_strength", "0.8", "--batch_size", "2", "--num_samples", "1",
            "--seed", "0", "--cpu", "--dtype", "int8", "--int8_calibration", calib_path]
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    first = sample.main(argv + ["--save_path", str(tmp_path / "a") + "/"])
    assert os.path.exists(calib_path)
    calib = load_calibration(calib_path, device="cpu")
    assert len(calib) == len(DiffusionModel(**cfg, quantized=True, device="meta").int8_layers())
    second = sample.main(argv + ["--save_path", str(tmp_path / "b") + "/"])
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))
    np.testing.assert_array_equal(first[0][1], second[0][1])
    assert first[0][1].shape == (2, 16, 16, 3) and first[0][1].std() > 0
