"""The port's noisy classifier and classifier guidance against the JAX
package's, on the CPU, in f32.

A JAX EncoderUNet's parameter tree is filled with seeded numpy values (none
left at zero), carried over by the port's converter and loaded strict. The
forwards, the guidance gradient, guided DDPM and DDIM steps with injected
noise and a guided deterministic DDIM chain must agree. On CPU tensors the
port's kernel wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models.classifier import EncoderUNet as JaxEncoderUNet  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz  # noqa: E402
from nicediffusion_tpu.utils.config import CLASSIFIER_PRESETS as JAX_PRESETS  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel, EncoderUNet  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402
from nicediffusion_tpu_torch.utils.checkpoint import load_state_dict  # noqa: E402
from nicediffusion_tpu_torch.utils.config import (  # noqa: E402
    CLASSIFIER_PRESETS,
    classifier_preset_for_path,
)
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    convert_torch_state_dict,
    flax_params_to_torch_state_dict,
)

# as TINY in tests/test_classifier.py, with AdaGN and up/down blocks on
TINY = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=10,
    num_res_blocks=2, attention_resolutions=(8,), channel_mult=(1, 2),
    num_head_channels=16, use_adaptive_gn=True, resblock_updown=True,
)
UNET = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
    num_heads=2, num_classes=10, use_adaptive_gn=True, resblock_updown=True,
)
DIFF = dict(
    original_num_steps=40, rescaled_num_steps=10,
    sampling_var_type="learned_interpolation", loss_type="hybrid",
    beta_schedule="cosine", ddim_eta=0.0,
)


def random_tree(model, *init_args, seed=0):
    """The parameter tree of a JAX module with every leaf replaced by
    seeded, non-zero, fan-in-scaled numpy values."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *init_args))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        shape = leaf.shape
        if path[-1] == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif path[-1] == "scale":
            v = 1.0 + 0.2 * rng.normal(size=shape)
        elif path[-1] == "positional_embedding":
            v = rng.normal(size=shape) / np.sqrt(shape[-1])
        elif path[-1] == "embedding":
            v = rng.normal(size=shape)
        else:
            v = 0.2 * rng.normal(size=shape)
        flat[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def as_tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def classifier_pair(cfg, seed=0, **kw):
    """(JAX classifier, its params, the port's classifier with the same weights)."""
    jmodel = JaxEncoderUNet(**cfg)
    res, cin = cfg["resolution"], cfg["in_channels"]
    params = random_tree(jmodel, jnp.zeros((1, res, res, cin)), jnp.zeros((1,), jnp.int32),
                         seed=seed)
    model = EncoderUNet(**cfg, device="cpu", **kw)
    model.load_state_dict(as_tensors(flax_params_to_torch_state_dict(params)), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def guided():
    """JAX and port UNet + classifier with shared weights, and a factory of
    (JAX Diffusion, port Diffusion) pairs."""
    jcls, cparams, cls = classifier_pair(TINY, seed=1)
    junet = JaxModel(**UNET)
    uparams = random_tree(junet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1,), jnp.int32), seed=2)
    unet = DiffusionModel(**UNET, device="cpu").eval()
    unet.load_state_dict(as_tensors(flax_params_to_torch_state_dict(uparams)), strict=True)

    def classifier_fn(x, t):
        return jcls.apply({"params": cparams}, x, t)

    def make(**kw):
        kw = dict(DIFF, **kw)
        return (JaxDiffusion(model=junet, classifier=classifier_fn, **kw),
                Diffusion(model=unet, classifier=cls, **kw))

    return make, uparams, cls


def _state(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 16, 16, 1)).astype(np.float32)
    noise = rng.normal(size=(batch, 16, 16, 1)).astype(np.float32)
    return x, noise, np.array([1, 4], np.int32)


@pytest.mark.parametrize("pool", ["attention", "adaptive"])
@pytest.mark.parametrize("split_qkv_first", [False, True])
def test_encoder_unet_forward_matches_jax(split_qkv_first, pool):
    """Both trunk layouts and both pools, AdaGN and up/down blocks on; the
    tree loads strict and the f32 logits agree to 1e-5."""
    cfg = dict(TINY, split_qkv_first=split_qkv_first, pool=pool)
    jmodel, params, model = classifier_pair(cfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 16, 16, 1)).astype(np.float32)
    t = np.array([3, 17, 999], np.int32)
    ref = np.asarray(jmodel.apply({"params": params}, x, t))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert out.dtype == torch.float32 and out.shape == (3, 10)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_classifier_state_dict_round_trips_and_raw_names_load(tmp_path):
    """The port's names map back onto the flax tree exactly (the positional
    embedding transposed both ways), and a converted .pt, a raw-named .pt
    and the JAX package's .npz all load strict through load_state_dict."""
    _, params, model = classifier_pair(TINY, seed=4)
    pos = model.out[2].positional_embedding
    assert tuple(pos.shape) == (64, 8 * 8 + 1)  # torch's (C, N+1)
    back = traverse_util.flatten_dict(convert_torch_state_dict(model.state_dict()))
    ref = traverse_util.flatten_dict(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])

    raw_names = (
        ("downsampling", "input_blocks"), ("in_norm", "in_layers.0"),
        ("in_conv", "in_layers.2"), ("step_embedding", "emb_layers.1"),
        ("out_norm", "out_layers.0"), ("out_conv", "out_layers.3"),
        ("skip", "skip_connection"), ("step_embed", "time_embed"), ("qkv_nin", "qkv"),
    )
    raw = {}
    for k, v in model.state_dict().items():
        for ours, theirs in raw_names:
            k = k.replace(ours, theirs)
        raw[k] = v.clone()
    assert "input_blocks.1.0.in_layers.0.weight" in raw and "out.2.qkv_proj.weight" in raw
    paths = {name: str(tmp_path / name) for name in
             ("converted_classifier.pt", "raw_classifier.pt", "classifier.npz")}
    torch.save(model.state_dict(), paths["converted_classifier.pt"])
    torch.save(raw, paths["raw_classifier.pt"])
    save_params_npz(params, paths["classifier.npz"])
    for path in paths.values():
        again = EncoderUNet(**TINY, device="cpu")
        again.load_state_dict(load_state_dict(path, device="cpu"), strict=True)
        for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
            assert torch.equal(a, b), (path, k)


@pytest.mark.parametrize("preset", ["openai_64", "openai_128", "openai_256"])
def test_classifier_presets_names_and_counts(preset):
    """Built on the meta device (nothing allocated): the presets equal the
    JAX package's, the parameter names are guided-diffusion's after the
    rename map, and names, shapes and count equal the JAX model's tree
    through the converter."""
    cfg = CLASSIFIER_PRESETS[preset]
    assert cfg == JAX_PRESETS[preset]
    assert classifier_preset_for_path(f"models/{cfg['resolution']}x{cfg['resolution']}"
                                      "_classifier.pt") == cfg
    model = EncoderUNet(**cfg, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    res = cfg["resolution"]
    jshapes = jax.eval_shape(
        lambda: JaxEncoderUNet(**cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)), jnp.zeros((1,), jnp.int32))
    )["params"]
    flat = traverse_util.flatten_dict(jshapes)
    zeros = traverse_util.unflatten_dict(
        {k: np.broadcast_to(np.float32(0), v.shape) for k, v in flat.items()})
    expect = {k: tuple(v.shape) for k, v in flax_params_to_torch_state_dict(zeros).items()}
    assert shapes == expect
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in flat.values())
    for name in ("step_embed.0.weight", "downsampling.0.0.weight",
                 "downsampling.1.0.in_norm.weight", "middle_block.1.qkv_nin.weight",
                 "out.0.weight", "out.2.positional_embedding", "out.2.qkv_proj.weight",
                 "out.2.c_proj.bias"):
        assert name in shapes, name
    assert shapes["out.2.positional_embedding"] == (512, 65)
    assert shapes["out.2.qkv_proj.weight"][2:] == (1,)
    with pytest.raises(NotImplementedError, match="no classifier preset"):
        classifier_preset_for_path("models/EMNIST_classifier.pt")


def test_classifier_grad_matches_jax(guided):
    """_classifier_grad against jax.grad of the JAX one, to 1e-4 of the
    largest element; the classifier sees the rescaled t."""
    make, _, _ = guided
    jd, td = make(guidance_method="classifier", guidance_strength=2.0)
    x, _, y = _state(5)
    t = np.array([5, 0], np.int32)
    ref = np.asarray(jd._classifier_grad(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    out = td._classifier_grad(torch.from_numpy(x), torch.from_numpy(t).long(),
                              torch.from_numpy(y).long())
    assert out.dtype == torch.float32 and not out.requires_grad
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
@pytest.mark.parametrize("t_index", ["last", "one", "zero"])
def test_guided_step_with_injected_noise(guided, sampler, t_index):
    """Classifier-guided DDPM and DDIM steps at t = T-1, 1, 0 to 1e-3, and
    each differs from the unguided step."""
    make, uparams, _ = guided
    kw = dict(use_ddim=sampler == "ddim", ddim_eta=0.5)
    jd, td = make(guidance_method="classifier", guidance_strength=2.0, **kw)
    ts = {"last": jd.rescaled_num_steps - 1, "one": 1, "zero": 0}[t_index]
    x, noise, y = _state(10 + ts)
    t = np.full((2,), ts, np.int32)
    jstep = jd.ddim_step if sampler == "ddim" else jd.ddpm_step
    ref_x, ref_x0 = jstep(uparams, x, t, y=y, noise=noise)
    args = (torch.from_numpy(x), torch.from_numpy(t).long())
    targs = dict(y=torch.from_numpy(y).long(), noise=torch.from_numpy(noise))
    with torch.no_grad():
        out_x, out_x0 = getattr(td, f"{sampler}_step")(*args, **targs)
        plain = Diffusion(model=td.model, **dict(DIFF, **kw))
        plain_x, _ = getattr(plain, f"{sampler}_step")(*args, **targs)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), atol=1e-3, rtol=0)
    assert not np.allclose(out_x.numpy(), plain_x.numpy(), atol=1e-6)


def test_guided_ddim_chain_matches_jax(guided):
    """A guided deterministic DDIM (eta 0) chain of 10 steps through
    ``denoise``, which runs under inference mode: the gradient has to be
    taken with it off."""
    make, uparams, cls = guided
    jd, td = make(guidance_method="classifier", guidance_strength=2.0, use_ddim=True)
    x, _, y = _state(7)
    ref = jd.denoise(uparams, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y))
    out = td.denoise(torch.Generator().manual_seed(0), x=torch.from_numpy(x),
                     y=torch.from_numpy(y).long())
    assert td.rescaled_num_steps == 10
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    # and from inside a caller's own inference mode, on tensors made there
    with torch.inference_mode():
        xi, yi = torch.from_numpy(x).clone(), torch.from_numpy(y).long()
        again = td.denoise(torch.Generator().manual_seed(0), x=xi, y=yi)
    assert torch.equal(out, again)
    assert all(p.grad is None and not p.requires_grad for p in cls.parameters())


def test_bf16_classifier_gives_f32_gradient_and_no_parameter_grads():
    """The gradient returns in f32 whatever the classifier's compute type;
    Diffusion freezes an nn.Module classifier, so no parameter gets a
    ``.grad``; a plain callable works as well."""
    _, _, cls = classifier_pair(TINY, seed=6, dtype=torch.bfloat16)
    unet = DiffusionModel(**UNET, device="cpu").eval()
    assert all(p.requires_grad for p in cls.parameters())
    d = Diffusion(model=unet, classifier=cls, guidance_method="classifier",
                  guidance_strength=1.0, **DIFF)
    x, _, y = _state(8)
    args = (torch.from_numpy(x), torch.tensor([3, 3]), torch.from_numpy(y).long())
    grad = d._classifier_grad(*args)
    assert grad.dtype == torch.float32 and grad.shape == x.shape
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    assert all(p.grad is None and not p.requires_grad for p in cls.parameters())
    assert all(p.dtype == torch.float32 for p in cls.parameters())
    wrapped = Diffusion(model=unet, classifier=lambda xx, tt: cls(xx, tt),
                        guidance_method="classifier", guidance_strength=1.0, **DIFF)
    assert torch.equal(wrapped._classifier_grad(*args), grad)
    with pytest.raises(ValueError, match="needs a classifier"):
        Diffusion(model=unet, guidance_method="classifier", guidance_strength=1.0, **DIFF)


@pytest.mark.parametrize("mode", ["silu", "ada"])
def test_groupnorm_backward_computes_only_the_wanted_gradients(mode, monkeypatch):
    """K3's autograd backward honours ``needs_input_grad``: with frozen
    parameters and modulation rows (the classifier gradient) it asks K3's
    backward for x's gradient alone, gets None for the others, and
    differentiates nothing through autograd (the backward is closed form)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 4, 4, 64)).astype(np.float32)).requires_grad_(True)
    sc, bi = torch.ones(64), torch.zeros(64)
    emb = [torch.from_numpy(0.1 * rng.normal(size=(2, 64)).astype(np.float32))
           for _ in range(2)] if mode == "ada" else []
    asked, returned = [], []
    real, real_bwd = torch.autograd.grad, k3.group_norm_fused_bwd

    def spy(outputs, inputs, *a, **k):
        asked.append(len(inputs))
        return real(outputs, inputs, *a, **k)

    def bwd_spy(*a, **k):
        out = real_bwd(*a, **k)
        returned.append((tuple(k["needs"]), out))
        return out

    out = k3.group_norm_fused(x, sc, bi, *emb)
    monkeypatch.setattr(torch.autograd, "grad", spy)
    monkeypatch.setattr(k3, "group_norm_fused_bwd", bwd_spy)
    out.sum().backward()
    monkeypatch.undo()
    assert asked == []
    (needs, grads), = returned
    assert needs == (True, False, False, False, False)[:len(needs)]
    assert grads[0] is not None and all(t is None for t in grads[1:])
    ref, = real(k3.group_norm_fused_plain(x, sc, bi, *emb).sum(), x)
    torch.testing.assert_close(x.grad, ref)
