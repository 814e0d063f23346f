"""The port's sampling steps and chain against the JAX package's, on the CPU.

torch and JAX draw different random numbers, so stochastic steps are
compared with injected noise and whole chains on deterministic DDIM (eta 0)
from a shared start x. Both run the same weights (the JAX tree through the
port's converter), in f32, to the repo's 1e-3 bar.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import flax_params_to_torch_state_dict  # noqa: E402

CFG = dict(
    resolution=8, in_channels=2, model_channels=32, out_channels=4,
    num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
    num_heads=2, split_qkv_first=True, resblock_updown=True,
    use_adaptive_gn=True, num_classes=4 + 1,
)
DIFF = dict(
    original_num_steps=1000, rescaled_num_steps=6, beta_schedule="cosine",
    sampling_var_type="learned_interpolation", loss_type="hybrid",
    guidance_method="classifier_free", guidance_strength=0.8,
)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) with the same seeded weights."""
    jmodel = JaxModel(**CFG)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 2)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    )["params"]
    rng = np.random.default_rng(0)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        if path[-1] == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif path[-1] == "scale":
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        else:
            v = (1.0 if path[-1] == "embedding" else 0.2) * rng.normal(size=leaf.shape)
        flat[path] = v.astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    model = DiffusionModel(**CFG, device="cpu")
    model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in flax_params_to_torch_state_dict(params).items()},
        strict=True,
    )
    return jmodel, params, model.eval()


def _state(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 2)).astype(np.float32)
    noise = rng.normal(size=(batch, 8, 8, 2)).astype(np.float32)
    y = np.array([1, 3][:batch], np.int32)
    return x, noise, y


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
@pytest.mark.parametrize("t_index", ["last", "one", "zero"])
def test_single_step_with_injected_noise(pair, sampler, t_index):
    jmodel, params, model = pair
    kw = dict(DIFF, use_ddim=sampler == "ddim", ddim_eta=0.5)
    jd = JaxDiffusion(model=jmodel, **kw)
    td = Diffusion(model=model, **kw)
    ts = {"last": jd.rescaled_num_steps - 1, "one": 1, "zero": 0}[t_index]
    x, noise, y = _state(ts)
    t = np.full((2,), ts, np.int32)
    jstep = jd.ddim_step if sampler == "ddim" else jd.ddpm_step
    tstep = td.ddim_step if sampler == "ddim" else td.ddpm_step
    ref_x, ref_x0 = jstep(params, x, t, y=y, noise=noise)
    with torch.no_grad():
        out_x, out_x0 = tstep(torch.from_numpy(x), torch.from_numpy(t).long(),
                              y=torch.from_numpy(y).long(),
                              noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), atol=1e-3, rtol=0)


def test_ddim_chain_matches_jax(pair):
    """A whole deterministic DDIM (eta 0) chain, CFG on, from a shared x."""
    jmodel, params, model = pair
    kw = dict(DIFF, use_ddim=True, ddim_eta=0.0)
    x, _, y = _state(7)
    ref = JaxDiffusion(model=jmodel, **kw).denoise(
        params, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y)
    )
    out = Diffusion(model=model, **kw).denoise(
        torch.Generator().manual_seed(0), x=torch.from_numpy(x),
        y=torch.from_numpy(y).long(),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)


@pytest.mark.parametrize("var_type", ["small", "large", "learned", "learned_interpolation"])
def test_guided_eps_and_log_var_match_jax(pair, var_type):
    """CFG eps and the resolved log-variance for all four variance modes."""
    jmodel, params, model = pair
    kw = dict(DIFF, sampling_var_type=var_type)
    x, _, y = _state(3)
    t = np.array([4, 2], np.int32)
    ref_eps, ref_lv = JaxDiffusion(model=jmodel, **kw)._guided_eps(
        params, x, t, y, want_log_var=True)
    with torch.no_grad():
        eps, lv = Diffusion(model=model, **kw)._guided_eps(
            torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(y).long(), want_log_var=True)
    np.testing.assert_allclose(eps.numpy(), np.asarray(ref_eps), atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        np.broadcast_to(lv.numpy(), eps.shape),
        np.broadcast_to(np.asarray(ref_lv), eps.shape), atol=1e-3, rtol=0)


class _Recorder(torch.nn.Module):
    """A stand-in model: records its inputs, answers x * (1 + y) per
    channel half so the conditional and null rows are told apart."""

    conditional = True
    resolution, in_channels = 4, 1

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.calls = []

    def forward(self, x, t, y):
        self.calls.append((x.clone(), t.clone(), y.clone()))
        f = (1.0 + y.float()).reshape(-1, 1, 1, 1)
        return torch.cat([x * f, x * f + 10.0 * f], dim=-1)


def test_cfg_doubles_the_batch_with_null_label_zero():
    """One model call with [x, x] and labels [y, 0]; eps is
    (1+w) eps_c - w eps_0 and the log-var half comes from the conditional
    rows only (JAX process.py:389-416)."""
    rec = _Recorder()
    d = Diffusion(model=rec, **DIFF)
    x = torch.randn(2, 4, 4, 1)
    y = torch.tensor([2, 3])
    t = torch.tensor([3, 3])
    eps, lv = d._guided_eps(x, t, y, want_log_var=True)
    (x2, t2, y2), = rec.calls
    assert torch.equal(x2, torch.cat([x, x]))
    assert torch.equal(y2, torch.tensor([2, 3, 0, 0]))
    assert torch.equal(t2, d.timestep_map[torch.cat([t, t])])
    f = (1.0 + y.float()).reshape(-1, 1, 1, 1)
    w = DIFF["guidance_strength"]
    torch.testing.assert_close(eps, (1 + w) * x * f - w * x)
    expect_lv = d._resolve_log_var(x * f + 10.0 * f, t, 4)
    torch.testing.assert_close(lv, expect_lv)


def test_denoise_draws_from_the_generator(pair):
    """Same generator seed, same chain; another seed, another chain."""
    _, _, model = pair
    d = Diffusion(model=model, **DIFF)
    y = torch.tensor([1, 2])

    def run(seed):
        return d.denoise(torch.Generator().manual_seed(seed), y=y, batch_size=2,
                         steps_to_do=2, start_step=None)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (2, 8, 8, 2) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() <= 1.0 + 1e-6


def test_unported_options_name_the_roadmap(pair):
    """Every option of the JAX constructor and of its ``denoise`` is ported
    (tests/test_torch_fast_sampling.py holds them against JAX): they build
    and run, and only unknown values raise."""
    _, _, model = pair
    for kw in (dict(sampler="dpm++"), dict(clip_x="dynamic"), dict(prediction_type="v")):
        d = Diffusion(model=model, **dict(DIFF, **kw))
        assert (d.sampler, d.clip_x, d.prediction_type) == (
            kw.get("sampler", "ddpm"), kw.get("clip_x", True), kw.get("prediction_type", "eps"))
    for kw in (dict(sampler="plms"), dict(clip_x="percentile"), dict(prediction_type="x0")):
        with pytest.raises(NotImplementedError):
            Diffusion(model=model, **dict(DIFF, **kw))
    # classifier guidance is ported: it builds with a classifier and asks for one without
    assert Diffusion(model=model, **dict(DIFF, guidance_method="classifier"),
                     classifier=lambda x, t: x.sum((1, 2))).guidance == "classifier"
    with pytest.raises(ValueError, match="needs a classifier"):
        Diffusion(model=model, **dict(DIFF, guidance_method="classifier"))
    d = Diffusion(model=model, **DIFF)
    for kw in (dict(encoder_cache=2), dict(guidance_interval=(0.0, 0.5))):
        out = d.denoise(torch.Generator().manual_seed(0), y=torch.tensor([1]), steps_to_do=3,
                        **kw)
        assert out.shape == (1, 8, 8, 2) and torch.isfinite(out).all()
