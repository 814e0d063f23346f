"""The port's forward process and training losses against the JAX package's, on the CPU.

The same weights (the JAX tree through the port's converter), the same
numpy-made x_0, t (including t = 0) and noise go through
``jax.value_and_grad(diffusion.loss)`` and the port's ``Diffusion.loss`` with
``torch.autograd.grad``, for each loss type and each variance mode, in f32
with dropout 0. Gates: loss 1e-5; parameter gradients 1e-4 of the largest
gradient; ``bpd`` totals 1e-4 with injected noise.

To keep the sixteen loss x variance cases from compiling the JAX model
sixteen times, the JAX side of those is taken in two factors, each still the
JAX package's own code: ``jax.value_and_grad`` of ``Diffusion.loss`` with
respect to the model's output (a stand-in model hands the output through),
and the model's VJP at that cotangent, compiled once per output width. One
case also runs ``jax.value_and_grad(diffusion.loss)`` whole and must agree
with the factored form.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.ops.math import kl_div as jax_kl_div  # noqa: E402
from nicediffusion_tpu_torch import Diffusion  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import flax_params_to_torch_state_dict  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402

LOSS_TYPES = ["simple", "KL", "KL_rescaled", "hybrid"]
VAR_TYPES = ["small", "large", "learned", "learned_interpolation"]


def model_cfg(learned: bool):
    """Two levels, 32 channels, AdaGN, attention at 4x4 (N = 16) and a
    null-class row; the output has the log-variance half iff it is learned."""
    return dict(
        resolution=8, in_channels=2, model_channels=32, out_channels=4 if learned else 2,
        num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
        num_heads=2, split_qkv_first=True, resblock_updown=True,
        use_adaptive_gn=True, num_classes=4 + 1, dropout=0.0,
    )


DIFF = dict(original_num_steps=1000, rescaled_num_steps=8, beta_schedule="cosine",
            guidance_method="classifier_free", guidance_strength=0.8)


@pytest.fixture(scope="module")
def pairs():
    """learned? -> (JAX model, JAX params, port model), seeded weights.

    The output conv is scaled down so the raw log-variance stays inside its
    interpolation range, as a trained model's does. Far outside it the
    t = 0 NLL's ``cdf_plus - cdf_minus`` cancels in f32 and the two
    frameworks' tanh disagree by more than the gradient gate."""
    out = {}
    for learned in (False, True):
        cfg = model_cfg(learned)
        jmodel, params = random_jax_params(cfg, seed=5)
        last = params["out"]["layers_2"]
        last["kernel"], last["bias"] = 0.1 * last["kernel"], 0.1 * last["bias"]
        out[learned] = (jmodel, params, port_model(cfg, params))
    return out


class _OutputAsParams:
    """Stand-in JAX model whose "parameters" are its output, so that
    ``jax.value_and_grad(diffusion.loss)`` differentiates the loss with
    respect to the model output."""

    conditional = True

    @staticmethod
    def apply(variables, x, t, **kwargs):
        return variables["params"]


@pytest.fixture(scope="module")
def jax_model_fns(pairs):
    """learned? -> (forward, vjp) of the JAX model, each compiled once."""
    fns = {}
    for learned, (jmodel, _, _) in pairs.items():
        def forward(p, x, t, y, jmodel=jmodel):
            return jmodel.apply({"params": p}, x, t, y=y)

        def vjp(p, x, t, y, cot, forward=forward):
            return jax.vjp(lambda p_: forward(p_, x, t, y), p)[1](cot)[0]

        fns[learned] = (jax.jit(forward), jax.jit(vjp))
    return fns


def jax_loss_and_grads(jd, fns, params, x0, noise, t, y):
    """``value_and_grad(diffusion.loss)`` as loss-wrt-output times the
    model's VJP; returns (loss, gradients as a port-named dict)."""
    forward, vjp = fns
    x_t = jd.q_sample(x0, t, noise)
    mapped = jnp.take(jd.timestep_map, t)
    out = forward(params, x_t, mapped, y)
    head = JaxDiffusion(
        model=_OutputAsParams(), original_num_steps=jd.original_num_steps,
        rescaled_num_steps=jd.rescaled_num_steps, beta_schedule="cosine",
        sampling_var_type=jd.sampling_var_type, loss_type=jd.loss_type,
        guidance_method="classifier_free", guidance_strength=0.8,
        prediction_type=jd.prediction_type)
    loss, cot = jax.value_and_grad(
        lambda o: head.loss(o, x0, t, None, y=y, noise=noise).mean())(out)
    grads = vjp(params, x_t, mapped, y, cot)
    return float(loss), flax_params_to_torch_state_dict(jax.tree.map(np.asarray, grads))


def batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, size=(n, 8, 8, 2)).astype(np.float32)
    noise = rng.normal(size=(n, 8, 8, 2)).astype(np.float32)
    t = np.array([0, 1, 4, 7][:n], np.int32)  # t = 0 takes the NLL branch
    y = np.array([1, 0, 3, 4][:n], np.int32)
    return x0, noise, t, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_q_sample_and_diffuse_match_jax(pairs):
    jmodel, _, model = pairs[True]
    kw = dict(DIFF, sampling_var_type="learned_interpolation", loss_type="hybrid")
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    x0, noise, t, _ = batch()
    ref = jd.q_sample(x0, t, noise)
    out = td.q_sample(_t(x0), _t(t).long(), _t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    ref = jd.diffuse(jnp.asarray(x0), steps_to_do=5, noise=jnp.asarray(noise))
    out = td.diffuse(_t(x0), steps_to_do=5, noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # without noise it draws from the generator, reproducibly
    a = td.diffuse(_t(x0), torch.Generator().manual_seed(3))
    b = td.diffuse(_t(x0), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, td.diffuse(_t(x0), noise=_t(noise)))


@pytest.mark.parametrize("var_type", VAR_TYPES)
def test_variational_lower_bound_matches_jax(pairs, var_type):
    """The per-t VLB term (KL for t > 0, discretized NLL at t = 0) on
    numpy-made eps and log-variance inputs."""
    jmodel, _, model = pairs[True]
    kw = dict(DIFF, sampling_var_type=var_type, loss_type="KL")
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    x0, noise, t, _ = batch(1)
    rng = np.random.default_rng(2)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    raw = rng.uniform(-1, 1, size=x0.shape).astype(np.float32)
    x_t = np.asarray(jd.q_sample(x0, t, noise))
    ref = jd.variational_lower_bound(x0, x_t, t, eps, jd._resolve_log_var(raw, t, 4))
    out = td.variational_lower_bound(
        _t(x0), _t(x_t), _t(t).long(), _t(eps),
        td._resolve_log_var(_t(raw), _t(t).long(), 4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_and_gradients_match_jax(pairs, jax_model_fns, loss_type, var_type):
    learned = var_type.startswith("learned")
    jmodel, params, model = pairs[learned]
    kw = dict(DIFF, sampling_var_type=var_type, loss_type=loss_type)
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    x0, noise, t, y = batch(2)
    ref_loss, ref_grads = jax_loss_and_grads(jd, jax_model_fns[learned], params, x0, noise, t, y)

    per_example = td.loss(_t(x0), _t(t).long(), y=_t(y).long(), noise=_t(noise))
    assert per_example.shape == (4,)
    loss = per_example.mean()
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    # KL_rescaled and hybrid carry the x rescaled_num_steps factor and reach
    # ~1e3 on random weights, so the loss gate is 1e-5 relative there
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5, atol=1e-5)
    top = max(np.abs(g).max() for g in ref_grads.values())
    assert top > 0
    for name, g in zip(names, grads):
        ref = ref_grads[name]
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(got - ref).max() <= 1e-4 * top, name


def test_factored_jax_gradients_are_value_and_grad_of_the_loss(pairs, jax_model_fns):
    """The factored JAX reference above == ``jax.value_and_grad`` of the
    whole ``diffusion.loss``, on the recipe's hybrid x learned_interpolation."""
    jmodel, params, _ = pairs[True]
    kw = dict(DIFF, sampling_var_type="learned_interpolation", loss_type="hybrid")
    jd = JaxDiffusion(model=jmodel, **kw)
    x0, noise, t, y = batch(2)
    loss, grads = jax_loss_and_grads(jd, jax_model_fns[True], params, x0, noise, t, y)
    whole_loss, whole = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, x0, t, None, y=y, noise=noise).mean()))(params)
    whole = flax_params_to_torch_state_dict(jax.tree.map(np.asarray, whole))
    np.testing.assert_allclose(loss, float(whole_loss), rtol=1e-6)
    top = max(np.abs(g).max() for g in whole.values())
    for name, g in whole.items():
        assert np.abs(grads[name] - g).max() <= 1e-5 * top, name


def test_hybrid_detaches_eps_in_the_vlb(pairs):
    """HYBRID's VLB term trains the variances only: the gradient of the
    eps half of the output is that of the SIMPLE loss alone."""
    _, _, model = pairs[True]
    x0, noise, t, y = batch(3)
    args = (_t(x0), _t(t).long())
    grads = {}
    for loss_type in ("simple", "hybrid"):
        td = Diffusion(model=model, **dict(DIFF, sampling_var_type="learned", loss_type=loss_type))
        cut = {}

        def keep_output_gradient(mod, inp, out):
            out.register_hook(lambda g: cut.setdefault("g", g))

        handle = model.out.register_forward_hook(keep_output_gradient)
        try:
            td.loss(*args, y=_t(y).long(), noise=_t(noise)).mean().backward()
        finally:
            handle.remove()
        model.zero_grad()
        grads[loss_type] = cut["g"]
    eps_s, raw_s = grads["simple"].chunk(2, dim=-1)
    eps_h, raw_h = grads["hybrid"].chunk(2, dim=-1)
    torch.testing.assert_close(eps_h, eps_s)
    assert not raw_s.any() and raw_h.any()


def test_loss_draws_noise_from_the_generator(pairs):
    _, _, model = pairs[True]
    td = Diffusion(model=model, **dict(DIFF, sampling_var_type="learned", loss_type="hybrid"))
    x0, _, t, y = batch(4)
    with torch.no_grad():
        a, b, c = (td.loss(_t(x0), _t(t).long(), torch.Generator().manual_seed(s), y=_t(y).long())
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_v_prediction_is_queued(pairs):
    """v-prediction is ported (no longer queued): it builds, and its simple
    loss regresses the native target a*noise - s*x_0, which is not the eps
    model's loss on the same weights. Unknown types raise."""
    _, _, model = pairs[True]
    kw = dict(DIFF, sampling_var_type="learned", loss_type="simple")
    x0, noise, t, y = batch(2)
    args = dict(y=_t(y).long(), noise=_t(noise))
    with torch.no_grad():
        as_v = Diffusion(model=model, **kw, prediction_type="v").loss(_t(x0), _t(t).long(), **args)
        as_eps = Diffusion(model=model, **kw).loss(_t(x0), _t(t).long(), **args)
    assert torch.isfinite(as_v).all() and not torch.allclose(as_v, as_eps)
    with pytest.raises(NotImplementedError):
        Diffusion(model=model, **kw, prediction_type="x0")


@pytest.mark.parametrize("var_type", ["small", "learned", "learned_interpolation"])
@pytest.mark.parametrize("loss_type", ["simple", "hybrid"])
def test_v_prediction_loss_and_gradients_match_jax(pairs, jax_model_fns, loss_type, var_type):
    """``prediction_type="v"``: SIMPLE and the simple half of HYBRID regress
    the model's native output against a*noise - s*x_0; the VLB takes the
    converted eps (detached in HYBRID)."""
    learned = var_type.startswith("learned")
    jmodel, params, model = pairs[learned]
    kw = dict(DIFF, sampling_var_type=var_type, loss_type=loss_type, prediction_type="v")
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    x0, noise, t, y = batch(6)
    ref_loss, ref_grads = jax_loss_and_grads(jd, jax_model_fns[learned], params, x0, noise, t, y)
    loss = td.loss(_t(x0), _t(t).long(), y=_t(y).long(), noise=_t(noise)).mean()
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5, atol=1e-5)
    top = max(np.abs(g).max() for g in ref_grads.values())
    assert top > 0
    for name, g in zip(names, grads):
        ref = ref_grads[name]
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(got - ref).max() <= 1e-4 * top, name


def test_bpd_matches_jax_with_injected_noise(pairs, jax_model_fns):
    """The full-chain bound: the port's Python loop against a loop over the
    JAX package's own per-step functions on the same injected noise (the
    JAX ``bpd`` draws inside its scan), total and per-t terms to 1e-4."""
    jmodel, params, model = pairs[True]
    kw = dict(DIFF, sampling_var_type="learned_interpolation", loss_type="hybrid")
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    x0, _, _, y = batch(5)
    forward, _ = jax_model_fns[True]
    steps = jd.rescaled_num_steps
    noise = np.random.default_rng(6).normal(size=(steps,) + x0.shape).astype(np.float32)

    vlb = []
    for ts in range(steps):
        t = np.full((4,), ts, np.int32)
        x_t = jd.q_sample(x0, t, noise[ts])
        # get_eps_and_log_var, with the model call compiled once
        eps, raw = jd._split_out(forward(params, x_t, jnp.take(jd.timestep_map, t), y))
        log_var = jd._resolve_log_var(raw, t, x_t.ndim)
        vlb.append(np.asarray(jd.variational_lower_bound(x0, x_t, t, eps, log_var)))
    got = td.bpd(_t(x0), y=_t(y).long(), noise=_t(noise))
    assert got["vlb_terms"].shape == got["mse_terms"].shape == (steps, 4)
    np.testing.assert_allclose(got["vlb_terms"].numpy(), np.stack(vlb), rtol=1e-4, atol=1e-4)

    # the prior term KL(q(x_T | x_0) || N(0, I)), as JAX's bpd forms it
    mean_T = np.asarray(jd._sqrt_acp)[-1] * x0
    log_var_T = np.full_like(x0, np.log1p(-np.asarray(jd._acp)[-1]))
    prior = np.asarray(jax_kl_div(mean_T, log_var_T, 0.0 * x0, 0.0 * x0))
    prior = prior.reshape(4, -1).mean(axis=1) / np.log(2.0)
    np.testing.assert_allclose(got["prior_bpd"].numpy(), prior, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got["total_bpd"].numpy(), np.stack(vlb).sum(0) + prior, rtol=1e-4, atol=1e-4)
    # drawn noise: reproducible from the generator's seed
    a = td.bpd(_t(x0), torch.Generator().manual_seed(0), y=_t(y).long())["total_bpd"]
    b = td.bpd(_t(x0), torch.Generator().manual_seed(0), y=_t(y).long())["total_bpd"]
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_gradient_names_cover_every_parameter():
    """The converter's flat names cover every port parameter (a guard for
    the gradient comparison above, which looks gradients up by name)."""
    cfg = model_cfg(True)
    _, params = random_jax_params(cfg, seed=5)
    names = set(flax_params_to_torch_state_dict(params))
    assert names == {n for n, _ in port_model(cfg, params).named_parameters()}
    assert len(traverse_util.flatten_dict(params)) == len(names)
