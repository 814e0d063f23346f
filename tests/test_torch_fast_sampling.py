"""The port's fast-sampling path against the JAX package's, on the CPU.

DPM-Solver++(2M) (its float64-made tables bit for bit, single steps, whole
chains), v-prediction, dynamic thresholding, limited-interval guidance and
the encoder cache. Both packages run the same weights (the JAX tree through
the port's converter) in f32, to the repo's 1e-3 bar. The JAX ``denoise``
takes no injected noise, so whole chains are compared on the deterministic
samplers (DDIM eta 0 and DPM++) from a shared start x. What has no JAX
counterpart to compare with (the random stream of a stochastic chain, the
number of model calls a lever saves) is checked in the port alone.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu_torch import Diffusion  # noqa: E402
from nicediffusion_tpu_torch.diffusion.process import _runs  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402

CFG = dict(
    resolution=8, in_channels=2, model_channels=32, out_channels=4,
    num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
    num_heads=2, split_qkv_first=True, resblock_updown=True,
    use_adaptive_gn=True, num_classes=4 + 1,
)
DIFF = dict(
    original_num_steps=1000, rescaled_num_steps=8, beta_schedule="cosine",
    sampling_var_type="learned_interpolation", loss_type="hybrid",
    guidance_method="classifier_free", guidance_strength=0.8,
)
STEPS = DIFF["rescaled_num_steps"]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) with the same seeded weights."""
    jmodel, params = random_jax_params(CFG, seed=11)
    return jmodel, params, port_model(CFG, params)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 2)).astype(np.float32)
    other = rng.normal(size=(batch, 8, 8, 2)).astype(np.float32)
    y = np.array([1, 3, 2, 4][:batch], np.int32)
    return x, other, y


# ----------------------------------------------------------------------
# tables and single functions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rescaled_num_steps=8, beta_schedule="cosine"),
    dict(rescaled_num_steps=20, beta_schedule="linear"),
    dict(rescaled_num_steps=1000, beta_schedule="linear"),
    dict(rescaled_num_steps=10, beta_schedule="cosine", respacing="karras"),
    dict(rescaled_num_steps=2, beta_schedule="linear"),
    dict(rescaled_num_steps=5, beta_schedule="linear", timestep_indices=[0, 10, 200, 600, 999]),
], ids=lambda kw: "-".join(str(v) for v in kw.values() if not isinstance(v, list)))
def test_dpmpp_tables_are_bit_equal(kw):
    kw = dict(original_num_steps=1000, sampling_var_type="small", loss_type="simple", **kw)
    jd = JaxDiffusion(model=None, **kw)
    td = Diffusion(model=None, device="cpu", **kw)
    for name in ("_dpmpp_c_xt", "_dpmpp_c_d", "_dpmpp_m"):
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.dtype == np.float32 and np.array_equal(a, b), name
    n = td.rescaled_num_steps
    # at t = 0 sigma_prev is 0: x's coefficient is exactly 0, and m is 0 at both ends
    assert td._dpmpp_c_xt[0] == 0 and td._dpmpp_m[0] == 0 and td._dpmpp_m[n - 1] == 0


@pytest.mark.parametrize("t_values", [(7, 1), (0, 3)], ids=["t7-t1", "t0-t3"])
def test_to_eps_for_v_matches_jax(t_values):
    kw = dict(DIFF, guidance_method=None, guidance_strength=None, prediction_type="v")
    jd, td = JaxDiffusion(model=None, **kw), Diffusion(model=None, device="cpu", **kw)
    v, x, _ = _state(5)
    t = np.array(t_values, np.int32)
    ref = jd._to_eps(jnp.asarray(v), jnp.asarray(x), jnp.asarray(t))
    out = td._to_eps(_t(v), _t(x), _t(t).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    as_eps = Diffusion(model=None, device="cpu", **dict(kw, prediction_type="eps"))
    assert torch.equal(as_eps._to_eps(_t(v), _t(x), _t(t).long()), _t(v))  # the identity


@pytest.mark.parametrize("q", [0.995, 0.9, 0.5])
def test_dynamic_thresholding_matches_jax(q):
    """Per-sample quantile of |pred_x0| (linear interpolation), floor 1,
    clamp and divide; one example stays under the floor."""
    kw = dict(DIFF, guidance_method=None, guidance_strength=None, clip_x="dynamic",
              dynamic_threshold=q)
    jd, td = JaxDiffusion(model=None, **kw), Diffusion(model=None, device="cpu", **kw)
    x, _, _ = _state(9, batch=3)
    x[0] *= 3.0
    x[1] *= 0.2  # every |value| < 1: the floor holds and nothing changes
    ref = jd._clip_x0(jnp.asarray(x))
    out = td._clip_x0(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert torch.equal(out[1], _t(x)[1]) and out.abs().max() <= 1.0
    assert not torch.equal(out[0], _t(x)[0].clamp(-1, 1))


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("t_index", ["last", "mid", "one", "zero"])
def test_dpmpp_step_matches_jax(pair, t_index, first):
    jmodel, params, model = pair
    kw = dict(DIFF, sampler="dpm++")
    jd, td = JaxDiffusion(model=jmodel, **kw), Diffusion(model=model, **kw)
    ts = {"last": STEPS - 1, "mid": 4, "one": 1, "zero": 0}[t_index]
    x, x0_prev, y = _state(ts)
    t = np.full((2,), ts, np.int32)
    ref_x, ref_x0 = jd.dpmpp_step(params, x, t, jnp.asarray(x0_prev), y=y, first=first)
    with torch.no_grad():
        out_x, out_x0 = td.dpmpp_step(_t(x), _t(t).long(), _t(x0_prev), y=_t(y).long(),
                                      first=first)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-3, rtol=0)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), atol=1e-3, rtol=0)
    if t_index == "mid":  # the table's m is not 0 there: `first` must matter
        with torch.no_grad():
            other, _ = td.dpmpp_step(_t(x), _t(t).long(), _t(x0_prev), y=_t(y).long(),
                                     first=not first)
        assert not torch.allclose(other, out_x, atol=1e-3)


def test_runs_compresses_flags():
    assert _runs([]) == []
    assert _runs([True, True, False, True]) == [(0, 2, True), (2, 1, False), (3, 1, True)]
    assert _runs([False] * 3) == [(0, 3, False)]


# ----------------------------------------------------------------------
# whole deterministic chains against the JAX package's denoise
# ----------------------------------------------------------------------

LEVERS = {
    "plain": {},
    "interval": dict(guidance_interval=(0.0, 0.5)),
    "cache3-with-a-tail": dict(encoder_cache=3),
    "cache3-and-interval": dict(encoder_cache=3, guidance_interval=(0.25, 0.75)),
    "k-larger-than-the-chain": dict(encoder_cache=20),
}
SAMPLERS = {
    "ddim": dict(sampler="ddim", ddim_eta=0.0),
    "dpm++": dict(sampler="dpm++"),
}


def _both_chains(pair, diff_kw, denoise_kw, seed=7, **kw):
    jmodel, params, model = pair
    x, _, y = _state(seed)
    ref = JaxDiffusion(model=jmodel, **diff_kw).denoise(
        params, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y), **denoise_kw, **kw)
    out = Diffusion(model=model, **diff_kw).denoise(
        torch.Generator().manual_seed(0), x=_t(x), y=_t(y).long(), **denoise_kw, **kw)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_chain_matches_jax(pair, sampler, lever):
    out, ref = _both_chains(pair, dict(DIFF, **SAMPLERS[sampler]), LEVERS[lever])
    assert out.shape == (2, 8, 8, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_v_prediction_dynamic_thresholding_chain_matches_jax(pair):
    """The same weights read as a v-model, DPM++ with dynamic thresholding,
    the cache and the interval together."""
    kw = dict(DIFF, sampler="dpm++", prediction_type="v", clip_x="dynamic",
              dynamic_threshold=0.9)
    out, ref = _both_chains(pair, kw, dict(encoder_cache=2, guidance_interval=(0.0, 0.6)))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_partial_dpmpp_chain_starts_first_order(pair):
    """A partial denoise starts at an index whose table m is not 0: the
    first executed step must ignore it (x0_prev starts as zeros)."""
    out, ref = _both_chains(pair, dict(DIFF, sampler="dpm++"), {}, start_step=5, steps_to_do=5)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_classifier_guided_dpmpp_chain_matches_jax(pair):
    """Classifier guidance through the shared DDIM/DPM++ tail: the gradient
    is taken inside ``denoise``'s inference mode. A linear classifier."""
    w = np.random.default_rng(3).normal(size=(8 * 8 * 2, 5)).astype(np.float32) * 0.3
    tw = _t(w)
    kw = dict(DIFF, sampler="dpm++", guidance_method="classifier", guidance_strength=2.0)
    jmodel, params, model = pair
    x, _, y = _state(13)
    ref = JaxDiffusion(
        model=jmodel, **kw,
        classifier=lambda xx, t: xx.reshape(xx.shape[0], -1) @ jnp.asarray(w) * (1.0 + t[:, None]),
    ).denoise(params, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y))
    td = Diffusion(
        model=model, **kw,
        classifier=lambda xx, t: xx.reshape(xx.shape[0], -1) @ tw * (1.0 + t[:, None]),
    )
    out = td.denoise(torch.Generator().manual_seed(0), x=_t(x), y=_t(y).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    plain = Diffusion(model=model, **dict(kw, guidance_method=None)).denoise(
        torch.Generator().manual_seed(0), x=_t(x), y=_t(y).long())
    assert not torch.allclose(out, plain, atol=1e-2)


# ----------------------------------------------------------------------
# the port alone: the random stream, the errors, the model calls saved
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lever", [
    dict(encoder_cache=1), dict(guidance_interval=(0.0, 1.0)),
    dict(encoder_cache=1, guidance_interval=(0.0, 1.0)),
], ids=["cache1", "full-interval", "both"])
def test_exact_levers_equal_the_plain_ddpm_chain_bit_for_bit(pair, lever):
    """Stochastic DDPM from one seed: k = 1 and an interval that covers the
    chain are the plain chain, noise draws included."""
    _, _, model = pair
    d = Diffusion(model=model, **DIFF)
    y = torch.tensor([1, 2])

    def run(**kw):
        return d.denoise(torch.Generator().manual_seed(5), y=y, batch_size=2, **kw)

    assert torch.equal(run(**lever), run())


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_every_variant_draws_one_noise_tensor_a_step(pair, sampler):
    """With any lever the generator ends where the plain chain leaves it:
    start noise, then one draw a step, the masked one at t = 0 included."""
    _, _, model = pair
    d = Diffusion(model=model, **dict(DIFF, sampler=sampler, ddim_eta=0.7))
    y = torch.tensor([1, 2])
    states = []
    for kw in ({}, dict(encoder_cache=3), dict(guidance_interval=(0.0, 0.5)),
               dict(encoder_cache=3, guidance_interval=(0.25, 0.75))):
        g = torch.Generator().manual_seed(5)
        d.denoise(g, y=y, batch_size=2, **kw)
        states.append(g.get_state())
    assert all(torch.equal(s, states[0]) for s in states[1:])
    g = torch.Generator().manual_seed(5)
    for _ in range(1 + STEPS):
        torch.randn((2, 8, 8, 2), generator=g)
    assert torch.equal(g.get_state(), states[0])


def test_lever_arguments_are_checked(pair):
    _, _, model = pair
    d = Diffusion(model=model, **DIFF)
    y = torch.tensor([1])
    for k in (0, -2):
        with pytest.raises(ValueError, match="encoder_cache must be >= 1"):
            d.denoise(torch.Generator(), y=y, encoder_cache=k)
    for bad in ((0.5, 0.5), (0.6, 0.2), (-0.1, 0.5), (0.0, 1.5)):
        with pytest.raises(ValueError, match="0 <= lo < hi <= 1"):
            d.denoise(torch.Generator(), y=y, guidance_interval=bad)
    plain = Diffusion(model=model, **dict(DIFF, guidance_method=None, guidance_strength=None))
    with pytest.raises(ValueError, match="requires classifier-free guidance"):
        plain.denoise(torch.Generator(), y=y, guidance_interval=(0.0, 0.5))
    for kw in (dict(sampler="heun"), dict(clip_x="soft"), dict(prediction_type="x0")):
        with pytest.raises(NotImplementedError):
            Diffusion(model=model, **dict(DIFF, **kw))


class _Counted:
    """Counts the calls of a model's forward, embed, encode and decode and
    the batch each saw."""

    def __init__(self, model, monkeypatch):
        self.calls = {name: [] for name in ("forward", "embed", "encode", "decode")}
        for name in self.calls:
            inner = getattr(model, name)

            def wrapped(*args, _inner=inner, _name=name, **kw):
                self.calls[_name].append(args[0].shape[0])
                return _inner(*args, **kw)

            monkeypatch.setattr(model, name, wrapped)


# steps 8: t = 7 .. 0. (lever, forwards, encodes, decodes, doubled-batch model calls)
CALLS = [
    ({}, 8, 8, 8, 8),
    # guided iff 0 <= t < 4
    (dict(guidance_interval=(0.0, 0.5)), 8, 8, 8, 4),
    # groups (7,6,5) (4,3,2), tail 1, 0: two refreshes and two plain forwards
    (dict(encoder_cache=3), 2, 4, 8, 8),
    # k clamped to 8: one group, one refresh, no tail
    (dict(encoder_cache=20), 0, 1, 8, 8),
    # guided iff 2 <= t < 6: group (7,6,5) holds t = 5 and (4,3,2) all but none
    # of the tail, so 6 cached steps run doubled and the tail runs single
    (dict(encoder_cache=3, guidance_interval=(0.25, 0.75)), 2, 4, 8, 6),
    # guided iff 0 <= t < 2: both groups unguided, the tail guided
    (dict(encoder_cache=3, guidance_interval=(0.0, 0.25)), 2, 4, 8, 2),
]


@pytest.mark.parametrize("lever,forwards,encodes,decodes,doubled", CALLS,
                         ids=[str(sorted(c[0].items())) for c in CALLS])
def test_model_calls_per_chain(pair, monkeypatch, lever, forwards, encodes, decodes, doubled):
    """What a lever saves is model calls: the skipped CFG half and the
    cached encoder are never called."""
    _, _, model = pair
    d = Diffusion(model=model, **dict(DIFF, sampler="dpm++"))
    counted = _Counted(model, monkeypatch)
    out = d.denoise(torch.Generator().manual_seed(0), y=torch.tensor([1, 2]), batch_size=2,
                    **lever)
    assert torch.isfinite(out).all()
    calls = counted.calls
    # forward() itself goes through embed, encode and decode
    assert len(calls["forward"]) == forwards
    assert len(calls["encode"]) == encodes
    assert len(calls["decode"]) == len(calls["embed"]) == decodes
    assert sum(b == 4 for b in calls["decode"]) == doubled
    assert sum(b == 2 for b in calls["decode"]) == decodes - doubled
    # a cached step decodes at the batch its group's refresh encoded
    assert set(calls["encode"]) <= set(calls["decode"])
