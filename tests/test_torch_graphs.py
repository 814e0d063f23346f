"""The graphed chain of ``Diffusion.denoise`` (diffusion/graphs.py) on the CPU.

On a CUDA device ``denoise`` replays one captured CUDA graph a step. What a
graph captures is ``ChainGraphs._body``: one ``Diffusion._chain_step`` from
the static buffers into them. ``ChainGraphs(capture=False)`` keeps that body,
run eagerly, in place of each graph, so the graphed path (its buffers, its
keys, its plan, its noise draws and its counts) runs here, where no graph
can be captured:

- (a) it gives the eager loop's chain bit for bit (DDPM, DDIM and DPM++, each
  lever, ``row_shard``, SR's ``low_res``), twice on one cache;
- (b) it matches the JAX package's chain to 1e-3 in f32 (DDIM eta 0 through
  ``denoise``; DDPM with the port's noise injected into JAX's steps);
- (c) its (key, t) order is the eager loop's, with the keys each variant needs;
- (d) the weight signature moves with an in-place ``load_state_dict``,
  ``freeze_int8`` and a replaced parameter, and a moved signature drops the
  graphs;
- (e) a capture's tallies are taken out and each replay adds them again;
- (f) ``cuda_graph=True`` raises on the CPU, under classifier guidance, on a
  model paired by ``shard_module_`` and while int8 calibration records.

The card holds real graphs against the eager loop bit for bit in
tests/test_torch_kernels.py (``-k graph``) and chip_smoke.py's ``[graph]``.
"""

import collections
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.diffusion import graphs  # noqa: E402
from nicediffusion_tpu_torch.models.unet import SuperResolutionModel, shard_module_  # noqa: E402
from nicediffusion_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402

# tests/test_torch_fast_sampling.py's small configuration
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
SAMPLERS = {
    "ddpm": dict(sampler="ddpm"),
    "ddim": dict(sampler="ddim", ddim_eta=0.7),
    "dpm++": dict(sampler="dpm++"),
}
LEVERS = {
    "plain": {},
    "interval": dict(guidance_interval=(0.1, 0.7)),
    "cache2": dict(encoder_cache=2),
    "cache2-interval": dict(encoder_cache=2, guidance_interval=(0.1, 0.7)),
}
# distinct keys (guided, cache role, first) a chain of 8 steps needs: the
# interval (0.1, 0.7) guides 1 <= t < 6; with the cache the groups (7, 6)
# unguided, (5, 4), (3, 2), (1, 0) guided; DPM++ adds its first step's key
KEYS = {
    ("ddpm", "plain"): 1, ("ddpm", "interval"): 2, ("ddpm", "cache2"): 2,
    ("ddpm", "cache2-interval"): 4, ("dpm++", "plain"): 2, ("dpm++", "interval"): 3,
    ("dpm++", "cache2"): 3, ("dpm++", "cache2-interval"): 4,
}
KEYS.update({("ddim", lever): n for (s, lever), n in KEYS.items() if s == "ddpm"})


def randomize(model, seed):
    """Seeded fan-in-scaled weights, none left at zero (the zero-initialised
    output convs take part)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            noise = torch.randn(p.shape, generator=g)
            p.copy_(noise / p[0].numel() ** 0.5 if p.ndim > 1 else 1.0 + 0.1 * noise)
    return model.eval()


@pytest.fixture(scope="module")
def model():
    return randomize(DiffusionModel(**CFG, device="cpu"), 11)


def graphed(d: Diffusion) -> Diffusion:
    """``d`` on the graphed path with the body run eagerly in place of each
    replay: what a CUDA device runs, minus the capture."""
    d._graphs = graphs.ChainGraphs(capture=False)
    d._use_graphs = lambda cuda_graph: True
    return d


def chains(d, e, seeds, **kw):
    """The graphed ``d`` and the eager ``e`` from one seed each: outputs and
    the generators' end states."""
    out = []
    for which in (d, e):
        for seed in seeds:
            g = torch.Generator().manual_seed(seed)
            out.append((which.denoise(g, **kw), g.get_state()))
    return out[:len(seeds)], out[len(seeds):]


# ----------------------------------------------------------------------
# (a) the captured step, run eagerly, is the eager loop bit for bit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_graphed_body_equals_the_eager_chain_bit_for_bit(model, sampler, lever):
    """Two chains on one cache (the second replays the first's keys), each
    equal to the eager loop's, noise draws included. Tolerance: none."""
    kw = dict(DIFF, **SAMPLERS[sampler])
    d, e = graphed(Diffusion(model=model, **kw)), Diffusion(model=model, **kw)
    got, want = chains(d, e, (5, 6), y=torch.tensor([1, 3]), batch_size=2, **LEVERS[lever])
    for (a, ga), (b, gb) in zip(got, want):
        assert torch.isfinite(b).all() and torch.equal(a, b) and torch.equal(ga, gb)
    assert len(d._graphs.graphs) == KEYS[sampler, lever]


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++"])
def test_graphed_row_shard_equals_the_eager_rows(model, sampler):
    """``row_shard=(r, 2)``: each rank's rows of a batch of 4, its noise drawn
    at the global shape, equal to the eager loop's rows (no tolerance) and to
    the unsharded chain's within 1e-4 (the CPU's f32 sums see the batch, and
    eight steps carry the difference on)."""
    kw = dict(DIFF, **SAMPLERS[sampler])
    y = torch.tensor([1, 3, 2, 4])
    whole = Diffusion(model=model, **kw).denoise(torch.Generator().manual_seed(8), y=y,
                                                 batch_size=4, encoder_cache=2)
    for r in range(2):
        d, e = graphed(Diffusion(model=model, **kw)), Diffusion(model=model, **kw)
        got, want = chains(d, e, (8,), y=y[2 * r:2 * r + 2], batch_size=4, row_shard=(r, 2),
                           encoder_cache=2)
        assert torch.equal(got[0][0], want[0][0]) and torch.equal(got[0][1], want[0][1])
        torch.testing.assert_close(got[0][0], whole[2 * r:2 * r + 2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "cfg"])
def test_graphed_sr_chain_with_low_res_equals_the_eager_chain(guided):
    """SR's ``low_res`` through ``with_model_kwargs``: a static buffer of the
    graphs, refilled each chain. Tolerance: none."""
    cfg = dict(model_channels=32, out_channels=3, num_res_blocks=1, attention_resolutions=(8,),
               channel_mult=(1, 2), num_heads=2, num_classes=4 if guided else None,
               resblock_updown=False, use_adaptive_gn=False, resolution=16, in_channels=6)
    model = randomize(SuperResolutionModel(**cfg, device="cpu"), 2)
    kw = dict(original_num_steps=40, rescaled_num_steps=6, sampling_var_type="small",
              loss_type="simple", beta_schedule="cosine")
    if guided:
        kw.update(guidance_method="classifier_free", guidance_strength=1.5)
    rng = np.random.default_rng(3)
    d, e = graphed(Diffusion(model=model, **kw)), Diffusion(model=model, **kw)
    y = torch.tensor([1, 3]) if guided else None
    for seed in (0, 1):  # the second chain brings other low-res images
        low = torch.from_numpy(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
        low = torch.cat([low, low]) if guided else low
        x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
        outs = []
        for which in (d, e):
            which.with_model_kwargs(low_res=low)
            outs.append(which.denoise(torch.Generator().manual_seed(seed), x=x, y=y))
        assert torch.equal(*outs) and outs[0].shape == (2, 16, 16, 3)
    assert len(d._graphs.buffers) == 1 and len(d._graphs.graphs) == 1


# ----------------------------------------------------------------------
# (b) against the JAX package
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jmodel, params = random_jax_params(CFG, seed=11)
    return jmodel, params, port_model(CFG, params)


def test_graphed_ddim_chain_matches_jax(pair):
    """DDIM eta 0 from a shared x, through both ``denoise``s: 1e-3 in f32."""
    jmodel, params, model = pair
    kw = dict(DIFF, sampler="ddim", ddim_eta=0.0)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    y = np.array([1, 3], np.int32)
    want = np.asarray(JaxDiffusion(model=jmodel, **kw).denoise(
        params, jax.random.PRNGKey(0), x=jnp.asarray(x), y=jnp.asarray(y)))
    got = graphed(Diffusion(model=model, **kw)).denoise(
        torch.Generator().manual_seed(0), x=torch.from_numpy(x), y=torch.from_numpy(y).long())
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_graphed_ddpm_chain_matches_jax_steps_with_its_noise(pair):
    """Stochastic DDPM: the port's start noise and step noises (its
    generator's stream: x_T, then one draw a step) injected into JAX's
    ``ddpm_step``s, t = 7 .. 0: 1e-3 in f32."""
    jmodel, params, model = pair
    y = np.array([2, 4], np.int32)
    got = graphed(Diffusion(model=model, **DIFF)).denoise(
        torch.Generator().manual_seed(3), y=torch.from_numpy(y).long(), batch_size=2)
    g = torch.Generator().manual_seed(3)
    draws = [torch.randn((2, 8, 8, 2), generator=g).numpy() for _ in range(1 + STEPS)]
    jd = JaxDiffusion(model=jmodel, **DIFF)
    x = jnp.asarray(draws[0])
    for i, ts in enumerate(range(STEPS - 1, -1, -1)):
        x, _ = jd.ddpm_step(params, x, jnp.full((2,), ts, jnp.int32), y=jnp.asarray(y),
                            noise=jnp.asarray(draws[1 + i]))
    np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=1e-3, rtol=0)


# ----------------------------------------------------------------------
# (c) the plan of replays
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("sampler", ["ddpm", "dpm++"])
def test_replays_follow_the_eager_order(model, monkeypatch, sampler, lever):
    """The graphed path steps through (key, t) in the eager loop's order of
    (t, guided, cache role, first), one step of the chain each, with the
    keys each variant needs."""
    kw = dict(DIFF, **SAMPLERS[sampler])
    eager, steps = [], []
    chain_step = Diffusion._chain_step

    def recorded(self, x, x0_prev, t, y, noise, guided, cache_mode, cache, first):
        if self is e:
            eager.append((int(t[0]), guided, cache_mode, first and sampler == "dpm++"))
        return chain_step(self, x, x0_prev, t, y, noise, guided, cache_mode, cache, first)

    step = graphs.ChainGraphs._step

    def stepped(self, key, body):
        steps.append((key, int(body.args[1].t[0])))
        return step(self, key, body)

    monkeypatch.setattr(Diffusion, "_chain_step", recorded)
    monkeypatch.setattr(graphs.ChainGraphs, "_step", stepped)
    d, e = graphed(Diffusion(model=model, **kw)), Diffusion(model=model, **kw)
    chains(d, e, (1,), y=torch.tensor([1, 3]), batch_size=2, **LEVERS[lever])
    assert [t for t, *_ in eager] == list(range(STEPS - 1, -1, -1))
    assert [(t, *key[1:]) for key, t in steps] == eager
    assert len({key for key, _ in steps}) == KEYS[sampler, lever]


# ----------------------------------------------------------------------
# (d) the weight signature
# ----------------------------------------------------------------------

def test_weight_signature_moves_with_the_weights():
    model = randomize(DiffusionModel(**CFG, device="cpu"), 1)
    before = graphs.weight_signature(model)
    assert graphs.weight_signature(model) == before
    model.load_state_dict(randomize(DiffusionModel(**CFG, device="cpu"), 2).state_dict())
    loaded = graphs.weight_signature(model)  # in place: the versions moved
    assert loaded != before and [p for p, _ in loaded] == [p for p, _ in before]
    with torch.no_grad():
        model.out[-1].weight = torch.nn.Parameter(model.out[-1].weight.clone())
    assert graphs.weight_signature(model) != loaded

    quant = randomize(DiffusionModel(**CFG, quantized=True, device="cpu"), 3)
    x, t, y = torch.randn(2, 8, 8, 2), torch.tensor([3, 900]), torch.tensor([1, 2])
    with torch.no_grad(), quant.calibrating():
        quant(x, t, y)
    calibrated = graphs.weight_signature(quant)
    quant.freeze_int8(quant.int8_calibration())
    assert len(graphs.weight_signature(quant)) > len(calibrated)


def test_moved_weights_drop_the_graphs(model):
    """A chain after an in-place load recaptures (its keys anew) and follows
    the new weights; ``reset_graphs`` frees everything."""
    local = randomize(DiffusionModel(**CFG, device="cpu"), 4)
    d, e = graphed(Diffusion(model=local, **DIFF)), Diffusion(model=local, **DIFF)
    y = torch.tensor([1, 3])
    chains(d, e, (2,), y=y, batch_size=2)
    kept = dict(d._graphs.graphs)
    local.load_state_dict(model.state_dict())
    got, want = chains(d, e, (2,), y=y, batch_size=2)
    assert torch.equal(got[0][0], want[0][0])
    assert d._graphs.graphs.keys() == kept.keys()
    assert all(d._graphs.graphs[k] is not kept[k] for k in kept)
    d.reset_graphs()
    assert not d._graphs.graphs and not d._graphs.buffers and d._graphs.signature is None


# ----------------------------------------------------------------------
# (e) the counts around a capture and its replays
# ----------------------------------------------------------------------

class _Fake:
    launches = 0


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_capture_takes_its_tallies_out_and_replays_add_them(replays):
    """Fake counters (an int attribute, a Counter, an append-only list) and a
    fake capture that runs the body once, as a capture runs the Python of a
    step, and whose replay runs none of it."""
    fake, routes, calls = _Fake(), collections.Counter(a=1), [7]
    log = {"calls": calls}
    tallies = [(fake, "launches"), ({"routes": routes}, "routes"), (log, "calls")]
    fake.launches = 5

    def body():
        fake.launches += 22
        routes["b"] += 2
        calls.extend([16, 8])

    device = []

    class Recorded:
        def replay(self):
            device.append("replayed")

    def record(fn):
        fn()
        return Recorded()

    step = graphs.StepGraph(body, record, tallies)
    assert fake.launches == 5 and routes == collections.Counter(a=1) and calls == [7]
    for _ in range(replays):
        step.replay()
    assert device == ["replayed"] * replays
    assert fake.launches == 5 + 22 * replays
    assert routes == collections.Counter(a=1, b=2 * replays)
    assert calls == [7] + [16, 8] * replays
    graphs.add_tallies(tallies, step.delta, times=2)
    assert fake.launches == 5 + 22 * (replays + 2)


def test_a_failed_capture_leaves_the_tallies_as_they_were():
    fake = _Fake()
    fake.launches = 3

    def record(fn):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    def body():
        fake.launches += 1

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.StepGraph(body, record, [(fake, "launches")])
    assert fake.launches == 3


def test_the_port_counters_are_tallied():
    """Every kernel wrapper's launch counter and K1's routes are in TALLIES."""
    from nicediffusion_tpu_torch.ops.kernels import attention, conv, groupnorm, int8conv
    from nicediffusion_tpu_torch.ops.kernels import resblock, winograd

    owners = {id(owner) for owner, _ in graphs.TALLIES}
    for fn in (attention.fused_qkv_attention, attention.fused_qkv_attention_bwd,
               attention.mha_attention, conv.conv_nhwc, groupnorm.group_norm_fused,
               groupnorm.group_norm_fused_bwd, int8conv.int8_conv_nhwc,
               resblock.gn_silu_conv3x3, winograd.winograd_conv_nhwc):
        assert id(fn) in owners
    assert (attention, "route_launches") in graphs.TALLIES


# ----------------------------------------------------------------------
# (f) where a chain stays eager
# ----------------------------------------------------------------------

def _classifier(xx, t):
    return xx.reshape(xx.shape[0], -1)[:, :5] * (1.0 + t[:, None])


@pytest.mark.parametrize("case", ["cpu", "classifier", "tensor_parallel", "calibrating"])
def test_cuda_graph_true_raises_where_the_chain_stays_eager(case):
    model = randomize(DiffusionModel(**CFG, quantized=case == "calibrating", device="cpu"), 5)
    kw = dict(DIFF)
    if case == "classifier":
        kw.update(guidance_method="classifier", guidance_strength=1.0, classifier=_classifier)
    if case == "tensor_parallel":
        shard_module_(model, Mesh(num_data=1, num_model=2))
    d = Diffusion(model=model, **kw)
    denoise = functools.partial(d.denoise, torch.Generator().manual_seed(0),
                                y=torch.tensor([1, 2]), batch_size=2, steps_to_do=1)
    error = ValueError if case == "cpu" else NotImplementedError
    match = "CUDA device" if case == "cpu" else "next slice of ROADMAP.md queue A"
    with pytest.raises(error, match=match):
        if case == "calibrating":
            with model.calibrating():
                denoise(cuda_graph=True)
        else:
            denoise(cuda_graph=True)
    if case != "tensor_parallel":  # its forward needs the model group's processes
        assert d._use_graphs(None) is False  # the default: the eager loop
        assert torch.isfinite(denoise()).all()
    assert d._use_graphs(False) is False
