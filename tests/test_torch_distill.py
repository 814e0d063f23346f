"""The port's distillers (nicediffusion_tpu_torch/training/distill.py) against
the JAX package's, on the CPU.

Small configurations from tests/test_distill.py (an 8x8 one-channel UNet, a
160-step cosine chain respaced to 16). Pieces: ``make_student_diffusion``'s
grid and tables bit-equal, ``_distill_loss`` in both spaces to 1e-6,
``_make_optimizer`` (both schedules, with and without a clip that triggers)
over 4 updates against optax to 1e-6, ``_target_x0`` to 1e-5. Whole steps:
``GuidedDistiller`` and ``ProgressiveDistiller`` take two steps from the
same teacher weights in both packages, the port fed the j and noise the JAX
step draws (``jax.random.split`` of the key the JAX run used); the metrics
per step to 1e-5 relative (``grad_norm`` holds the gradients before
AdamW), the student's parameters and EMA after two steps to 1e-5 of the
student's largest element on every element whose gradient was at least
1e-3 of its parameter's largest at both steps. AdamW divides each gradient
element by its own running scale (plus 1e-8), so on an element whose
gradient is zero in exact arithmetic (a conv bias feeding a GroupNorm of one
channel a group; the variance term while the student still equals the
teacher) float noise moves it by up to the rate in either package; the
elements left out (those, and whole parameters whose largest gradient is
under 1e-6 of the student's) are counted and must stay under 10%. Then the JAX file's
structural tests, and ``var_weight=0`` meaning off (a divergence from the
JAX package).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.training import distill as jd  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.training import distill as td  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import flax_params_to_torch_state_dict  # noqa: E402
from test_distill import DARGS, DARGS_LV, TINY, TINY_COND, TINY_LV  # noqa: E402

BATCH = 8


def jax_setup(cfg, seed=0):
    """Weights like tests/test_distill.py's (flax's init, every leaf then
    jittered off zero by 0.02 N(0, 1): a fresh UNet predicts exactly 0),
    drawn with numpy on the JAX model's tree: kernels N(0, 1/fan-in), the
    zero-initialised output projections 0.02 N(0, 1), biases 0.02 N(0, 1),
    GroupNorm scales 1 + 0.02 N(0, 1), embeddings N(0, 1). A fixed data
    batch with labels 1..4 (0 is the CFG null class)."""
    return _jax_setup(tuple(sorted(cfg.items())), seed)


@functools.lru_cache(maxsize=None)
def _jax_setup(cfg_items, seed):
    model = JaxModel(**dict(cfg_items))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))["params"]
    rng = np.random.default_rng(seed + 100)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        shape, name = leaf.shape, path[-1]
        zero_init = any(m in ("out_conv", "proj_out") for m in path) or path[:2] == ("out", "layers_2")
        if name == "kernel" and not zero_init:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.02 * rng.normal(size=shape)
        elif name == "embedding":
            v = rng.normal(size=shape)
        else:
            v = 0.02 * rng.normal(size=shape)
        flat[path] = v.astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    rng = np.random.default_rng(seed)
    data = (0.6 * np.sin(np.linspace(0, 3, 8)[None, :, None, None]
                         + rng.uniform(0, 6, size=(BATCH, 1, 1, 1)))).astype(np.float32)
    data = data * np.ones((1, 1, 8, 1), np.float32)
    labels = rng.integers(1, 5, size=(BATCH,))
    return model, params, data, labels


def port_pair(kind, cfg, params, dargs, **kw):
    model = DiffusionModel(**cfg, device="cpu")
    cls = td.GuidedDistiller if kind == "guided" else td.ProgressiveDistiller
    return cls(model=model, teacher_params=flax_params_to_torch_state_dict(params),
               diffusion_args=dargs, dataloader=iter(()), iterations=2, **kw)


def assert_tree_close(module, tree, what, mask=None, rel=1e-5):
    """Every parameter of ``module`` (where ``mask``, by name, is true)
    within ``rel`` of the largest element of the whole tree."""
    want = flax_params_to_torch_state_dict(tree)
    scale = max(np.abs(w).max() for w in want.values())
    for name, p in module.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name])
        if mask is not None:
            diff = diff[mask[name]]
        err = diff.max(initial=0.0)
        assert err <= rel * scale, f"{what} {name}: max diff {err:.3g} of max {scale:.3g}"


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dargs", [DARGS, dict(DARGS, original_num_steps=1000,
                                               rescaled_num_steps=50, beta_schedule="linear")],
                         ids=["cosine_160_16", "linear_1000_50"])
@pytest.mark.parametrize("pred", [None, "v"])
def test_student_diffusion_is_bit_equal(dargs, pred):
    jt = JaxDiffusion(model=None, **dargs, use_ddim=True, ddim_eta=0.0)
    pt = Diffusion(model=None, **dargs, use_ddim=True, ddim_eta=0.0, device="cpu")
    js = jd.make_student_diffusion(None, dargs, jt, prediction_type=pred)
    ps = td.make_student_diffusion(None, dargs, pt, prediction_type=pred)
    np.testing.assert_array_equal(ps.timestep_map.numpy(), np.asarray(js.timestep_map))
    np.testing.assert_array_equal(ps._acp.numpy(), np.asarray(js._acp))
    np.testing.assert_array_equal(ps._acp_prev.numpy(), np.asarray(js._acp_prev))
    assert ps.rescaled_num_steps == js.rescaled_num_steps
    assert ps.sampler == "ddim" and ps.guidance is None
    assert ps.prediction_type == (pred or "eps")


@pytest.mark.parametrize("space", ["eps", "x0_snr"])
def test_distill_loss_matches_jax(space):
    rng = np.random.default_rng(0)
    eps_s = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    eps_t = (eps_s + 0.1 * rng.normal(size=eps_s.shape)).astype(np.float32)
    acp = np.array([0.9999, 0.5, 0.01, 2.43e-6], np.float32).reshape(4, 1, 1, 1)
    a, s = np.sqrt(acp), np.sqrt(1 - acp)
    want = float(jd._distill_loss(space, eps_s, eps_t, a, s))
    got = td._distill_loss(space, *map(torch.from_numpy, (eps_s, eps_t, a, s))).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        td._distill_loss("nope", *map(torch.from_numpy, (eps_s, eps_t, a, s)))


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip_triggers"])
def test_make_optimizer_matches_optax(schedule, clip):
    """Four updates on the same gradients: the parameters, the moments'
    effect and the reported pre-clip norm, to 1e-6. 12 iterations give a
    warmup of 1, so the cosine part runs too; the gradients' norm is about
    10, so a clip of 1.0 triggers at every update."""
    rng = np.random.default_rng(1)
    init = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    tx = jd._make_optimizer(1e-2, 1e-2, 12, clip, schedule)
    jparams, state = dict(init), tx.init(init)
    tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in ("w", "b")]
    opt = td._make_optimizer(tparams, 1e-2, 1e-2, 12, clip, schedule)
    for step in range(4):
        g = {k: (3.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()}
        upd, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = opt.step([torch.from_numpy(g[k]) for k in ("w", "b")])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        assert (clip is None) or norm.item() > clip
        for p, k in zip(tparams, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{k} after update {step + 1}")
        if step == 0 and schedule == "warmup_cosine":  # rate 0 at the first update
            np.testing.assert_array_equal(tparams[0].detach().numpy(), init["w"])
    with pytest.raises(ValueError):
        td._make_optimizer(tparams, 1e-3, 0.0, 100, 1.0, "nope")


def test_target_x0_matches_jax():
    model, params, _, labels = jax_setup(TINY_COND)
    jdist = jd.ProgressiveDistiller(model=model, teacher_params=params, diffusion_args=DARGS,
                                    dataloader=iter(()), iterations=0)
    pdist = port_pair("progressive", TINY_COND, params, DARGS)
    z = np.random.default_rng(2).normal(size=(BATCH, 8, 8, 1)).astype(np.float32)
    j = np.array([0, 1, 2, 3, 4, 5, 6, 7])
    want, (wa, ws) = jax.jit(jdist._target_x0)(jdist.teacher_params, jnp.asarray(z),
                                               jnp.asarray(j), jnp.asarray(labels))
    got, (ga, gs) = pdist._target_x0(torch.from_numpy(z), torch.from_numpy(j),
                                     torch.from_numpy(labels))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

STEP_CASES = {
    "guided_eps": ("guided", TINY_COND, DARGS, dict(guidance_strength=2.0)),
    "guided_eps_teacher_v_student": ("guided", TINY_COND, DARGS,
                                     dict(guidance_strength=0.8, student_prediction_type="v",
                                          lr_schedule="warmup_cosine")),
    "progressive_x0snr": ("progressive", TINY_COND, DARGS, dict(grad_clip=None)),
    "progressive_x0snr_var": ("progressive", TINY_LV, DARGS_LV,
                              dict(var_weight=1.0, lr_schedule="warmup_cosine")),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_steps_match_jax(case):
    kind, cfg, dargs, kw = STEP_CASES[case]
    kw = dict(kw, ema_rate=0.5, seed=5)  # the distillers' default rate, 1e-4
    model, params, batch, labels = jax_setup(cfg, seed=1)
    jcls = jd.GuidedDistiller if kind == "guided" else jd.ProgressiveDistiller
    jdist = jcls(model=model, teacher_params=params, diffusion_args=dargs,
                 dataloader=iter(()), iterations=2, **kw)
    pdist = port_pair(kind, cfg, params, dargs, **kw)
    assert pdist.loss_space == jdist.loss_space
    assert pdist.student.prediction_type == jdist.student.prediction_type
    grads = []  # the port's gradients at each update, by parameter
    update = pdist.optimizer.step

    def recording(gs):
        gs = list(gs)
        grads.append([g.abs().numpy().copy() for g in gs])
        return update(gs)

    pdist.optimizer.step = recording
    key = jdist.rng
    for step in range(2):
        key, step_rng = jax.random.split(key)
        jdist.state, want = jdist._step_fn(jdist.state, jdist.teacher_params,
                                           jnp.asarray(batch), jnp.asarray(labels), step_rng)
        j_rng, n_rng = jax.random.split(step_rng)
        j = jax.random.randint(j_rng, (BATCH,), 0, jdist.student.rescaled_num_steps)
        noise = jax.random.normal(n_rng, batch.shape, dtype=jnp.float32)
        got = pdist.train_step(batch, labels, j=np.asarray(j), noise=np.asarray(noise))
        for name in ("loss", "loss_eps", "loss_var", "grad_norm"):
            np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5,
                                       atol=1e-12, err_msg=f"{name} at step {step + 1}")
        assert float(want["loss"]) > 1e-6  # the case compares something
    assert pdist.step == 2 and int(jdist.state.step) == 2
    # AdamW-conditioned elements: at both steps, the gradient at least 1e-3 of
    # its parameter's largest, in a parameter whose largest is at least 1e-6
    # of the student's (the rest is float noise on a zero gradient)
    names = [n for n, _ in pdist.model.named_parameters()]
    top = [max(g.max() for g in step_grads) for step_grads in grads]
    mask = {n: np.logical_and(*[(g[i] >= 1e-3 * g[i].max()) & (g[i].max() >= 1e-6 * t)
                                for g, t in zip(grads, top)])
            for i, n in enumerate(names)}
    left_out = sum((~m).sum() for m in mask.values()) / sum(m.size for m in mask.values())
    assert left_out < 0.1, f"{left_out:.3f} of the elements have near-zero gradients"
    assert_tree_close(pdist.model, jdist.state.params, "student", mask)
    assert_tree_close(pdist.ema_model, jdist.state.ema_params, "EMA", mask)
    # the teacher is untouched
    assert_tree_close(pdist.teacher_model, params, "teacher", rel=0)


def test_guided_variance_term_matches_jax_off_the_teacher():
    """The guided distiller's variance term at a non-zero value: one step
    with var_weight=1.0 from a student jittered away from the teacher (the
    same numpy jitter in both packages), the metrics to 1e-5 relative. No
    parameters are compared, so AdamW's float noise does not arise."""
    kw = dict(guidance_strength=0.8, var_weight=1.0, ema_rate=0.5, seed=5)
    model, params, batch, labels = jax_setup(TINY_LV, seed=1)
    rng = np.random.default_rng(9)
    student = jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape)).astype(np.float32), params)
    jdist = jd.GuidedDistiller(model=model, teacher_params=params, diffusion_args=DARGS_LV,
                               dataloader=iter(()), iterations=2, **kw)
    jdist.state = jdist.state.replace(params=jax.tree.map(jnp.asarray, student))
    pdist = port_pair("guided", TINY_LV, params, DARGS_LV, **kw)
    pdist.model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                 flax_params_to_torch_state_dict(student).items()}, strict=True)
    _, step_rng = jax.random.split(jdist.rng)
    _, want = jdist._step_fn(jdist.state, jdist.teacher_params, jnp.asarray(batch),
                             jnp.asarray(labels), step_rng)
    j_rng, n_rng = jax.random.split(step_rng)
    j = jax.random.randint(j_rng, (BATCH,), 0, jdist.student.rescaled_num_steps)
    noise = jax.random.normal(n_rng, batch.shape, dtype=jnp.float32)
    got = pdist.train_step(batch, labels, j=np.asarray(j), noise=np.asarray(noise))
    assert float(want["loss_var"]) > 1e-4 * float(want["loss"]) > 0  # the term is live
    for name in ("loss", "loss_eps", "loss_var", "grad_norm"):
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, atol=0,
                                   err_msg=name)


def test_run_draws_from_its_generator_and_returns_the_live_student():
    model, params, batch, labels = jax_setup(TINY_COND)

    def loader():
        while True:
            yield batch, labels

    runs = []
    for _ in range(2):
        pdist = port_pair("guided", TINY_COND, params, DARGS, guidance_strength=0.8, lr=1e-3)
        pdist.loader, pdist.iterations = loader(), 3
        sd, student = pdist.run(log_every=None)
        assert student is pdist.student and student.guidance is None
        assert sd["out.2.weight"].data_ptr() == pdist.model.out[2].weight.data_ptr()
        runs.append({k: v.clone() for k, v in sd.items()})
    for k in runs[0]:
        torch.testing.assert_close(runs[0][k], runs[1][k], rtol=0, atol=0)
    assert any((runs[0][k] != torch.as_tensor(np.array(v))).any()
               for k, v in flax_params_to_torch_state_dict(params).items())


# ---------------------------------------------------------------------------
# structure (tests/test_distill.py's, in the port)
# ---------------------------------------------------------------------------

def teacher_diffusion(dargs=DARGS):
    return Diffusion(model=None, **dargs, use_ddim=True, ddim_eta=0.0, device="cpu")


def test_student_grid_nests_in_teacher():
    teacher = teacher_diffusion()
    student = td.make_student_diffusion(None, DARGS, teacher)
    assert student.rescaled_num_steps == 8
    np.testing.assert_array_equal(student.timestep_map.numpy(),
                                  teacher.timestep_map.numpy()[1::2])
    np.testing.assert_allclose(student._acp.numpy(), teacher._acp.numpy()[1::2], rtol=1e-6)
    np.testing.assert_allclose(student._acp_prev.numpy(), teacher._acp_prev.numpy()[0::2],
                               rtol=1e-6)


def test_odd_teacher_steps_rejected():
    args = dict(DARGS, original_num_steps=90, rescaled_num_steps=9)
    with pytest.raises(AssertionError):
        td.make_student_diffusion(None, args, teacher_diffusion(args))


def test_second_round_teacher_keeps_student_grid():
    student1 = td.make_student_diffusion(None, DARGS, teacher_diffusion())
    args2 = dict(DARGS, rescaled_num_steps=student1.rescaled_num_steps,
                 timestep_indices=student1.timestep_map.numpy())
    teacher2 = teacher_diffusion(args2)
    np.testing.assert_array_equal(teacher2.timestep_map.numpy(), student1.timestep_map.numpy())
    wrong = teacher_diffusion(dict(DARGS, rescaled_num_steps=student1.rescaled_num_steps))
    assert not np.array_equal(wrong.timestep_map.numpy(), student1.timestep_map.numpy())
    student2 = td.make_student_diffusion(None, args2, teacher2)
    np.testing.assert_array_equal(student2.timestep_map.numpy(),
                                  student1.timestep_map.numpy()[1::2])


def test_guided_distill_requires_conditional_model():
    with pytest.raises(AssertionError):
        td.GuidedDistiller(model=DiffusionModel(**TINY, device="cpu"), teacher_params=None,
                           diffusion_args=DARGS, dataloader=iter(()), iterations=1,
                           guidance_strength=0.8)


@pytest.mark.parametrize("space,cfg,dargs,var_weight", [
    ("eps", TINY_COND, DARGS, None), ("x0_snr", TINY_COND, DARGS, None),
    ("eps", TINY_LV, DARGS_LV, 1.0)], ids=["eps", "x0_snr", "eps_var"])
def test_guided_distill_zero_strength_loss_is_zero(space, cfg, dargs, var_weight):
    """At w = 0 the guided teacher is the conditional single forward and the
    student starts as the teacher: the first loss is 0."""
    _, params, batch, labels = jax_setup(cfg)
    pdist = port_pair("guided", cfg, params, dargs, guidance_strength=0.0, loss_space=space,
                      var_weight=var_weight)
    metrics = pdist.train_step(batch, labels)
    assert metrics["loss"].item() < 1e-8


def test_progressive_var_half_trains_only_with_var_weight():
    """Without var_weight the halving loss gives the variance half of the
    output conv no gradient (weight decay 0: it stays bit-equal); with it
    the VLB term trains it."""
    _, params, batch, labels = jax_setup(TINY_LV, seed=1)
    k0 = flax_params_to_torch_state_dict(params)["out.2.weight"]
    half = k0.shape[0] // 2

    def one_step(var_weight):
        pdist = port_pair("progressive", TINY_LV, params, DARGS_LV, var_weight=var_weight)
        pdist.train_step(batch, labels)
        return pdist.model.out[2].weight.detach().numpy()

    k_no, k_var = one_step(None), one_step(1.0)
    assert np.abs(k_no[:half] - k0[:half]).max() > 0
    np.testing.assert_array_equal(k_no[half:], k0[half:])
    assert np.abs(k_var[half:] - k0[half:]).max() > 0


@pytest.mark.parametrize("kind", ["guided", "progressive"])
def test_var_weight_zero_is_off(kind):
    """A divergence from the JAX package, where 0 counts as on (it gates on
    ``is not None``): here 0 is normalised to None, the term is not made,
    and the step is the one without it, bit for bit."""
    _, params, batch, labels = jax_setup(TINY_LV)
    kw = dict(guidance_strength=0.8) if kind == "guided" else {}
    runs = {}
    for vw in (0.0, None):
        pdist = port_pair(kind, TINY_LV, params, DARGS_LV, var_weight=vw, **kw)
        assert pdist.var_weight is None
        metrics = pdist.train_step(batch, labels, j=np.arange(BATCH),
                                   noise=np.ones(batch.shape, np.float32))
        assert metrics["loss_var"].item() == 0.0
        runs[vw] = {k: v.clone() for k, v in pdist.model.state_dict().items()}
    for k in runs[None]:
        torch.testing.assert_close(runs[0.0][k], runs[None][k], rtol=0, atol=0)


def test_guided_student_inherits_sampler_and_progressive_is_ddim():
    _, params, _, _ = jax_setup(TINY_COND)
    gd = port_pair("guided", TINY_COND, params, DARGS, guidance_strength=0.8)
    assert gd.student.sampler == "ddpm" and gd.student.guidance is None
    assert gd.teacher.guidance == "classifier_free" and gd.teacher.strength == 0.8
    assert gd.student.rescaled_num_steps == gd.teacher.rescaled_num_steps
    assert gd.loss_space == "eps"
    assert not any(p.requires_grad for p in gd.teacher_model.parameters())
    assert not gd.model.training and not gd.teacher_model.training
    pd = port_pair("progressive", TINY_COND, params, DARGS)
    assert pd.student.sampler == "ddim" and pd.loss_space == "x0_snr"
