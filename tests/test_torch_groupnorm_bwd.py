"""K3's backward (fused GroupNorm(+AdaGN)(+SiLU)) against the JAX package's, on the CPU.

``group_norm_fused_bwd_plain`` is the closed form the CUDA backward kernel is
held to on the card. Here it is held against ``jax.vjp`` of the JAX package's
custom VJP (``_fused_gn``: the Pallas forward in interpret mode, the jnp
recompute under the VJP) and against torch autograd through the plain
forward, for the three modes (GN, GN+SiLU, AdaGN+SiLU), f32, each output to
1e-5 of its largest element. On CPU tensors the autograd Function runs the
plain versions; these tests also pin what it saves and hands over (the
forward's group mean and rstd), ``needs_input_grad`` and the single unpack
of its saved tensors under ``torch.utils.checkpoint``. Inputs come from
numpy with a fixed seed and go through both.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.ops.groupnorm import _fused_gn  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402

REL = 1e-5  # of each output's largest element, f32
MODES = {"plain": (False, False), "silu": (True, False), "ada": (True, True)}  # (silu, ada)
# (B, H, W, C): C/G = 3, and a ragged map with C/G = 2 (EMNIST's 64 channels)
SHAPES = [(2, 8, 8, 96), (2, 7, 5, 64)]
# GroupNorm calls of one forward, distinct (H, W, C, mode) keys, as
# chip_smoke.main_path_calls finds them; tests/test_torch_kernels.py runs K3
# on the card at each of them by index
MODEL_GN_KEYS = {"openai_64": 30, "openai_128": 33, "classifier": 19, "EMNIST": 21}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, shape, ada):
    b, h, w, c = shape
    arrays = [rng.normal(loc=0.5, scale=2.0, size=shape).astype(np.float32),
              rng.normal(size=(c,)).astype(np.float32), rng.normal(size=(c,)).astype(np.float32)]
    if ada:
        arrays += [(0.3 * rng.normal(size=(b, c))).astype(np.float32) for _ in range(2)]
    g = rng.normal(size=shape).astype(np.float32)
    return arrays, g


def _close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= REL * scale, f"{what}: max abs err {err:.3g} over {REL} x {scale:.3g}"


def _plain_bwd(arrays, g, silu, ada):
    x, sc, bi, *emb = (_t(a) for a in arrays)
    es, eb = emb if ada else (None, None)
    grads = k3.group_norm_fused_bwd_plain(x, sc, bi, es, eb, _t(g), silu=silu)
    return grads if ada else grads[:3]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_bwd_plain_matches_jax_custom_vjp(rng_np, monkeypatch, mode, shape):
    """dx, dscale, dbias (and d(es), d(eb)) == jax.vjp of the JAX package's
    fused GroupNorm (the Pallas kernel in interpret mode, its custom VJP)."""
    silu, ada = MODES[mode]
    arrays, g = _case(rng_np, shape, ada)
    monkeypatch.setenv("NICEDIFFUSION_PALLAS_INTERPRET", "1")
    out, vjp = jax.vjp(_fused_gn(32, 1e-5, silu, ada, True), *map(jnp.asarray, arrays))
    refs = vjp(jnp.asarray(g))
    x, sc, bi, *emb = (_t(a) for a in arrays)
    plain = k3.group_norm_fused_plain(x, sc, bi, *emb, silu=silu)
    np.testing.assert_allclose(plain.numpy(), np.asarray(out), atol=1e-5)
    got = _plain_bwd(arrays, g, silu, ada)
    assert len(got) == len(refs)
    for name, a, r in zip(("dx", "dscale", "dbias", "demb_scale", "demb_shift"), got, refs):
        _close(a, r, f"{mode} {shape} {name}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_bwd_plain_matches_autograd_of_the_plain_forward(rng_np, mode, shape):
    silu, ada = MODES[mode]
    arrays, g = _case(rng_np, shape, ada)
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    refs = torch.autograd.grad(k3.group_norm_fused_plain(*leaves, silu=silu), leaves, _t(g))
    for name, a, r in zip(("dx", "dscale", "dbias", "demb_scale", "demb_shift"),
                          _plain_bwd(arrays, g, silu, ada), refs):
        _close(a, r.numpy(), f"{mode} {shape} {name}")


@pytest.mark.parametrize("mode", list(MODES))
def test_function_saves_the_group_stats_and_matches_the_plain_bwd(rng_np, mode):
    """The autograd Function saves the forward's (B, G) f32 mean and rstd,
    equal to group_stats' mean and rsqrt(var + eps), and its backward is the
    plain closed form on a CPU tensor (no launch counted)."""
    silu, ada = MODES[mode]
    arrays, g = _case(rng_np, (2, 7, 5, 64), ada)
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    before = k3.group_norm_fused.launches, k3.group_norm_fused_bwd.launches
    out = k3.group_norm_fused(*leaves, silu=silu)
    saved = out.grad_fn.saved_tensors
    _, mean, var = k3.group_stats(_t(arrays[0]), 32)
    assert saved[5].shape == saved[6].shape == (2, 32)
    assert saved[5].dtype == saved[6].dtype == torch.float32
    assert torch.equal(saved[5], mean.reshape(2, 32))
    assert torch.equal(saved[6], torch.rsqrt(var + 1e-5).reshape(2, 32))
    grads = torch.autograd.grad(out, leaves, _t(g))
    for a, r in zip(grads, _plain_bwd(arrays, g, silu, ada)):
        assert torch.equal(a, r)
    assert (k3.group_norm_fused.launches, k3.group_norm_fused_bwd.launches) == before


@pytest.mark.parametrize("wanted", [(0,), (1, 2), (3,), (0, 4)], ids=["x", "affine", "es", "x_eb"])
def test_function_honours_needs_input_grad(rng_np, wanted):
    """Only the inputs that want a gradient get one, each equal to the
    plain closed form's."""
    arrays, g = _case(rng_np, (2, 8, 8, 96), True)
    inputs = [_t(a).requires_grad_(i in wanted) for i, a in enumerate(arrays)]
    out = k3.group_norm_fused(*inputs)
    grads = torch.autograd.grad(out, [inputs[i] for i in wanted], _t(g))
    refs = _plain_bwd(arrays, g, True, True)
    for i, got in zip(wanted, grads):
        assert torch.equal(got, refs[i])
    seen = []
    real = k3.group_norm_fused_bwd

    def spy(*a, **k):
        res = real(*a, **k)
        seen.append(res)
        return res

    k3.group_norm_fused_bwd = spy
    try:
        torch.autograd.grad(k3.group_norm_fused(*inputs), [inputs[i] for i in wanted], _t(g))
    finally:
        k3.group_norm_fused_bwd = real
    (res,) = seen
    assert [i for i, t in enumerate(res) if t is not None] == list(wanted)


@pytest.mark.parametrize("mode", list(MODES))
def test_function_under_checkpoint_unpacks_its_saved_tensors_once(rng_np, mode):
    """Under non-reentrant torch.utils.checkpoint (the model's remat) a
    second unpack of a saved tensor raises; the backward reads them once and
    gives the gradients of the plain run."""
    silu, ada = MODES[mode]
    arrays, g = _case(rng_np, (2, 8, 8, 96), ada)

    def block(*t):
        return 2.0 * k3.group_norm_fused(*t, silu=silu)

    leaves = [_t(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(checkpoint(block, *leaves, use_reentrant=False), leaves, _t(g))
    ref = torch.autograd.grad(block(*leaves), leaves, _t(g))
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_bwd_returns_each_gradient_in_its_inputs_dtype(rng_np):
    """bf16 x and modulation rows with f32 parameters: dx and the rows'
    gradients bf16, the parameters' f32; the cotangent is cast to x's dtype
    first (as the JAX VJP casts it)."""
    arrays, g = _case(rng_np, (2, 4, 4, 64), True)
    x, sc, bi, es, eb = (_t(a) for a in arrays)
    x, es, eb = x.bfloat16(), es.bfloat16(), eb.bfloat16()
    got = k3.group_norm_fused_bwd(x, sc, bi, es, eb, _t(g))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    ref = k3.group_norm_fused_bwd_plain(x, sc, bi, es, eb, _t(g).bfloat16())
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert k3.group_norm_fused_bwd(x, sc, bi, es, eb, _t(g), needs=(1, 0, 0, 0, 1))[1:4] == (
        None, None, None)


def test_bwd_refuses_other_devices():
    meta = torch.empty(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3.group_norm_fused_bwd(meta, torch.empty(32, device="meta"),
                                torch.empty(32, device="meta"), None, None, meta)


@pytest.mark.parametrize("preset", list(MODEL_GN_KEYS))
def test_model_groupnorm_keys_are_pinned(preset):
    """The GroupNorm shapes the card tests index: chip_smoke.main_path_calls
    on a meta-device model (shapes only)."""
    from chip_smoke import classifier_config, main_path_calls, model_config
    from nicediffusion_tpu_torch import DiffusionModel, EncoderUNet

    meta = torch.device("meta")
    if preset == "classifier":
        model = EncoderUNet(**classifier_config(), kernels=False, device=meta)
    else:
        model = DiffusionModel(**model_config(preset), kernels=False, device=meta)
    keys = [k for k in main_path_calls(model.eval(), meta) if k[0] == "groupnorm"]
    assert len(keys) == MODEL_GN_KEYS[preset]
    assert all(c % 32 == 0 for _, (_, _, c), _ in keys)
