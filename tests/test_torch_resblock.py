"""K4's plain torch version against the JAX package's fused GN+SiLU+conv, on the CPU.

The same numpy-made inputs (the three shapes of tests/test_pallas_resblock.py,
plain and AdaGN, and two of the UNet's real widths at batch 1) go through
``gn_silu_conv3x3`` in Pallas interpret mode,
through ``gn_silu_conv3x3_reference`` and, with the HWIO kernel turned to
torch's OIHW by the port's converter, through the port's
``gn_silu_conv3x3_plain`` and its public wrapper, which takes the plain
version for a CPU tensor. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels.py, chip_smoke.py), at the
residual-block halves ``chip_smoke.resblock_halves`` finds; the last test
pins what it finds.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.ops.pallas.resblock import (  # noqa: E402
    gn_silu_conv3x3 as jax_fused,
    gn_silu_conv3x3_reference as jax_reference,
)
from nicediffusion_tpu_torch.ops.kernels import resblock as k4  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import gn_silu_conv3x3_args_to_torch  # noqa: E402

SHAPES = [((2, 8, 8, 32), 64, 8), ((1, 16, 16, 64), 32, 32), ((3, 4, 4, 96), 96, 32)]


def _inputs(shape, f, ada, seed=0, dtype=np.float32, w_scale=0.05):
    rng = np.random.default_rng(seed)
    b, _, _, c = shape
    x = rng.normal(size=shape).astype(dtype)
    gamma = (rng.normal(size=(c,)) * 0.2 + 1).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, c, f)) * w_scale).astype(dtype)
    bias = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    es = eb = None
    if ada:
        es = (rng.normal(size=(b, c)) * 0.3).astype(dtype)
        eb = (rng.normal(size=(b, c)) * 0.3).astype(dtype)
    return x, gamma, beta, kernel, bias, es, eb


def _torch_args(*arrays):
    return [torch.from_numpy(a) for a in gn_silu_conv3x3_args_to_torch(*arrays)]


@pytest.mark.parametrize("ada", [False, True], ids=["plain", "ada"])
@pytest.mark.parametrize("shape,f,groups", SHAPES, ids=["8x8x32", "16x16x64", "4x4x96"])
def test_plain_version_matches_the_pallas_kernel_and_its_reference(shape, f, groups, ada):
    x, gamma, beta, kernel, bias, es, eb = _inputs(shape, f, ada, seed=f)
    fused = jax_fused(x, gamma, beta, kernel, bias, es=es, eb=eb, num_groups=groups,
                      interpret=True)
    ref = jax_reference(jnp.asarray(x), gamma, beta, es, eb, jnp.asarray(kernel), bias,
                        num_groups=groups, ada=ada)
    args = _torch_args(x, gamma, beta, kernel, bias, es, eb)
    assert args[3].shape == (f, shape[-1], 3, 3)
    plain = k4.gn_silu_conv3x3_plain(*args, num_groups=groups)
    before = k4.gn_silu_conv3x3.launches
    out = k4.gn_silu_conv3x3(*args, num_groups=groups)  # a CPU tensor: the plain version
    assert k4.gn_silu_conv3x3.launches == before and torch.equal(out, plain)
    assert out.shape == shape[:3] + (f,) and out.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), np.asarray(fused), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("ada", [False, True], ids=["plain", "ada"])
@pytest.mark.parametrize("shape,f", [((1, 8, 8, 1536), 768), ((1, 16, 16, 576), 576)],
                         ids=["8x8x1536-768", "16x16x576-576"])
def test_plain_version_matches_the_pallas_kernel_at_unet_widths(shape, f, ada):
    """The UNet's widest 8x8 input (C/G = 48) and a 16x16 level's width,
    32 groups, the weights scaled by their fan-in as the model's are (outputs
    of order 1): the same 2e-5 gate as the small shapes, over sums of 9 C =
    13,824 and 5,184 f32 products."""
    x, gamma, beta, kernel, bias, es, eb = _inputs(
        shape, f, ada, seed=shape[-1] + f, w_scale=1 / math.sqrt(9 * shape[-1]))
    fused = jax_fused(x, gamma, beta, kernel, bias, es=es, eb=eb, num_groups=32,
                      interpret=True)
    plain = k4.gn_silu_conv3x3_plain(*_torch_args(x, gamma, beta, kernel, bias, es, eb))
    np.testing.assert_allclose(plain.numpy(), np.asarray(fused), atol=2e-5, rtol=2e-5)


def test_padding_is_zero_after_the_activation():
    """A border output sees literal zeros outside the image, not
    SiLU(GN(0)): with a large GroupNorm bias the two differ by far."""
    x, gamma, beta, kernel, bias, _, _ = _inputs((1, 4, 4, 32), 8, False, seed=2)
    beta = beta + 3.0
    args = _torch_args(x, gamma, beta, kernel, bias)
    out = k4.gn_silu_conv3x3_plain(*args, num_groups=8)
    fused = jax_fused(x, gamma, beta, kernel, bias, num_groups=8, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(fused), atol=2e-5, rtol=2e-5)
    # the wrong answer: a halo of SiLU(3.0), about what SiLU(GN(0)) would give here
    from nicediffusion_tpu_torch.ops.kernels.groupnorm import group_norm_fused_plain

    h = group_norm_fused_plain(args[0], args[1], args[2], num_groups=8)
    padded = torch.nn.functional.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), value=float(
        torch.nn.functional.silu(torch.tensor(3.0))))
    wrong = torch.nn.functional.conv2d(padded, args[3], args[4]).permute(0, 2, 3, 1)
    assert (wrong - out).abs().max() > 0.1
    torch.testing.assert_close(wrong[:, 1:-1, 1:-1], out[:, 1:-1, 1:-1], atol=1e-5, rtol=1e-5)


def test_bf16_rounds_where_the_kernel_rounds():
    """bf16 inputs: the activation and the weight are rounded to bf16 before
    the products, sums and bias are f32, the output is rounded once."""
    import ml_dtypes

    x, gamma, beta, kernel, bias, es, eb = _inputs((2, 8, 8, 32), 64, True, seed=4)
    x, kernel, es, eb = (a.astype(ml_dtypes.bfloat16) for a in (x, kernel, es, eb))
    fused = jax_fused(jnp.asarray(x), gamma, beta, jnp.asarray(kernel), bias, es=jnp.asarray(es),
                      eb=jnp.asarray(eb), num_groups=8, interpret=True)
    as_torch = [torch.from_numpy(np.asarray(a, np.float32)) for a in
                gn_silu_conv3x3_args_to_torch(x, gamma, beta, kernel, bias, es, eb)]
    args = [t.bfloat16() if i in (0, 3, 5, 6) else t for i, t in enumerate(as_torch)]
    out = k4.gn_silu_conv3x3_plain(*args, num_groups=8)
    assert out.dtype == torch.bfloat16
    # one bf16 ulp of an output in [2, 4) is 0.0156
    np.testing.assert_allclose(out.float().numpy(), np.asarray(fused, np.float32),
                               atol=3e-2, rtol=1e-2)


def test_gradients_match_the_jax_custom_vjp():
    """The autograd Function (whose backward differentiates the plain
    version) against ``jax.grad`` through the Pallas op's custom VJP, for x
    and the kernel (tests/test_pallas_resblock.py:53-80), and for every
    other input against autograd through the plain version."""
    b, h, w, c, f = 2, 8, 8, 32, 32
    x, _, _, kernel, _, _, _ = _inputs((b, h, w, c), f, False, seed=8)
    gamma, beta = np.ones((c,), np.float32), np.zeros((c,), np.float32)
    bias = np.zeros((f,), np.float32)

    def loss_fused(x, kernel):
        return jnp.sum(jax_fused(x, gamma, beta, kernel, bias, num_groups=8, interpret=True) ** 2)

    gx, gk = jax.grad(loss_fused, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kernel))
    args = [t.requires_grad_(True) for t in _torch_args(x, gamma, beta, kernel, bias)]
    out = k4.gn_silu_conv3x3(*args, num_groups=8)
    assert type(out.grad_fn).__name__ == "_GNSiLUConv3x3Backward"
    grads = torch.autograd.grad((out ** 2).sum(), args)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(grads[3].permute(2, 3, 1, 0).numpy(), np.asarray(gk),
                               atol=1e-4, rtol=0)
    ref = torch.autograd.grad((k4.gn_silu_conv3x3_plain(*args, num_groups=8) ** 2).sum(), args)
    for a, r in zip(grads, ref):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_ada_gradients_reach_the_modulation_rows_only_where_wanted():
    x, gamma, beta, kernel, bias, es, eb = _inputs((2, 4, 4, 32), 16, True, seed=9)
    args = _torch_args(x, gamma, beta, kernel, bias, es, eb)
    args[5].requires_grad_(True)
    out = k4.gn_silu_conv3x3(*args, num_groups=8)
    out.sum().backward()
    assert args[5].grad is not None and args[5].grad.abs().sum() > 0
    assert all(a.grad is None for i, a in enumerate(args) if i != 5)
    with torch.no_grad():
        assert k4.gn_silu_conv3x3(*args, num_groups=8).grad_fn is None


def test_weight_repack_is_cached_per_version():
    w = torch.randn(8, 4, 3, 3)
    packed = k4.pack_conv3x3_weight(w, torch.float32)
    assert packed.shape == (3, 3, 4, 8) and packed.is_contiguous()
    assert torch.equal(packed, w.permute(2, 3, 1, 0))
    assert k4.pack_conv3x3_weight(w, torch.float32) is packed
    assert k4.pack_conv3x3_weight(w, torch.bfloat16).dtype == torch.bfloat16
    w.add_(1.0)
    again = k4.pack_conv3x3_weight(w, torch.float32)
    assert again is not packed and torch.equal(again, w.permute(2, 3, 1, 0))
    with torch.inference_mode():
        wi = torch.randn(8, 4, 3, 3)
        assert torch.equal(k4.pack_conv3x3_weight(wi, torch.float32), wi.permute(2, 3, 1, 0))


def test_refuses_a_device_that_is_neither_cpu_nor_cuda():
    args = [t.to("meta") for t in _torch_args(*_inputs((1, 4, 4, 32), 8, False)[:5])]
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        k4.gn_silu_conv3x3(*args, num_groups=8)


@pytest.mark.parametrize("preset,batch,keys,halves,tflop", [
    ("openai_64", 16, 27, 66, 2.596), ("openai_128", 4, 30, 62, 1.984),
])
def test_resblock_halves_of_the_unets(preset, batch, keys, halves, tflop):
    """What chip_smoke.py's K4 yardstick sums over, and what the card tests
    index: the residual-block halves of one forward of each UNet (the model
    built on the meta device, shapes only), their (H, C, F, ada) keys and the
    products' operations, 2 * 9 * C * F a pixel, at the path's batch."""
    from chip_smoke import resblock_halves
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    model = DiffusionModel(**MODEL_PRESETS[preset], kernels=False, device="meta").eval()
    found = resblock_halves(model, torch.device("meta"))
    assert len(found) == keys and sum(found.values()) == halves
    ops = sum(n * 2 * 9 * c * f * batch * h * h for (h, c, f, _), n in found.items())
    assert round(ops / 1e12, 3) == tflop
    assert {k[1] % 64 for k in found} == {0}  # every C a whole number of 64-channel steps
