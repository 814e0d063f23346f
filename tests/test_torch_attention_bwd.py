"""The port's attention and GroupNorm gradients against the JAX package's, on the CPU.

On CPU tensors the autograd Functions of K1/K2 and K3 run the kernels' plain
versions, so these tests pin the arithmetic the CUDA kernel K2 is compared
with on the card: ``fused_qkv_attention_bwd_plain`` (the backward formulas
written out, no autograd) and the autograd Function against ``jax.grad`` of
the Pallas custom VJP in interpret mode and of the einsum path; and the
GroupNorm Function's recompute backward against ``jax.grad`` of the JAX op.
Inputs come from numpy with a fixed seed and go through both.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.ops import groupnorm as jgn  # noqa: E402
from nicediffusion_tpu.ops.attention import _einsum_attention, _pallas_attention  # noqa: E402
from nicediffusion_tpu_torch.ops import groupnorm as tgn  # noqa: E402
from nicediffusion_tpu_torch.ops.attention import qkv_attention  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import attention as k1  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402

ATOL = 1e-5  # f32, the JAX package's own gate for this backward (tests/test_pallas.py)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attention_case(rng, n, hc, heads=3, batch=2):
    qkv = rng.normal(size=(batch, n, 3 * heads * hc)).astype(np.float32)
    g = rng.uniform(-1, 1, size=(batch, n, heads * hc)).astype(np.float32)
    return qkv, g, heads


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc", [(49, 32), (64, 32), (196, 32), (49, 64)])
def test_bwd_plain_matches_pallas_and_einsum(rng_np, monkeypatch, split_first, n, hc):
    """K2's plain version == the Pallas backward kernel (interpret mode,
    through the custom VJP) == jax.grad of the einsum path, both layouts,
    ragged (49, 196) and aligned N."""
    qkv, g, heads = _attention_case(rng_np, n, hc)
    monkeypatch.setenv("NICEDIFFUSION_PALLAS_INTERPRET", "1")
    out_p, vjp_p = jax.vjp(lambda q: _pallas_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_pallas, = vjp_p(jnp.asarray(g))
    _, vjp_e = jax.vjp(lambda q: _einsum_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_einsum, = vjp_e(jnp.asarray(g))

    o = k1.fused_qkv_attention_plain(_t(qkv), heads, split_first)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_p), atol=2e-5)
    got = k1.fused_qkv_attention_bwd_plain(_t(qkv), _t(g), o, heads, split_first)
    assert got.shape == qkv.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_einsum), atol=ATOL)
    # the wrapper takes the plain version on a CPU tensor and counts no launch
    before = k1.fused_qkv_attention_bwd.launches
    via_wrapper = k1.fused_qkv_attention_bwd(_t(qkv), _t(g), o, heads, split_first)
    assert torch.equal(via_wrapper, got)
    assert k1.fused_qkv_attention_bwd.launches == before


def _jax_lse(qkv, heads, split_first):
    """ln sum_j exp(scale q k_j) of every row, (B, H, N), in JAX."""
    b, n, c3 = qkv.shape
    hc = c3 // 3 // heads
    x = jnp.asarray(qkv).reshape(b, n, 3, heads, hc) if split_first else \
        jnp.asarray(qkv).reshape(b, n, heads, 3, hc).swapaxes(2, 3)
    logits = jnp.einsum("bthc,bshc->bhts", x[:, :, 0], x[:, :, 1]) * hc**-0.5
    return np.asarray(jax.nn.logsumexp(logits, axis=-1))


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc", [(49, 32), (64, 32), (196, 32), (49, 64)])
def test_bwd_plain_takes_lse_and_uses_it(rng_np, monkeypatch, split_first, n, hc):
    """K1's wrapper on a CPU tensor (its plain version) writes the row
    log-sum-exp of JAX's logits;
    K2's plain version given it matches the Pallas backward (interpret mode)
    and jax.grad of the einsum path, and it does use it: a shifted lse
    scales p and moves the gradient."""
    qkv, g, heads = _attention_case(rng_np, n, hc)
    monkeypatch.setenv("NICEDIFFUSION_PALLAS_INTERPRET", "1")
    _, vjp_p = jax.vjp(lambda q: _pallas_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_pallas, = vjp_p(jnp.asarray(g))
    _, vjp_e = jax.vjp(lambda q: _einsum_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_einsum, = vjp_e(jnp.asarray(g))

    lse = torch.empty(2, heads, n)
    o = k1.fused_qkv_attention(_t(qkv), heads, split_first, lse=lse)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(qkv, heads, split_first), atol=ATOL)
    got = k1.fused_qkv_attention_bwd(_t(qkv), _t(g), o, heads, split_first, lse=lse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_einsum), atol=ATOL)
    shifted = k1.fused_qkv_attention_bwd_plain(_t(qkv), _t(g), o, heads, split_first, lse + 1.0)
    assert (shifted - got).abs().max() > 10 * ATOL


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc", [(49, 32), (64, 32), (196, 32), (49, 64)])
def test_function_with_lse_matches_pallas_and_einsum(rng_np, monkeypatch, split_first, n, hc):
    """The autograd Function saves qkv, the output and K1's row
    log-sum-exp (one residual more than the JAX custom VJP) and hands the
    lse to K2: its gradient == the Pallas backward (interpret mode) == the
    einsum path's, at the tolerance of the plain-version test."""
    qkv, g, heads = _attention_case(rng_np, n, hc)
    monkeypatch.setenv("NICEDIFFUSION_PALLAS_INTERPRET", "1")
    _, vjp_p = jax.vjp(lambda q: _pallas_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_pallas, = vjp_p(jnp.asarray(g))
    _, vjp_e = jax.vjp(lambda q: _einsum_attention(q, heads, split_first), jnp.asarray(qkv))
    ref_einsum, = vjp_e(jnp.asarray(g))

    leaf = _t(qkv).requires_grad_(True)
    out = k1.fused_qkv_attention(leaf, heads, split_first)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[2].shape == (2, heads, n)
    np.testing.assert_allclose(saved[2].numpy(), _jax_lse(qkv, heads, split_first), atol=ATOL)
    got, = torch.autograd.grad(out, leaf, _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_einsum), atol=ATOL)


def test_k1_wrapper_writes_lse_and_refuses_a_wrong_one(rng_np):
    """On a CPU tensor the K1 wrapper fills a caller's lse from the plain
    version; a wrong shape or dtype, or an lse under autograd, raises."""
    qkv, g, heads = _attention_case(rng_np, 49, 32)
    lse = torch.full((2, heads, 49), float("nan"))
    out = k1.fused_qkv_attention(_t(qkv), heads, True, lse=lse)
    assert torch.equal(out, k1.fused_qkv_attention_plain(_t(qkv), heads, True))
    np.testing.assert_allclose(lse.numpy(), _jax_lse(qkv, heads, True), atol=ATOL)
    with pytest.raises(ValueError, match="float32 lse"):
        k1.fused_qkv_attention(_t(qkv), heads, True, lse=torch.zeros(2, heads, 48))
    with pytest.raises(ValueError, match="float32 lse"):
        k1.fused_qkv_attention_bwd(_t(qkv), _t(g), out, heads, True, lse=lse.double())
    with pytest.raises(ValueError, match="under autograd"):
        k1.fused_qkv_attention(_t(qkv).requires_grad_(True), heads, True, lse=lse)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("split_first", [True, False])
def test_autograd_function_matches_jax_grad(rng_np, monkeypatch, split_first, kernels):
    """Gradients through ``qkv_attention`` (the autograd Function with
    kernels on, plain autograd with kernels off) == jax.grad through the
    Pallas custom VJP, with the test of tests/test_pallas.py's loss."""
    qkv, _, heads = _attention_case(rng_np, 49, 32)
    monkeypatch.setenv("NICEDIFFUSION_PALLAS_INTERPRET", "1")
    ref = jax.grad(lambda q: jnp.sum(jnp.sin(_pallas_attention(q, heads, split_first))))(
        jnp.asarray(qkv))
    leaf = _t(qkv).requires_grad_(True)
    out = qkv_attention(leaf, heads, split_first, kernels=kernels)
    assert (out.grad_fn is not None) and (
        type(out.grad_fn).__name__ == "_FusedQKVAttentionBackward") == kernels
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=ATOL)


def test_function_saves_nothing_without_a_gradient(rng_np):
    """No gradient wanted, or grad mode off: a plain call, no graph."""
    qkv, _, heads = _attention_case(rng_np, 16, 32)
    assert k1.fused_qkv_attention(_t(qkv), heads, True).grad_fn is None
    with torch.no_grad():
        out = k1.fused_qkv_attention(_t(qkv).requires_grad_(True), heads, True)
    assert out.grad_fn is None and not out.requires_grad


def test_bwd_bf16_rounding_points(rng_np):
    """bf16: p is rounded before p^T g and ds before its two products, sums
    in f32, result in bf16; it tracks the f32 result within bf16's grain."""
    qkv, g, heads = _attention_case(rng_np, 64, 32)
    q16, g16 = _t(qkv).bfloat16(), _t(g).bfloat16()
    o16 = k1.fused_qkv_attention_plain(q16, heads, True)
    got = k1.fused_qkv_attention_bwd_plain(q16, g16, o16, heads, True)
    assert got.dtype == torch.bfloat16
    ref = k1.fused_qkv_attention_bwd_plain(
        q16.float(), g16.float(), o16.float(), heads, True)
    torch.testing.assert_close(got.float(), ref, atol=3e-2, rtol=2e-2)
    monkey = jax.vjp(lambda q: _einsum_attention(q, heads, True),
                     jnp.asarray(qkv, jnp.bfloat16))[1](jnp.asarray(g, jnp.bfloat16))[0]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(monkey, np.float32),
                               atol=3e-2, rtol=2e-2)


def test_bwd_wrapper_writes_into_out(rng_np):
    qkv, g, heads = _attention_case(rng_np, 49, 32)
    o = k1.fused_qkv_attention_plain(_t(qkv), heads, False)
    out = torch.full(qkv.shape, float("nan"))
    res = k1.fused_qkv_attention_bwd(_t(qkv), _t(g), o, heads, False, out=out)
    assert res is out and not torch.isnan(out).any()


# ---------------------------------------------------------------------------
# GroupNorm (K3) under autograd
# ---------------------------------------------------------------------------

def _gn_case(rng, shape=(7, 7, 64)):
    h, w, c = shape
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    sc = rng.normal(size=(c,)).astype(np.float32)
    bi = rng.normal(size=(c,)).astype(np.float32)
    es = (0.1 * rng.normal(size=(2, c))).astype(np.float32)
    eh = (0.1 * rng.normal(size=(2, c))).astype(np.float32)
    g = rng.normal(size=(2, h, w, c)).astype(np.float32)
    return x, sc, bi, es, eh, g


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("shape", [(7, 7, 64), (8, 8, 96)])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
def test_groupnorm_gradients_match_jax(rng_np, mode, shape, kernels):
    """Gradients wrt x, scale, bias (and the AdaGN modulation) == jax.grad
    of the JAX op, for the three modes, through the K3 autograd Function
    (kernels on: recompute of the plain version) and plain autograd."""
    x, sc, bi, es, eh, g = _gn_case(rng_np, shape)
    jfn = {"plain": jgn.group_norm, "silu": jgn.group_norm_silu,
           "ada": jgn.ada_group_norm_silu}[mode]
    tfn = {"plain": tgn.group_norm, "silu": tgn.group_norm_silu,
           "ada": tgn.ada_group_norm_silu}[mode]
    arrays = (x, sc, bi) + ((es, eh) if mode == "ada" else ())
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    refs = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    out = tfn(*leaves, kernels=kernels)
    assert (type(out.grad_fn).__name__ == "_GroupNormFusedBackward") == kernels
    grads = torch.autograd.grad(out, leaves, _t(g))
    # the scale and bias gradients are sums over B*H*W elements and reach
    # ~20, where one f32 ulp is 2e-6: hence the relative part
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=2e-6)


def test_groupnorm_function_partial_gradients(rng_np):
    """Only the inputs that want a gradient get one; the forward value is
    the no-grad forward's."""
    x, sc, bi, es, eh, g = _gn_case(rng_np)
    xt, sct = _t(x).requires_grad_(True), _t(sc)
    out = k3.group_norm_fused(xt, sct, _t(bi), _t(es), _t(eh))
    assert torch.equal(out.detach(), k3.group_norm_fused(_t(x), sct, _t(bi), _t(es), _t(eh)))
    out.backward(_t(g))
    assert xt.grad is not None and sct.grad is None


def test_groupnorm_bf16_cotangent_is_cast(rng_np):
    """bf16 x with f32 parameters: x's gradient is bf16, the parameters' f32."""
    x, sc, bi, _, _, g = _gn_case(rng_np)
    xt = _t(x).bfloat16().requires_grad_(True)
    sct, bit = _t(sc).requires_grad_(True), _t(bi).requires_grad_(True)
    out = k3.group_norm_fused(xt, sct, bit)
    assert out.dtype == torch.bfloat16
    out.backward(_t(g))  # an f32 cotangent is cast to the output's dtype
    assert xt.grad.dtype == torch.bfloat16
    assert sct.grad.dtype == bit.grad.dtype == torch.float32
