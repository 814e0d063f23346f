"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both. GroupNorm and
attention are held against the plain JAX op and against the Pallas kernel in
interpret mode; on CPU tensors the port's kernel wrappers take their plain
torch versions, so these tests pin the arithmetic the CUDA kernels are
compared with on the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.ops import groupnorm as jgn  # noqa: E402
from nicediffusion_tpu.ops import math as jmath  # noqa: E402
from nicediffusion_tpu.ops import resize as jresize  # noqa: E402
from nicediffusion_tpu.ops.attention import qkv_attention as jax_attention  # noqa: E402
from nicediffusion_tpu.ops.pallas.attention import (  # noqa: E402
    mha_attention,
    mha_attention_fused_qkv,
)
from nicediffusion_tpu.ops.pallas.groupnorm import group_norm_fused as pallas_gn  # noqa: E402
from nicediffusion_tpu_torch.ops import groupnorm as tgn  # noqa: E402
from nicediffusion_tpu_torch.ops import math as tmath  # noqa: E402
from nicediffusion_tpu_torch.ops import resize as tresize  # noqa: E402
from nicediffusion_tpu_torch.ops.attention import qkv_attention  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import attention as k1  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gn_inputs(rng, shape):
    h, w, c = shape
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    sc = rng.normal(size=(c,)).astype(np.float32)
    bi = rng.normal(size=(c,)).astype(np.float32)
    es = (0.1 * rng.normal(size=(2, c))).astype(np.float32)
    eh = (0.1 * rng.normal(size=(2, c))).astype(np.float32)
    return x, sc, bi, es, eh


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("shape", [(7, 7, 64), (8, 8, 96), (16, 16, 192)])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
def test_groupnorm_matches_jax_op(rng_np, shape, mode, kernels):
    """Both dispatch targets of the port's GN ops == the JAX plain ops,
    including a padded token count (7x7) and C/G of 2, 3 and 6."""
    x, sc, bi, es, eh = _gn_inputs(rng_np, shape)
    if mode == "plain":
        ref = jgn.group_norm(x, sc, bi)
        out = tgn.group_norm(_t(x), _t(sc), _t(bi), kernels=kernels)
    elif mode == "silu":
        ref = jgn.group_norm_silu(x, sc, bi)
        out = tgn.group_norm_silu(_t(x), _t(sc), _t(bi), kernels=kernels)
    else:
        ref = jgn.ada_group_norm_silu(x, sc, bi, es, eh)
        out = tgn.ada_group_norm_silu(
            _t(x), _t(sc), _t(bi), _t(es), _t(eh), kernels=kernels
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shape", [(7, 7, 64), (8, 8, 96)])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
def test_groupnorm_kernel_plain_matches_pallas(rng_np, shape, mode):
    """K3's plain version == the Pallas kernel it replaces (interpret mode)."""
    x, sc, bi, es, eh = _gn_inputs(rng_np, shape)
    ada = mode == "ada"
    silu = mode != "plain"
    ref = pallas_gn(
        x, sc, bi, es if ada else None, eh if ada else None,
        silu=silu, interpret=True,
    )
    out = k3.group_norm_fused_plain(
        _t(x), _t(sc), _t(bi), _t(es) if ada else None, _t(eh) if ada else None,
        silu=silu,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_groupnorm_rejects_indivisible_channels():
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError, match="not divisible by num_groups"):
        tgn.group_norm_silu(x, torch.ones(16), torch.zeros(16))


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n", [49, 64, 256])
@pytest.mark.parametrize("hc", [32, 64])
def test_attention_matches_jax(rng_np, split_first, n, hc):
    """The port's attention (both dispatch targets) == the JAX einsum op
    and the Pallas fused-qkv kernel in interpret mode, both layouts, ragged
    and aligned N."""
    heads = 3
    qkv = rng_np.normal(size=(2, n, 3 * heads * hc)).astype(np.float32)
    ref = np.asarray(jax_attention(qkv, heads, split_first, use_pallas=False))
    pallas = np.asarray(mha_attention_fused_qkv(qkv, heads, split_first, interpret=True))
    for kernels in (False, True):
        out = qkv_attention(_t(qkv), heads, split_first, kernels=kernels).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5)
        np.testing.assert_allclose(out, pallas, atol=2e-5)


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n", [49, 65, 256])
@pytest.mark.parametrize("hc", [32, 64, 128])
def test_attention_bf16_matches_jax(rng_np, hc, n, split_first):
    """bf16: f32 logits and softmax, p cast to bf16 before the product. The
    port's op and K1's plain version (what the card holds the tensor-core
    kernel to) against the plain JAX op and the Pallas fused-qkv kernel in
    interpret mode, ragged N (one and two key tiles past a multiple of 64)
    and whole tiles, both layouts. K1's plain version rounds the normalised
    p, as JAX does; the kernel rounds the unnormalised one (the bf16 gate
    covers the difference)."""
    heads = 2
    qkv = rng_np.normal(size=(2, n, 3 * heads * hc)).astype(np.float32)
    qkv_bf16 = jnp.asarray(qkv, jnp.bfloat16)
    refs = [
        np.asarray(jax_attention(qkv_bf16, heads, split_first, use_pallas=False), np.float32),
        np.asarray(mha_attention_fused_qkv(qkv_bf16, heads, split_first, interpret=True),
                   np.float32),
    ]
    outs = [qkv_attention(_t(qkv).bfloat16(), heads, split_first),
            k1.fused_qkv_attention_plain(_t(qkv).bfloat16(), heads, split_first)]
    for out in outs:
        assert out.dtype == torch.bfloat16 and out.shape == (2, n, heads * hc)
        for ref in refs:
            np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2)


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("hc", [192, 256])
def test_attention_wide_heads_match_pallas(rng_np, split_first, hc):
    """K1's plain version at openai_128's head dims 192 and 256 == the
    Pallas fused-qkv kernel in interpret mode and the JAX einsum op."""
    heads, n = 2, 65
    qkv = rng_np.normal(size=(2, n, 3 * heads * hc)).astype(np.float32)
    ref = np.asarray(jax_attention(qkv, heads, split_first, use_pallas=False))
    pallas = np.asarray(mha_attention_fused_qkv(qkv, heads, split_first, interpret=True))
    out = k1.fused_qkv_attention(_t(qkv), heads, split_first).numpy()
    np.testing.assert_allclose(out, pallas, atol=2e-5)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("n,d,h", [(64, 64, 4), (49, 16, 2), (256, 64, 6), (65, 192, 2)])
def test_mha_attention_plain_matches_pallas(rng_np, n, d, h):
    """K5's plain version (and its wrapper, which takes it on CPU tensors)
    == the Pallas kernel it replaces in interpret mode, at the (n, d, h) of
    tests/test_pallas.py plus D = 192; strided views of a fused projection
    give the same as contiguous copies."""
    q, k, v = (rng_np.normal(size=(2, h, n, d)).astype(np.float32) for _ in range(3))
    ref = np.asarray(mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   interpret=True))
    k1.mha_attention.launches = 0
    out = k1.mha_attention(_t(q), _t(k), _t(v))
    assert torch.equal(out, k1.mha_attention_plain(_t(q), _t(k), _t(v)))
    assert k1.mha_attention.launches == 0 and out.shape == (2, h, n, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    qkv = _t(rng_np.normal(size=(2, n, 3 * h * d)).astype(np.float32))
    views = k1.split_qkv(qkv, h, False)
    assert not views[0].is_contiguous()
    fused = k1.fused_qkv_attention_plain(qkv, h, False)
    np.testing.assert_allclose(
        k1.mha_attention(*views).transpose(1, 2).reshape(2, n, h * d).numpy(),
        fused.numpy(), atol=2e-5)


def test_mha_attention_bf16_matches_pallas(rng_np):
    """bf16: f32 logits and softmax, p cast to bf16 before the product."""
    q, k, v = (jnp.asarray(rng_np.normal(size=(2, 2, 64, 64)).astype(np.float32))
               .astype(jnp.bfloat16) for _ in range(3))
    ref = np.asarray(mha_attention(q, k, v, interpret=True), np.float32)
    out = k1.mha_attention(*(_t(np.asarray(a, np.float32)).bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2)


def test_mha_attention_refuses_mismatched_inputs():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="one shape"):
        k1.mha_attention(q, q, torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="one dtype"):
        k1.mha_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        k1.mha_attention(*(torch.empty(1, 2, 8, 16, device="meta"),) * 3)


def test_timestep_embedding_matches_jax():
    """[cos|sin] order. XLA's and torch's f32 exp differ by 1 ulp on some
    frequencies, which t up to 999 turns into ~4e-6 on the angle: hence 1e-5."""
    t = np.array([0, 1, 17, 500, 643, 999], np.int32)
    for dim in (64, 65, 192):
        ref = np.asarray(jmath.timestep_embedding(jnp.asarray(t), dim))
        out = tmath.timestep_embedding(_t(t), dim).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_gaussian_helpers_match_jax(rng_np):
    m1, m2 = rng_np.normal(size=(2, 4, 4, 3)).astype(np.float32)
    v1, v2 = (0.5 * rng_np.normal(size=(2, 4, 4, 3))).astype(np.float32)
    target = np.clip(rng_np.normal(size=(4, 4, 3)), -1, 1).astype(np.float32)
    target[0, 0] = -1.0
    target[0, 1] = 1.0
    # the bin log-likelihood takes the log of a difference of two close
    # tanh CDFs, which cancels: 1e-4 relative there, 1e-6 elsewhere
    cases = [
        (jmath.kl_div(m1, v1, m2, v2),
         tmath.kl_div(_t(m1), _t(v1), _t(m2), _t(v2)), 1e-6),
        (jmath.discretized_gaussian_log_likelihood(target, m1, v1),
         tmath.discretized_gaussian_log_likelihood(_t(target), _t(m1), _t(v1)), 1e-4),
        (jmath.mean_flat(m1), tmath.mean_flat(_t(m1)), 1e-6),
    ]
    for ref, out, rtol in cases:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=rtol)


def test_resize_matches_jax(rng_np):
    x = rng_np.normal(size=(2, 6, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tresize.upsample_nearest_2x(_t(x)).numpy(),
        np.asarray(jresize.upsample_nearest_2x(x)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tresize.avg_pool_2x(_t(x)).numpy(),
        np.asarray(jresize.avg_pool_2x(x)), atol=1e-6,
    )


def test_kernel_wrappers_on_cpu_take_the_plain_version(rng_np):
    """On CPU tensors neither wrapper launches anything: the counters stay
    0 and the result is the plain version's, bit for bit."""
    k1.fused_qkv_attention.launches = 0
    k3.group_norm_fused.launches = 0
    qkv = _t(rng_np.normal(size=(2, 49, 3 * 64)).astype(np.float32))
    assert torch.equal(
        k1.fused_qkv_attention(qkv, 2, False),
        k1.fused_qkv_attention_plain(qkv, 2, False),
    )
    x, sc, bi, es, eh = (_t(a) for a in _gn_inputs(rng_np, (4, 4, 64)))
    assert torch.equal(
        k3.group_norm_fused(x, sc, bi, es, eh),
        k3.group_norm_fused_plain(x, sc, bi, es, eh),
    )
    assert k1.fused_qkv_attention.launches == 0
    assert k3.group_norm_fused.launches == 0


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is refused, not run plain."""
    with pytest.raises(ValueError, match="CUDA"):
        k1.fused_qkv_attention(torch.empty(1, 8, 96, device="meta"), 2, True)
    with pytest.raises(ValueError, match="CUDA"):
        k3.group_norm_fused(
            torch.empty(1, 4, 4, 32, device="meta"),
            torch.empty(32, device="meta"), torch.empty(32, device="meta"),
        )


def test_port_imports_without_jax_or_triton():
    """The package never imports jax, and K3's module imports (and runs
    plain on CPU tensors) where triton is missing: the port needs none."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; "
        "sys.modules['triton'] = None\n"
        "import torch, nicediffusion_tpu_torch\n"
        "from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3\n"
        "x = torch.randn(1, 4, 4, 32)\n"
        "k3.group_norm_fused(x, torch.ones(32), torch.zeros(32))\n"
        "assert not any(m == 'nicediffusion_tpu' or m.startswith('nicediffusion_tpu.')"
        " for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
