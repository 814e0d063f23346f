"""K1 to K5 and the int8 conv (CUDA C++) against their plain torch versions
on the card.

bf16 K1, K2, K4 and K5 run on the tensor cores (wgmma), f32 on the CUDA
cores; K3 and its backward on the CUDA cores in both; the int8 conv on the
tensor cores in s8 (its s32 sums bit-equal to the plain version's), the bf16
conv on them in bf16. ``-k k2`` runs K2's tests, ``-k "k1 or k5 or
attention_function"`` the forward's, ``-k k4`` K4's, ``-k k3`` K3's forward
and backward, ``-k int8`` the int8 conv's, ``-k bf16_conv`` the bf16 conv's,
``-k head_dim`` K1 and K2 at head dims between two builds, ``-k above_256``
K1, K2 and K5 at head dims above 256 (the chunked build: the P-resident
route and the walk), ``-k resident`` the resident route's splits,
``-k winograd`` the Winograd conv's (bf16 on the tensor cores), ``-k graph``
the chain's CUDA graphs (diffusion/graphs.py) against its eager loop, the
classifier-guided chain's among them, and the training steps' graphs
(training/graphs.py: the Trainer's and both distillers') against the eager
step.

Every test here needs an NVIDIA card and is marked ``cuda``; without one it
skips. On a machine with a card run:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

This file imports no JAX, so it runs where only torch is installed;
``--noconftest`` skips tests/conftest.py, which imports jax.
"""

import functools

import numpy as np

import pytest
import torch

from nicediffusion_tpu_torch import DiffusionModel
from nicediffusion_tpu_torch.ops.kernels import attention as k1
from nicediffusion_tpu_torch.ops.kernels import conv as kc
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3
from nicediffusion_tpu_torch.ops.kernels import int8conv as k8
from nicediffusion_tpu_torch.ops.kernels import resblock as k4
from nicediffusion_tpu_torch.ops.kernels import winograd as kw
from nicediffusion_tpu_torch.ops.winograd import transform_weights_3x3

pytestmark = pytest.mark.cuda

# the JAX package's Pallas gates (tests/test_pallas.py); bf16 GN outputs
# reach ~10, where one bf16 ulp is 0.06, hence its rtol (test_pallas.py:206)
TOL = {
    (torch.float32, "k1"): dict(atol=2e-5, rtol=0),
    (torch.bfloat16, "k1"): dict(atol=3e-2, rtol=0),
    (torch.float32, "k3"): dict(atol=1e-5, rtol=0),
    (torch.bfloat16, "k3"): dict(atol=3e-2, rtol=1e-2),
    # K2 with |g| <= 1: K1's f32 gate; bf16 rounds ds once more than K1 rounds p
    (torch.float32, "k2"): dict(atol=2e-5, rtol=0),
    (torch.bfloat16, "k2"): dict(atol=3e-2, rtol=2e-2),
    # K4: the JAX package's gate (tests/test_pallas_resblock.py:49); in bf16 the
    # output is rounded once to bf16, one ulp of which is 0.03 for |out| in [4, 8)
    (torch.float32, "k4"): dict(atol=2e-5, rtol=2e-5),
    (torch.bfloat16, "k4"): dict(atol=3e-2, rtol=1e-2),
}
# bf16 K2 beside its per-element gate, which is about the size of a typical
# gradient element at N = 1024: the relative Frobenius error of each of dq, dk
# and dv in each (example, head), as chip_smoke.py's K2_BF16_REL
K2_BF16_REL = 1e-2
# bf16 K4 beside its per-element gate, whose fixed atol of 3e-2 can hide an
# error in proportion to the output where the outputs are small: the
# relative Frobenius error of each example's output, as chip_smoke.py's
# K4_BF16_REL
K4_BF16_REL = 1e-2
# bf16 K3 and its backward beside the per-element gate, whose atol of 3e-2 can
# hide an error in proportion to the output where the outputs are small: the
# relative Frobenius error of each example's output (of each output of the
# backward, the parameters' gradients as one), as chip_smoke.py's K3_BF16_REL
K3_BF16_REL = 1e-2


def _k2_rel_err(out, ref, heads, split_first):
    """The largest ||out - ref||_F / ||ref||_F over dq, dk and dv of every
    (example, head) of two (B, N, 3C) gradients laid out as their qkv."""
    rels = [torch.linalg.vector_norm(o - r, dim=(2, 3)) / torch.linalg.vector_norm(r, dim=(2, 3))
            for o, r in zip(k1.split_qkv(out.float(), heads, split_first),
                            k1.split_qkv(ref.float(), heads, split_first))]
    return torch.stack(rels).max().item()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [
    (1024, 64, 6), (256, 64, 9), (64, 64, 12), (196, 32, 2), (49, 64, 4), (100, 128, 2),
    # openai_128's head dims 192 and 256, at its N and at ragged N
    (256, 192, 4), (64, 256, 4), (65, 192, 2), (100, 256, 2), (1024, 256, 1),
])
def test_k1_matches_plain(cuda, dtype, split_first, n, hc, heads):
    """Every element written (the output is pre-filled with NaN), ragged N
    included, and equal to the plain version; one count per launch."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(4, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    before = k1.fused_qkv_attention.launches
    out = torch.full((4, n, heads * hc), float("nan"), dtype=dtype, device=cuda)
    assert k1.fused_qkv_attention(qkv, heads, split_first, out=out) is out
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == before + 1
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k1"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,heads", [
    (64, 64, 4), (49, 16, 2), (256, 64, 6), (65, 192, 2), (100, 256, 2), (65, 40, 3),
    (65, 320, 2), (64, 512, 1),
])
def test_k5_matches_plain(cuda, dtype, n, d, heads):
    """K5 on separate contiguous q, k, v and on strided views of a fused
    projection in both layouts, D between two builds included (the columns
    past D are zero-filled in shared memory and never stored: the output is
    pre-filled with NaN); one count per launch; equal to K1 on the views."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    qkv = torch.randn(3, n, 3 * heads * d, generator=g, device=cuda).to(dtype)
    for layout in (True, False, None):
        if layout is None:
            q, k, v = (t.contiguous() for t in k1.split_qkv(qkv, heads, True))
        else:
            q, k, v = k1.split_qkv(qkv, heads, layout)
            assert not q.is_contiguous()
        out = torch.full((3, heads, n, d), float("nan"), dtype=dtype, device=cuda)
        before = k1.mha_attention.launches
        assert k1.mha_attention(q, k, v, out=out) is out
        torch.cuda.synchronize()
        assert k1.mha_attention.launches == before + 1
        assert not torch.isnan(out).any()
        ref = k1.mha_attention_plain(q, k, v)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k1"])
        if layout is not None and d in k1.SUPPORTED_HEAD_DIMS:
            fused = k1.fused_qkv_attention(qkv, heads, layout)
            assert torch.equal(out.transpose(1, 2).reshape(3, n, heads * d), fused)


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n", [49, 64, 65, 100, 196, 256, 1024])
@pytest.mark.parametrize("hc", k1.SUPPORTED_HEAD_DIMS)
def test_k1_bf16_matches_plain(cuda, hc, n, split_first):
    """The bf16 kernel (wgmma on the tensor cores) at every head dim, ragged
    and whole key tiles: every element written (the output is pre-filled
    with NaN) and within the bf16 gate of the plain version."""
    heads = 2
    g = torch.Generator(device=cuda).manual_seed(hc * n)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    out = torch.full((2, n, heads * hc), float("nan"), dtype=torch.bfloat16, device=cuda)
    k1.fused_qkv_attention(qkv, heads, split_first, out=out)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16, "k1"])


@pytest.mark.parametrize("form", ["views", "contiguous", "row_stride_not_16_bytes"])
@pytest.mark.parametrize("d", [16, 20, 64, 256])
def test_k5_bf16_matches_plain(cuda, d, form):
    """bf16 K5 on strided views of a projection, on contiguous copies and on
    views whose row stride is not a multiple of 16 bytes (staged with
    narrower loads), D under and between builds included."""
    heads, n = 3, 100
    g = torch.Generator(device=cuda).manual_seed(d)
    if form == "row_stride_not_16_bytes":
        wide = torch.randn(3, 2, heads, n, d + 3, generator=g, device=cuda).bfloat16()
        q, k, v = wide[..., :d]
        assert q.stride(2) * q.element_size() % 16
    else:
        qkv = torch.randn(2, n, 3 * heads * d, generator=g, device=cuda).bfloat16()
        q, k, v = k1.split_qkv(qkv, heads, True)
        if form == "contiguous":
            q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.full((2, heads, n, d), float("nan"), dtype=torch.bfloat16, device=cuda)
    k1.mha_attention(q, k, v, out=out)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    ref = k1.mha_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16, "k1"])


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [
    (1024, 64, 6), (256, 192, 4), (64, 256, 4), (65, 128, 4), (49, 32, 4),
    # the chunked build: 16-byte copies (512) and 2-byte ones (300)
    (256, 512, 2), (65, 300, 2),
])
def test_k5_equals_k1_bit_for_bit_bf16(cuda, n, hc, heads, split_first):
    """One kernel, one tile order: bf16 K5 on the views of a projection and
    on contiguous copies of them equals K1 on the projection bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(n + hc)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    fused = k1.fused_qkv_attention(qkv, heads, split_first)
    views = k1.split_qkv(qkv, heads, split_first)
    for q, k, v in (views, tuple(t.contiguous() for t in views)):
        out = k1.mha_attention(q, k, v)
        assert torch.equal(out.transpose(1, 2).reshape(fused.shape), fused)


def test_k5_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    # head dim 320 is taken (the chunked build), every element written
    g = torch.Generator(device=cuda).manual_seed(320)
    wide = torch.randn(3, 1, 1, 8, 320, generator=g, device=cuda)
    out = torch.full((1, 1, 8, 320), float("nan"), device=cuda)
    k1.mha_attention(*wide, out=out)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, k1.mha_attention_plain(*wide), **TOL[torch.float32, "k1"])
    with pytest.raises(TypeError):
        k1.mha_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous last axis"):
        k1.mha_attention(q, q, torch.zeros(1, 2, 64, 64, device=cuda).mT)
    with pytest.raises(NotImplementedError, match="no backward"):
        k1.mha_attention(q.clone().requires_grad_(True), q, q)
    with pytest.raises(ValueError, match="contiguous out"):
        k1.mha_attention(q, q, q, out=torch.zeros(1, 2, 64, 32, device=cuda))


def test_k1_refuses_what_it_does_not_take(cuda):
    # head dim 320 is taken (the chunked build)
    g = torch.Generator(device=cuda).manual_seed(640)
    qkv = torch.randn(1, 64, 3 * 640, generator=g, device=cuda)
    torch.testing.assert_close(k1.fused_qkv_attention(qkv, 2, True),
                               k1.fused_qkv_attention_plain(qkv, 2, True),
                               **TOL[torch.float32, "k1"])
    with pytest.raises(TypeError):
        k1.fused_qkv_attention(torch.zeros(1, 64, 3 * 128, device=cuda).half(), 2, True)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_qkv_attention(torch.zeros(1, 3 * 128, 64, device=cuda).mT, 2, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [
    (1024, 64, 6), (256, 64, 9), (64, 64, 12), (196, 32, 4), (49, 64, 4), (100, 128, 2),
    # openai_128's head dims 192 and 256 (32-row own tiles), at its N and at ragged N
    (256, 192, 4), (64, 256, 4), (65, 192, 2), (100, 256, 2), (1024, 256, 1), (17, 192, 1),
])
def test_k2_matches_plain(cuda, dtype, split_first, n, hc, heads):
    """Every element written (the output is pre-filled with NaN), ragged N
    included, and equal to the plain version; one count per launch."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).to(dtype)
    o = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    out = torch.full_like(qkv, float("nan"))
    before = k1.fused_qkv_attention_bwd.launches
    res = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, split_first, out=out)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention_bwd.launches == before + 1
    assert res is out and not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, split_first)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k2"])


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n", [49, 64, 65, 100, 196, 256, 1024])
@pytest.mark.parametrize("hc", k1.SUPPORTED_HEAD_DIMS)
def test_k2_bf16_matches_plain(cuda, hc, n, split_first, with_lse):
    """The bf16 K2 (wgmma on the tensor cores) at every head dim, ragged and
    whole tiles, both layouts, with K1's row log-sum-exp handed over (as the
    autograd Function does) and without it (the wrapper launches K1 for it):
    every element written (the output is pre-filled with NaN), within K2's
    bf16 gates of the plain version: per element and relative to each of dq,
    dk and dv per (example, head)."""
    heads = 2
    g = torch.Generator(device=cuda).manual_seed(hc + n)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).bfloat16()
    lse = torch.empty(2, heads, n, device=cuda) if with_lse else None
    o = k1.fused_qkv_attention(qkv, heads, split_first, lse=lse)
    out = torch.full_like(qkv, float("nan"))
    fwd, bwd = k1.fused_qkv_attention.launches, k1.fused_qkv_attention_bwd.launches
    k1.fused_qkv_attention_bwd(qkv, cot, o, heads, split_first, lse=lse, out=out)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention_bwd.launches == bwd + 1
    assert k1.fused_qkv_attention.launches == fwd + (0 if with_lse else 1)
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, split_first)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16, "k2"])
    assert _k2_rel_err(out, ref, heads, split_first) <= K2_BF16_REL


@pytest.mark.parametrize("n", [65, 256, 1024])
@pytest.mark.parametrize("hc", [64, 128, 256])
def test_k2_bf16_relative_gate_sees_a_shifted_lse(cuda, hc, n):
    """A planted fault, K1's lse handed over 0.05 too high (every p 5% low),
    fails the relative gate at every shape, while the sound call passes it."""
    heads = 2
    g = torch.Generator(device=cuda).manual_seed(hc * n + 1)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).bfloat16()
    lse = torch.empty(2, heads, n, device=cuda)
    o = k1.fused_qkv_attention(qkv, heads, True, lse=lse)
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, True)
    sound = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, True, lse=lse)
    bad = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, True, lse=lse + 0.05)
    assert _k2_rel_err(sound, ref, heads, True) <= K2_BF16_REL < _k2_rel_err(bad, ref, heads, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hc,heads", [
    (1024, 64, 6), (49, 32, 4), (65, 128, 2), (256, 192, 4), (100, 256, 2), (256, 512, 1),
])
def test_k1_lse_is_the_logsumexp_of_the_logits(cuda, dtype, n, hc, heads):
    """K1's row log-sum-exp equals torch.logsumexp of the f32 logits of the
    same inputs; rows past N are not written. f32: K1's gate. bf16: the
    tensor cores sum the logits in another order and the exponentials are
    ex2.approx (relative error about 2^-22), on values of a few units."""
    g = torch.Generator(device=cuda).manual_seed(n + hc)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    lse = torch.full((2, heads, n), float("nan"), device=cuda)
    out = k1.fused_qkv_attention(qkv, heads, True, lse=lse)
    torch.cuda.synchronize()
    assert torch.equal(out, k1.fused_qkv_attention(qkv, heads, True))
    q, k, _ = k1.split_qkv(qkv, heads, True)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hc**-0.5
    tol = dict(atol=2e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), **tol)


def test_k2_bf16_takes_inputs_off_16_bytes(cuda):
    """bf16 qkv, g and o that start 2 bytes past a 16-byte boundary are
    copied to one by the wrapper and give the same result."""
    heads, n, hc = 2, 65, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    store = torch.randn(2 * n * 3 * heads * hc + 1, generator=g, device=cuda).bfloat16()
    qkv = store[1:].view(2, n, 3 * heads * hc)
    cot = (torch.rand(2 * n * heads * hc + 1, generator=g, device=cuda) - 0.5).bfloat16()
    cot = cot[1:].view(2, n, heads * hc)
    assert qkv.data_ptr() % 16 and cot.data_ptr() % 16
    o = k1.fused_qkv_attention(qkv.clone(), heads, False)
    got = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, False)
    ref = k1.fused_qkv_attention_bwd(qkv.clone(), cot.clone(), o, heads, False)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_k2_refuses_what_it_does_not_take(cuda):
    def call(qkv, g=None, o=None, heads=2, **kw):
        b, n, c3 = qkv.shape
        g = torch.zeros(b, n, c3 // 3, device=cuda, dtype=qkv.dtype) if g is None else g
        return k1.fused_qkv_attention_bwd(qkv, g, g if o is None else o, heads, True, **kw)

    # head dim 320 is taken (the chunked build)
    gen = torch.Generator(device=cuda).manual_seed(641)
    wide = torch.randn(1, 64, 3 * 640, generator=gen, device=cuda)
    cot = 2 * torch.rand(1, 64, 640, generator=gen, device=cuda) - 1
    o = k1.fused_qkv_attention_plain(wide, 2, True)
    torch.testing.assert_close(call(wide, g=cot, o=o),
                               k1.fused_qkv_attention_bwd_plain(wide, cot, o, 2, True),
                               **TOL[torch.float32, "k2"])
    with pytest.raises(TypeError):
        call(torch.zeros(1, 64, 3 * 128, device=cuda).half())
    qkv = torch.zeros(1, 64, 3 * 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous g"):
        call(qkv, g=torch.zeros(1, 128, 64, device=cuda).mT)
    with pytest.raises(ValueError, match="contiguous o"):
        call(qkv, o=torch.zeros(1, 64, 128, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="contiguous out"):
        call(qkv, out=torch.zeros(1, 64, 128, device=cuda))
    with pytest.raises(ValueError, match="float32 lse"):
        call(qkv, lse=torch.zeros(1, 2, 64, device=cuda).bfloat16())


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [(64, 64, 3), (49, 32, 4), (100, 128, 2),
                                        (65, 192, 2), (100, 256, 2), (65, 320, 2)])
def test_attention_function_gradient_on_the_card(cuda, split_first, n, hc, heads):
    """The autograd Function in f32 (forward K1, backward K2) against
    autograd through the plain forward, and its counters: one K1 and one K2
    launch; under no_grad the Function is bypassed and saves nothing."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda, requires_grad=True)
    cot = 2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1
    fwd, bwd = k1.fused_qkv_attention.launches, k1.fused_qkv_attention_bwd.launches
    out = k1.fused_qkv_attention(qkv, heads, split_first)
    got, = torch.autograd.grad(out, qkv, cot)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == fwd + 1
    assert k1.fused_qkv_attention_bwd.launches == bwd + 1
    ref, = torch.autograd.grad(k1.fused_qkv_attention_plain(qkv, heads, split_first), qkv, cot)
    torch.testing.assert_close(got, ref, **TOL[torch.float32, "k2"])
    with torch.no_grad():
        assert k1.fused_qkv_attention(qkv, heads, split_first).grad_fn is None


@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [(64, 64, 3), (49, 32, 4), (100, 128, 2),
                                        (65, 192, 2), (100, 256, 2), (65, 320, 2)])
def test_attention_function_bf16_gradient_on_the_card(cuda, split_first, n, hc, heads):
    """The autograd Function in bf16 (forward K1 on the tensor cores,
    backward K2): the output within the bf16 gate of the plain forward, the
    gradient within K2's bf16 gate of the plain backward fed the plain
    forward's output; one K1 and one K2 launch."""
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).bfloat16()
    fwd, bwd = k1.fused_qkv_attention.launches, k1.fused_qkv_attention_bwd.launches
    leaf = qkv.clone().requires_grad_(True)
    out = k1.fused_qkv_attention(leaf, heads, split_first)
    got, = torch.autograd.grad(out, leaf, cot)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == fwd + 1
    assert k1.fused_qkv_attention_bwd.launches == bwd + 1
    plain = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[torch.bfloat16, "k1"])
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, plain, heads, split_first)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **TOL[torch.bfloat16, "k2"])


@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
def test_k3_function_gradient_on_the_card(cuda, mode):
    """K3 under autograd: the forward launches the kernel, the backward the
    backward kernel once, and the gradients equal autograd through the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 8, 8, 96, generator=g, device=cuda, requires_grad=True)
    sc = torch.randn(96, generator=g, device=cuda, requires_grad=True)
    bi = torch.randn(96, generator=g, device=cuda, requires_grad=True)
    emb = [(0.1 * torch.randn(2, 96, generator=g, device=cuda)).requires_grad_(True)
           for _ in range(2)] if mode == "ada" else []
    inputs = [x, sc, bi, *emb]
    cot = torch.randn(2, 8, 8, 96, generator=g, device=cuda)
    before = k3.group_norm_fused.launches, k3.group_norm_fused_bwd.launches
    out = k3.group_norm_fused(*inputs, silu=mode != "plain")
    assert k3.group_norm_fused.launches == before[0] + 1
    got = torch.autograd.grad(out, inputs, cot)
    assert k3.group_norm_fused_bwd.launches == before[1] + 1
    ref = torch.autograd.grad(
        k3.group_norm_fused_plain(*inputs, silu=mode != "plain"), inputs, cot)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _k3_inputs(dev, dtype, shape, mode, seed, groups=32):
    """x, scale, bias and, for AdaGN, modulation rows as the two halves of one
    (B, 2C) tensor (the model's ``emb.chunk(2)``), and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, _, _, c = shape
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    sc = torch.randn(c, generator=g, device=dev)
    bi = torch.randn(c, generator=g, device=dev)
    emb = (0.1 * torch.randn(b, 2 * c, generator=g, device=dev)).to(dtype)
    es, esh = emb.chunk(2, dim=-1) if mode == "ada" else (None, None)
    cot = torch.randn(shape, generator=g, device=dev).to(dtype)
    return (x, sc, bi, es, esh), cot


def _k3_rel_err(out, ref):
    """||out - ref||_F / ||ref||_F, the largest over the examples (dim 0) of
    a batched output; over the whole of a (C,) parameter gradient."""
    out, ref = out.double(), ref.double()
    if out.ndim == 1:
        return (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
    dims = tuple(range(1, out.ndim))
    return (torch.linalg.vector_norm(out - ref, dim=dims)
            / torch.linalg.vector_norm(ref, dim=dims)).max().item()


def _k3_check_forward(args, dtype, silu, groups=32):
    """K3 and its statistics against the plain version: f32 to 1e-5, bf16 to
    the per-element gate and K3_BF16_REL, which the scale handed over 5% high
    (what an rstd 5% high gives) must fail."""
    before = k3.group_norm_fused.launches
    out, mean, rstd = k3.group_norm_fused_with_stats(*args, num_groups=groups, silu=silu)
    torch.cuda.synchronize()
    assert k3.group_norm_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    ref = k3.group_norm_fused_plain(*args, num_groups=groups, silu=silu)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k3"])
    _, m, var = k3.group_stats(args[0], groups)
    b = args[0].shape[0]
    torch.testing.assert_close(mean, m.reshape(b, groups), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, torch.rsqrt(var + 1e-5).reshape(b, groups),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(k3.group_norm_fused(*args, num_groups=groups, silu=silu), out)
    if dtype == torch.bfloat16:
        assert _k3_rel_err(out, ref) <= K3_BF16_REL
        bad = k3.group_norm_fused(args[0], args[1] * 1.05, *args[2:], num_groups=groups,
                                  silu=silu)
        assert _k3_rel_err(bad, ref) > K3_BF16_REL
    return mean, rstd


def _k3_check_backward(args, cot, mean, rstd, dtype, silu, groups=32):
    """K3's backward against its plain version: f32 to 1e-5 of each output's
    largest element, bf16 to K3_BF16_REL per output, which the rstd handed
    over 5% high must fail; bit-equal across two runs."""
    before = k3.group_norm_fused_bwd.launches
    got = k3.group_norm_fused_bwd(*args, cot, mean, rstd, num_groups=groups, silu=silu)
    torch.cuda.synchronize()
    assert k3.group_norm_fused_bwd.launches == before + 1
    ref = k3.group_norm_fused_bwd_plain(*args, cot, num_groups=groups, silu=silu)
    again = k3.group_norm_fused_bwd(*args, cot, mean, rstd, num_groups=groups, silu=silu)
    for name, a, r, a2, inp in zip(("dx", "dscale", "dbias", "demb_scale", "demb_shift"),
                                   got, ref, again, args):
        if inp is None:
            assert a is None and r is None
            continue
        assert a.dtype == inp.dtype and a.shape == inp.shape, name
        assert torch.equal(a, a2), f"{name} differs between two runs"
        if dtype == torch.float32:
            err = (a - r).abs().max().item()
            assert err <= 1e-5 * r.abs().max().item(), f"{name}: {err:.3g}"
        else:
            assert _k3_rel_err(a, r) <= K3_BF16_REL, name
    if dtype == torch.bfloat16:
        bad = k3.group_norm_fused_bwd(*args, cot, mean, rstd * 1.05, num_groups=groups,
                                      silu=silu)
        assert max(_k3_rel_err(a, r) for a, r in zip(bad, ref) if r is not None) > K3_BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
@pytest.mark.parametrize("shape", [(4, 64, 64, 384), (4, 8, 8, 1536), (3, 7, 7, 96)])
def test_k3_matches_plain(cuda, dtype, mode, shape):
    """K3 (one launch, its statistics beside it) against the plain version;
    bf16 also to K3_BF16_REL, with a planted fault that must fail it."""
    args, _ = _k3_inputs(cuda, dtype, shape, mode, seed=shape[-1])
    _k3_check_forward(args, dtype, mode != "plain")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
@pytest.mark.parametrize("shape,groups", [
    ((4, 64, 64, 384), 32), ((4, 8, 8, 1536), 32), ((3, 7, 7, 96), 32), ((2, 7, 5, 64), 32),
    # C/G = 3 with C no multiple of a 16-byte vector; an odd C (2-byte vectors)
    ((2, 9, 11, 36), 12), ((1, 5, 3, 15), 5),
])
def test_k3_bwd_matches_plain(cuda, dtype, mode, shape, groups):
    args, cot = _k3_inputs(cuda, dtype, shape, mode, seed=shape[-1] + 1)
    mean, rstd = _k3_check_forward(args, dtype, mode != "plain", groups)
    _k3_check_backward(args, cot, mean, rstd, dtype, mode != "plain", groups)


@functools.lru_cache(maxsize=None)
def _gn_keys(preset):
    """The sorted ((H, W, C), mode) GroupNorm keys of one forward of a model
    (chip_smoke.main_path_calls on the meta device: shapes only);
    tests/test_torch_groupnorm_bwd.py pins their count."""
    from chip_smoke import classifier_config, main_path_calls, model_config, sr_config
    from nicediffusion_tpu_torch import EncoderUNet
    from nicediffusion_tpu_torch.models.unet import SuperResolutionModel

    from nicediffusion_tpu_torch.tools.quality_eval import arch_config

    meta = torch.device("meta")
    _, qe_unet, qe_cls = arch_config("emnist")
    if preset == "classifier":
        model = EncoderUNet(**classifier_config(), kernels=False, device=meta)
    elif preset == "sr256":  # the super-resolution UNet at openai_256 widths
        model = SuperResolutionModel(**sr_config(), kernels=False, device=meta)
    elif preset == "qe_cls":  # tools/quality_eval.py's classifier: 1 and 2 channels a group
        model = EncoderUNet(**qe_cls, kernels=False, device=meta)
    elif preset == "qe_unet":  # tools/quality_eval.py's UNet
        model = DiffusionModel(**qe_unet, kernels=False, device=meta)
    else:
        model = DiffusionModel(**model_config(preset), kernels=False, device=meta)
    return sorted((k[1], k[2]) for k in main_path_calls(model.eval(), meta)
                  if k[0] == "groupnorm")


@pytest.mark.parametrize("preset,index", [
    (p, i) for p, n in (("openai_64", 30), ("openai_128", 33), ("classifier", 19), ("EMNIST", 21),
                        ("sr256", 31))
    for i in range(n)])
def test_k3_forward_and_backward_at_every_model_shape(cuda, preset, index):
    """K3 and its backward at every GroupNorm shape of the preset, at batch
    2, f32 and bf16, with the gates and planted faults of the two checks."""
    (h, w, c), mode = _gn_keys(preset)[index]
    for dtype in (torch.float32, torch.bfloat16):
        args, cot = _k3_inputs(cuda, dtype, (2, h, w, c), mode, seed=h + c)
        mean, rstd = _k3_check_forward(args, dtype, mode != "plain")
        _k3_check_backward(args, cot, mean, rstd, dtype, mode != "plain")


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("index", range(30))
def test_k3_at_the_data_parallel_batches(cuda, batch, index):
    """K3 and its backward at every ``openai_64`` GroupNorm shape at the
    per-rank batches of chip_smoke.py's ``[dp]`` runs on two ranks: 4 (a
    training step's global batch of 8) and 8 (a sampling or served batch of
    16); the backward's plan (slices, cluster, route) depends on the batch."""
    (h, w, c), mode = _gn_keys("openai_64")[index]
    for dtype in (torch.float32, torch.bfloat16):
        args, cot = _k3_inputs(cuda, dtype, (batch, h, w, c), mode, seed=h + c + batch)
        mean, rstd = _k3_check_forward(args, dtype, mode != "plain")
        _k3_check_backward(args, cot, mean, rstd, dtype, mode != "plain")


@pytest.mark.parametrize("preset,index", [
    (p, i) for p, n in (("qe_unet", 21), ("qe_cls", 4)) for i in range(n)])
def test_k3_at_the_quality_eval_shapes(cuda, preset, index):
    """K3 and its backward at every GroupNorm shape of tools/quality_eval.py's
    UNet and classifier at its batch of 256 (the classifier's 32 and 64
    channels in 32 groups: 1 and 2 channels a group), f32 and bf16, with the
    gates and planted faults of the two checks."""
    (h, w, c), mode = _gn_keys(preset)[index]
    for dtype in (torch.float32, torch.bfloat16):
        args, cot = _k3_inputs(cuda, dtype, (256, h, w, c), mode, seed=h + c + index)
        mean, rstd = _k3_check_forward(args, dtype, mode != "plain")
        _k3_check_backward(args, cot, mean, rstd, dtype, mode != "plain")


@pytest.mark.parametrize("preset,batch,index", [
    (p, b, i) for p, b, n in (("qe_unet", 16, 21), ("qe_unet", 128, 21), ("openai_64", 1, 30))
    for i in range(n)])
def test_k3_at_the_tools_other_batches(cuda, preset, batch, index):
    """K3 at the batches the tools give a model beside the timed paths':
    tools/quality_eval.py's UNet at model batch 16 (its int8 calibration, 8 labels under CFG) and 128 (a chunk
    outside the guidance interval), and verify_checkpoint's ``openai_64`` at
    batch 1 (its smoke sample); f32 and bf16, with the forward's gates and
    planted fault."""
    (h, w, c), mode = _gn_keys(preset)[index]
    for dtype in (torch.float32, torch.bfloat16):
        args, _ = _k3_inputs(cuda, dtype, (batch, h, w, c), mode, seed=h + c + batch)
        _k3_check_forward(args, dtype, mode != "plain")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hc,heads,split_first", [
    (196, 32, 2, False),  # quality_eval's classifier (its middle block)
    (196, 32, 4, True), (49, 64, 4, True),  # quality_eval's UNet at 14x14 and 7x7
])
def test_k1_k2_at_the_quality_eval_shapes(cuda, dtype, n, hc, heads, split_first):
    """K1 and K2 (K1's lse handed over) at tools/quality_eval.py's attention
    shapes at its batch of 256: every element written, within the gates of
    the plain versions; bf16 K2 also within K2_BF16_REL, which an lse 0.05
    too high must fail."""
    g = torch.Generator(device=cuda).manual_seed(n + hc + heads)
    b = 256
    qkv = torch.randn(b, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    cot = (2 * torch.rand(b, n, heads * hc, generator=g, device=cuda) - 1).to(dtype)
    lse = torch.empty(b, heads, n, device=cuda)
    o = torch.full((b, n, heads * hc), float("nan"), dtype=dtype, device=cuda)
    k1.fused_qkv_attention(qkv, heads, split_first, lse=lse, out=o)
    torch.cuda.synchronize()
    assert not torch.isnan(o).any()
    torch.testing.assert_close(o.float(), k1.fused_qkv_attention_plain(
        qkv, heads, split_first).float(), **TOL[dtype, "k1"])
    out = torch.full_like(qkv, float("nan"))
    k1.fused_qkv_attention_bwd(qkv, cot, o, heads, split_first, lse=lse, out=out)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, split_first)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k2"])
    if dtype == torch.bfloat16:
        assert _k2_rel_err(out, ref, heads, split_first) <= K2_BF16_REL
        bad = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, split_first, lse=lse + 0.05)
        assert _k2_rel_err(bad, ref, heads, split_first) > K2_BF16_REL


@functools.lru_cache(maxsize=None)
def _tp_gn_keys():
    """The ((H, W, C / 2), mode, groups) keys of a tensor-parallel rank's
    channel-sharded out_norm calls in an ``openai_64`` forward at tp = 2
    (chip_smoke.tp_path_calls on the meta device)."""
    from chip_smoke import model_config, tp_path_calls

    meta = torch.device("meta")
    model = DiffusionModel(**model_config(), kernels=False, device=meta).eval()
    return sorted((k[1], k[2], k[3]) for k in tp_path_calls(model, meta, tp=2))


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("index", range(10))
def test_k3_at_the_tensor_parallel_shards(cuda, batch, index):
    """K3 and its backward at a tensor-parallel rank's out_norm shapes
    (``openai_64``, tp = 2: C / 2 channels in 16 groups) at chip_smoke.py's
    ``[tp]`` batches, the modulation rows strided views at rank 1's offset
    into a (B, 2C) step embedding, as the model hands them over."""
    (h, w, c), mode, groups = _tp_gn_keys()[index]
    assert groups == 16 and mode == "ada"
    for dtype in (torch.float32, torch.bfloat16):
        (x, sc, bi, _, _), cot = _k3_inputs(cuda, dtype, (batch, h, w, c), mode, seed=c + batch)
        g = torch.Generator(device=cuda).manual_seed(c)
        emb = (0.1 * torch.randn(batch, 2, 2 * c, generator=g, device=cuda)).to(dtype)[..., c:]
        args = (x, sc, bi, emb[:, 0], emb[:, 1])
        assert args[3].stride() == (4 * c, 1) and args[4].storage_offset() == 3 * c
        mean, rstd = _k3_check_forward(args, dtype, True, groups)
        _k3_check_backward(args, cot, mean, rstd, dtype, True, groups)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_re_read_route(cuda, backward, dtype):
    """A map too large for its cluster's shared memory even in channel
    slices: the blocks hold the last rows of their ranges and read the
    others twice."""
    shape = (1, 128, 128, 256) if backward else (1, 256, 256, 64)
    assert k3.group_norm_plan(shape, dtype, backward=backward)["route"] == "re-read"
    args, cot = _k3_inputs(cuda, dtype, shape, "ada", seed=3)
    mean, rstd = _k3_check_forward(args, dtype, True)
    if backward:
        _k3_check_backward(args, cot, mean, rstd, dtype, True)


@pytest.mark.parametrize("index", range(30))
def test_k3_forward_row_is_batch_invariant(cuda, index):
    """At every ``openai_64`` GroupNorm shape, bf16: one example's output,
    mean and rstd are the same bits alone and in rows of batches of 4, 8, 16
    and 128 among other examples. The forward's split, and so the order of
    its sums, is chosen for one batch whatever the call's."""
    (h, w, c), mode = _gn_keys("openai_64")[index]
    (x, sc, bi, es, esh), _ = _k3_inputs(cuda, torch.bfloat16, (129, h, w, c), mode, seed=c)
    silu = mode != "plain"

    def rows(b, row):
        """x, es and esh of examples 1 to b, example 0 in place of ``row``
        (b = 0: example 0 alone)."""
        out = []
        for t in (x, es, esh):
            if t is not None:
                src, t = t, (t[:1] if b == 0 else t[1:b + 1]).clone()
                t[row] = src[0]
            out.append(t)
        return out

    xs, ess, eshs = rows(0, 0)
    ref = k3.group_norm_fused_with_stats(xs, sc, bi, ess, eshs, silu=silu)
    for b, row in ((4, 3), (8, 5), (16, 15), (128, 77)):
        xs, ess, eshs = rows(b, row)
        got = k3.group_norm_fused_with_stats(xs, sc, bi, ess, eshs, silu=silu)
        for name, a, r in zip(("out", "mean", "rstd"), got, ref):
            assert torch.equal(a[row], r[0]), f"{name} moves at row {row} of {b}"


def test_k3_forward_splits_a_batch_past_the_grid_limit(cuda):
    """A batch whose (example, channel slice) pairs pass 65,535 runs in more
    than one launch, and matches the plain version."""
    shape = (2100, 1, 1, 1024)
    plan = k3.group_norm_plan(shape, torch.float32, force=(32, 1))
    assert plan["slices"] == 32 and shape[0] * plan["slices"] > 65535
    args, _ = _k3_inputs(cuda, torch.float32, shape, "ada", seed=5)
    _k3_check_forward(args, torch.float32, True)


def test_k3_takes_f32_rows_beside_bf16_activations_and_unaligned_x(cuda):
    args, cot = _k3_inputs(cuda, torch.bfloat16, (2, 8, 8, 64), "ada", seed=7)
    x, sc, bi, es, esh = args
    rows = (es.float().contiguous(), esh.float().contiguous())
    mean, rstd = _k3_check_forward((x, sc, bi, *rows), torch.bfloat16, True)
    _k3_check_backward((x, sc, bi, *rows), cot, mean, rstd, torch.bfloat16, True)
    # x two bytes past a 16-byte boundary: 2-byte vectors
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    x_off = flat[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 == 2
    assert k3.group_norm_plan(x.shape, x.dtype, align=2)["vector"] == 1
    mean, rstd = _k3_check_forward((x_off, sc, bi, es, esh), torch.bfloat16, True)
    _k3_check_backward((x_off, sc, bi, es, esh), cot, mean, rstd, torch.bfloat16, True)


def test_k3_refuses_what_it_does_not_take(cuda):
    (x, sc, bi, es, esh), cot = _k3_inputs(cuda, torch.float32, (2, 8, 8, 64), "ada", seed=1)
    mean, rstd = k3.group_norm_fused_with_stats(x, sc, bi, es, esh)[1:]
    with pytest.raises(TypeError):
        k3.group_norm_fused(x.half(), sc, bi)
    with pytest.raises(TypeError):
        k3.group_norm_fused_bwd(x.half(), sc, bi, None, None, cot, mean, rstd)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        k3.group_norm_fused(x.permute(0, 2, 1, 3), sc, bi)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        k3.group_norm_fused_bwd(x.permute(0, 2, 1, 3), sc, bi, None, None, cot, mean, rstd)
    wide = torch.randn(2, 3 * 64, device=cuda)
    with pytest.raises(ValueError, match="modulation rows"):  # two rows of other strides
        k3.group_norm_fused(x, sc, bi, wide[:, :64], es)
    with pytest.raises(ValueError, match="modulation rows"):  # channels not contiguous
        k3.group_norm_fused(x, sc, bi, wide[:, ::3], wide[:, 1::3])
    with pytest.raises(ValueError, match="together"):
        k3.group_norm_fused(x, sc, bi, es)
    with pytest.raises(ValueError, match="not divisible"):
        k3.group_norm_fused(x, sc, bi, num_groups=24)
    with pytest.raises(ValueError, match="mean and rstd"):
        k3.group_norm_fused_bwd(x, sc, bi, es, esh, cot)
    with pytest.raises(ValueError, match="mean and rstd"):
        k3.group_norm_fused_bwd(x, sc, bi, es, esh, cot, mean[:1], rstd[:1])


def _k4_inputs(dev, dtype, shape, f, ada, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, _, _, c = shape
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    weight = torch.randn(f, c, 3, 3, generator=g, device=dev) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)).to(dtype)
    return (x, gamma, beta, weight, bias) + (tuple(emb.chunk(2, dim=-1)) if ada else ())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ada", [False, True])
@pytest.mark.parametrize("shape,f,groups", [
    # tests/test_pallas_resblock.py:23, then ragged maps, channels and filters
    ((2, 8, 8, 32), 64, 8), ((1, 16, 16, 64), 32, 32), ((3, 4, 4, 96), 96, 32),
    ((2, 7, 7, 96), 40, 32), ((2, 28, 14, 64), 3, 32), ((1, 9, 17, 40), 130, 8),
    # C not a multiple of 8 (2-byte halo loads), F odd (2-byte weight loads, single stores)
    ((1, 5, 11, 12), 7, 4),
    # openai_64: a level's first block, a decoder block, the widest input
    ((2, 32, 32, 192), 384, 32), ((2, 64, 64, 384), 192, 32), ((2, 8, 8, 1536), 768, 32),
])
def test_k4_matches_plain(cuda, dtype, ada, shape, f, groups):
    """Every element written (the output is pre-filled with NaN) and equal
    to the plain version, whose padding is zero after the activation; one
    count per launch; AdaGN rows as strided halves of one (B, 2C) tensor;
    bf16 also to K4_BF16_REL, which the weight flipped left-right (what a
    halo shifted the wrong way gives) must fail."""
    args = _k4_inputs(cuda, dtype, shape, f, ada, seed=shape[-1] + f)
    out = torch.full(shape[:3] + (f,), float("nan"), dtype=dtype, device=cuda)
    before = k4.gn_silu_conv3x3.launches
    assert k4.gn_silu_conv3x3(*args, num_groups=groups, out=out) is out
    torch.cuda.synchronize()
    assert k4.gn_silu_conv3x3.launches == before + 1
    assert not torch.isnan(out).any()
    # float64 sums in the reference: cuDNN's f32 conv is itself ~1e-5 off at small maps
    ref = k4.gn_silu_conv3x3_plain(*args, num_groups=groups, conv_dtype=torch.float64)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k4"])
    if dtype == torch.bfloat16:
        assert _k4_rel_err(out, ref) <= K4_BF16_REL
        flipped = (*args[:3], args[3].flip(-1), *args[4:])
        assert _k4_rel_err(k4.gn_silu_conv3x3(*flipped, num_groups=groups), ref) > K4_BF16_REL


def _k4_rel_err(out, ref):
    """The largest ||out - ref||_F / ||ref||_F over the examples."""
    out, ref = out.double(), ref.double()
    dims = tuple(range(1, out.ndim))
    return (torch.linalg.vector_norm(out - ref, dim=dims)
            / torch.linalg.vector_norm(ref, dim=dims)).max().item()


@functools.lru_cache(maxsize=None)
def _halves(preset):
    """The sorted (H, C, F, ada) keys of the residual-block halves of one
    forward of the preset's UNet (chip_smoke.resblock_halves, on the meta
    device: shapes only); tests/test_torch_resblock.py pins their count."""
    from chip_smoke import resblock_halves
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    model = DiffusionModel(**MODEL_PRESETS[preset], kernels=False, device="meta").eval()
    return sorted(resblock_halves(model, torch.device("meta")))


@pytest.mark.parametrize("preset,index", [("openai_64", i) for i in range(27)]
                         + [("openai_128", i) for i in range(30)])
def test_k4_bf16_matches_plain_at_every_unet_half(cuda, preset, index):
    """bf16 K4 (the tensor-core kernel) at every (H, C, F, ada) a residual-
    block half of the preset's UNet has, at batch 2, against the plain
    version with its convolution summed in float64: per element and to
    K4_BF16_REL; the weight flipped left-right (what a halo shifted the wrong
    way gives) must fail K4_BF16_REL."""
    h, c, f, ada = _halves(preset)[index]
    args = _k4_inputs(cuda, torch.bfloat16, (2, h, h, c), f, ada, seed=h + c + f)
    out = torch.full((2, h, h, f), float("nan"), dtype=torch.bfloat16, device=cuda)
    before = k4.gn_silu_conv3x3.launches
    k4.gn_silu_conv3x3(*args, out=out)
    torch.cuda.synchronize()
    assert k4.gn_silu_conv3x3.launches == before + 1
    assert not torch.isnan(out).any()
    ref = k4.gn_silu_conv3x3_plain(*args, conv_dtype=torch.float64)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16, "k4"])
    assert _k4_rel_err(out, ref) <= K4_BF16_REL
    flipped = (*args[:3], args[3].flip(-1), *args[4:])
    assert _k4_rel_err(k4.gn_silu_conv3x3(*flipped), ref) > K4_BF16_REL


def test_k4_takes_f32_rows_beside_bf16_activations_and_repacks_a_changed_weight(cuda):
    x, gamma, beta, weight, bias, es, eb = _k4_inputs(
        cuda, torch.bfloat16, (2, 8, 8, 64), 64, True)
    es, eb = es.float().contiguous(), eb.float().contiguous()
    out = k4.gn_silu_conv3x3(x, gamma, beta, weight, bias, es, eb)
    ref = k4.gn_silu_conv3x3_plain(x, gamma, beta, weight, bias, es, eb)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16, "k4"])
    packed = k4.pack_conv3x3_weight(weight, torch.bfloat16)
    assert k4.pack_conv3x3_weight(weight, torch.bfloat16) is packed
    weight.mul_(2.0)  # an in-place update bumps the version: the next call repacks
    out2 = k4.gn_silu_conv3x3(x, gamma, beta, weight, torch.zeros_like(bias), es, eb)
    ref2 = k4.gn_silu_conv3x3_plain(x, gamma, beta, weight, torch.zeros_like(bias), es, eb)
    torch.testing.assert_close(out2.float(), ref2.float(), **TOL[torch.bfloat16, "k4"])


def test_k4_refuses_what_it_does_not_take(cuda):
    x, gamma, beta, weight, bias, es, eb = _k4_inputs(
        cuda, torch.float32, (2, 8, 8, 64), 32, True)
    with pytest.raises(TypeError):
        k4.gn_silu_conv3x3(x.half(), gamma, beta, weight, bias)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        k4.gn_silu_conv3x3(x.permute(0, 2, 1, 3), gamma, beta, weight, bias)
    with pytest.raises(ValueError, match="3, 3\\) weight"):
        k4.gn_silu_conv3x3(x, gamma, beta, weight[:, :32], bias)
    with pytest.raises(ValueError, match="together"):
        k4.gn_silu_conv3x3(x, gamma, beta, weight, bias, es)
    with pytest.raises(ValueError, match="modulation rows"):
        k4.gn_silu_conv3x3(x, gamma, beta, weight, bias, es[:1], eb[:1])
    with pytest.raises(ValueError, match="not divisible"):
        k4.gn_silu_conv3x3(x, gamma, beta, weight, bias, num_groups=24)
    with pytest.raises(ValueError, match="contiguous out"):
        k4.gn_silu_conv3x3(x, gamma, beta, weight, bias, out=torch.zeros(2, 8, 8, 64, device=cuda))


@pytest.mark.parametrize("ada", [False, True])
def test_k4_function_gradient_on_the_card(cuda, ada):
    """K4 under autograd: the forward launches the kernel, the backward
    equals autograd through the plain version, for every input."""
    inputs = [t.requires_grad_(True)
              for t in _k4_inputs(cuda, torch.float32, (2, 8, 8, 96), 64, ada)]
    if ada:  # leaves of their own, not views of one tensor
        inputs[5:] = [t.detach().contiguous().requires_grad_(True) for t in inputs[5:]]
    cot = torch.randn(2, 8, 8, 64, generator=torch.Generator(device=cuda).manual_seed(1),
                      device=cuda)
    before = k4.gn_silu_conv3x3.launches
    out = k4.gn_silu_conv3x3(*inputs)
    assert k4.gn_silu_conv3x3.launches == before + 1
    got = torch.autograd.grad(out, inputs, cot)
    ref = torch.autograd.grad(k4.gn_silu_conv3x3_plain(*inputs), inputs, cot)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _int8_inputs(dev, shape, f, k, xdtype, seed=0):
    """x (int8 already quantized, or float with a static scale that clips a
    few values), kernel_q (F, k, k, C) int8 with every filter's extremes at
    +-127, inv_act, deq and a bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    if xdtype == torch.int8:
        x = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    else:
        x = (2.0 * torch.randn(shape, generator=g, device=dev)).to(xdtype)
    kq = torch.randint(-127, 128, (f, k, k, c), generator=g, device=dev, dtype=torch.int8)
    inv_act = torch.tensor(127.0 / 6.0, device=dev)
    deq = 1e-4 * (1.0 + torch.rand(f, generator=g, device=dev))
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    return x, kq, inv_act, deq, bias


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "s8"])
@pytest.mark.parametrize("shape,f,k,stride", [
    # openai_64 (model batch 2 here): a level's convs, a skip, a decoder input
    ((2, 64, 64, 192), 192, 3, 1), ((2, 32, 32, 384), 384, 3, 1), ((2, 16, 16, 576), 576, 3, 1),
    ((2, 8, 8, 768), 768, 3, 1), ((2, 64, 64, 384), 192, 1, 1), ((2, 8, 8, 1536), 768, 3, 1),
    # EMNIST: ragged maps (28, 14, 7), 64 channels
    ((3, 28, 28, 64), 64, 3, 1), ((3, 7, 7, 256), 256, 3, 1), ((3, 14, 14, 192), 128, 1, 1),
    # a Downsample conv, a 1x1 at stride 2, ragged C and F (byte loads, masked filters)
    ((2, 16, 16, 64), 64, 3, 2), ((2, 9, 7, 40), 24, 1, 2), ((1, 5, 11, 12), 7, 3, 1),
    ((2, 6, 6, 200), 130, 3, 1),
    # a dense layer as the model calls it: a 1x1 conv over (1, 1, M, C)
    ((1, 1, 2 * 256, 384), 3 * 384, 1, 1),
    # the halo route's edges: a 5 x 11 map, C = 3 and 64, F = 192 and 576 on
    # an odd tile count (a block's second warpgroup has no tile), a ragged F
    # past 128 at 28 x 28
    ((2, 5, 11, 64), 192, 3, 1), ((2, 16, 16, 3), 192, 3, 1), ((3, 8, 8, 192), 576, 3, 1),
    ((1, 28, 28, 128), 130, 3, 1),
])
def test_int8_conv_matches_plain(cuda, xdtype, shape, f, k, stride):
    """s32 sums bit-equal to the plain version's exact ones (float64), the
    outputs (f32 and bf16) bit-equal too: the same f32 product and sum, each
    rounded once; one count per launch."""
    x, kq, inv_act, deq, bias = _int8_inputs(cuda, shape, f, k, xdtype, seed=shape[-1] + f)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = k8.int8_conv_nhwc.launches
        out, sums = k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride, out_dtype, raw=True)
        torch.cuda.synchronize()
        assert k8.int8_conv_nhwc.launches == before + 1
        ref, ref_sums = k8.int8_conv_plain(x, kq, inv_act, deq, bias, stride, out_dtype, raw=True)
        assert sums.dtype == torch.int32 and sums.shape == ref_sums.shape
        assert torch.equal(sums, ref_sums)
        assert out.dtype == out_dtype and torch.equal(out, ref)
    assert ref_sums.abs().max() > 0
    if xdtype != torch.int8:  # some activations clip at +-127
        assert (x.float() * inv_act).abs().max() > 127


@pytest.mark.parametrize("k", [3, 1], ids=["halo", "row"])
def test_int8_conv_rounds_ties_to_even(cuda, k):
    """bf16 x on exact .5 ties of x * inv_act (inv_act 2, x = (n + 0.5) / 2),
    quantized in the kernel's halo (k = 3) and row (k = 1) stagers: round
    half to even, as torch.round and jnp.round, so the sums stay bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n = torch.randint(-60, 60, (2, 12, 12, 64), generator=g, device=cuda).float()
    x = ((n + 0.5) / 2).to(torch.bfloat16)
    assert torch.equal(x.float() * 2, n + 0.5)
    kq = torch.randint(-127, 128, (64, k, k, 64), generator=g, device=cuda, dtype=torch.int8)
    inv_act = torch.tensor(2.0, device=cuda)
    deq = torch.full((64,), 1e-3, device=cuda)
    out, sums = k8.int8_conv_nhwc(x, kq, inv_act, deq, None, raw=True)
    ref, ref_sums = k8.int8_conv_plain(x, kq, inv_act, deq, None, raw=True)
    assert torch.equal(sums, ref_sums) and torch.equal(out, ref)
    away = torch.trunc(n + 0.5 + torch.sign(n + 0.5) * 0.5)  # half away from zero differs
    assert not torch.equal(away, torch.round(n + 0.5))


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "s8", "f32"])
@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)], ids=["halo", "row", "row_s2"])
def test_int8_conv_on_a_misaligned_view(cuda, xdtype, k, stride):
    """x a contiguous view one element into its storage (no 16-byte copy is
    aligned) and C = 72: the stagers' masked element loads, bit-equal."""
    x, kq, inv_act, deq, bias = _int8_inputs(cuda, (2, 9, 10, 72), 80, k, xdtype, seed=11)
    flat = torch.empty(x.numel() + 1, dtype=xdtype, device=cuda)
    xv = flat[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    out, sums = k8.int8_conv_nhwc(xv, kq, inv_act, deq, bias, stride, torch.bfloat16, raw=True)
    ref, ref_sums = k8.int8_conv_plain(x, kq, inv_act, deq, bias, stride, torch.bfloat16,
                                       raw=True)
    assert torch.equal(sums, ref_sums) and torch.equal(out, ref)


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "s8"])
@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)], ids=["halo", "row", "row_s2"])
def test_int8_conv_is_one_cuda_kernel(cuda, xdtype, k, stride):
    """A call launches exactly one CUDA kernel, of the route int8_conv_plan
    names: no quantize pass, no scratch copy (torch.profiler's kernel count)."""
    from torch.profiler import ProfilerActivity, profile

    x, kq, inv_act, deq, bias = _int8_inputs(cuda, (2, 16, 16, 128), 192, k, xdtype)
    out_dtype = torch.bfloat16
    k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride, out_dtype)  # built and warm
    torch.cuda.synchronize()
    for _ in range(8):  # a profiled run now and then records no device activity
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride, out_dtype)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        if kernels:
            break
    route = k8.int8_conv_plan(2, 16, 16, 128, 192, k, stride, xdtype)[0]
    assert len(kernels) == 1 and f"int8_conv_{route}_wgmma" in kernels[0].name, [
        e.name for e in kernels]


def test_int8_conv_without_bias_and_on_strided_views(cuda):
    """No bias, a non-contiguous x and kernel_q (made contiguous by the
    wrapper), and the raw sums alone of an f32 input."""
    x, kq, inv_act, deq, _ = _int8_inputs(cuda, (2, 12, 10, 96), 80, 3, torch.float32)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    out = k8.int8_conv_nhwc(xt, kq, inv_act, deq, None)
    assert torch.equal(out, k8.int8_conv_plain(x, kq, inv_act, deq, None))


def test_int8_conv_refuses_what_it_does_not_take(cuda):
    x, kq, inv_act, deq, bias = _int8_inputs(cuda, (1, 8, 8, 32), 16, 3, torch.float32)
    with pytest.raises(NotImplementedError, match="k in"):
        k8.int8_conv_nhwc(x, torch.zeros(16, 5, 5, 32, dtype=torch.int8, device=cuda),
                          inv_act, deq, bias)
    with pytest.raises(NotImplementedError, match="stride"):
        k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride=3)
    with pytest.raises(ValueError, match="out_dtype"):
        k8.int8_conv_nhwc(x.to(torch.int8), kq, inv_act, deq, bias)
    with pytest.raises(TypeError):
        k8.int8_conv_nhwc(x.half(), kq, inv_act, deq, bias)
    with pytest.raises(ValueError, match="channels"):
        k8.int8_conv_nhwc(x, kq[..., :16], inv_act, deq, bias)
    with pytest.raises(ValueError, match="deq"):
        k8.int8_conv_nhwc(x, kq, inv_act, deq[:8], bias)


def test_int8_model_runs_every_quantized_layer_through_the_kernel(cuda):
    """A small quantized UNet on the card: frozen from its own calibration,
    one forward launches the int8 conv once per int8 layer (convs and the
    attention projections), and agrees with ``kernels=False`` (the plain
    versions of every kernel) to a correlation above 0.9999."""
    from nicediffusion_tpu_torch.ops.quant import collect_calibration, freeze_int8

    cfg = dict(resolution=16, in_channels=3, model_channels=64, out_channels=6,
               num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
               num_head_channels=32, num_classes=11, use_adaptive_gn=True,
               resblock_updown=False)
    models = [DiffusionModel(**cfg, quantized=True, quantized_attention=True, kernels=kern,
                             dtype=torch.bfloat16, device=cuda).eval() for kern in (True, False)]
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for p in models[0].parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g, device=cuda))
    models[1].load_state_dict(models[0].state_dict())
    x = torch.randn(4, 16, 16, 3, generator=g, device=cuda)
    t = torch.tensor([10, 500, 900, 999], device=cuda)
    y = torch.tensor([1, 2, 0, 0], device=cuda)
    calib = collect_calibration(models[1], [(x, t, y)])
    outs = []
    for m in models:
        freeze_int8(m, calib)
        before = k8.int8_conv_nhwc.launches
        with torch.inference_mode():
            outs.append(m(x, t, y))
        torch.cuda.synchronize()
        launched = k8.int8_conv_nhwc.launches - before
        assert launched == (len(m.int8_layers()) if m.kernels else 0)
    assert torch.isfinite(outs[0]).all()
    corr = torch.corrcoef(torch.stack([outs[0].flatten(), outs[1].flatten()]))[0, 1]
    assert corr > 0.9999, corr


# the bf16 conv against its plain version: the same exact products summed in
# f32 in another order, each side rounded to bf16 before and after the bias,
# so an element may differ by a bf16 ulp of the sum and one of the output:
# at most two ulps of the output's largest magnitude, 2^-6 of it
BF16_CONV_TOL = 2.0 ** -6


def _bf16_conv_inputs(dev, shape, f, k, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = torch.randn(f, c, k, k, generator=g, device=dev) / (c * k * k) ** 0.5
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    return x, w, bias


def _bf16_conv_gate(out, ref):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= BF16_CONV_TOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape,f,k,stride", [
    # openai_64 (model batch 2 here): a level's convs, a skip, a decoder input
    ((2, 64, 64, 192), 192, 3, 1), ((2, 32, 32, 384), 384, 3, 1), ((2, 16, 16, 576), 576, 3, 1),
    ((2, 8, 8, 768), 768, 3, 1), ((2, 64, 64, 384), 192, 1, 1), ((2, 8, 8, 1536), 768, 3, 1),
    # the stem (C = 3) and the head (F = 6), a Downsample conv, ragged maps,
    # C and F (masked loads, masked filters), a 1x1 at stride 2
    ((2, 64, 64, 3), 192, 3, 1), ((2, 64, 64, 192), 6, 3, 1), ((2, 16, 16, 64), 64, 3, 2),
    ((3, 28, 28, 64), 64, 3, 1), ((3, 7, 7, 256), 256, 3, 1), ((2, 9, 7, 40), 24, 1, 2),
    ((1, 5, 11, 12), 7, 3, 1), ((2, 6, 6, 200), 130, 3, 1), ((3, 8, 8, 192), 576, 3, 1),
    # openai_128's widths
    ((2, 16, 16, 512), 768, 3, 1), ((2, 8, 8, 1024), 1024, 1, 1),
])
def test_bf16_conv_matches_plain(cuda, shape, f, k, stride):
    """Within BF16_CONV_TOL of the plain version, with and without the bias;
    one count per launch."""
    x, w, bias = _bf16_conv_inputs(cuda, shape, f, k, seed=shape[-1] + f)
    for b in (bias, None):
        before = kc.conv_nhwc.launches
        out = kc.conv_nhwc(x, w, b, stride)
        torch.cuda.synchronize()
        assert kc.conv_nhwc.launches == before + 1
        _bf16_conv_gate(out, kc.conv_nhwc_plain(x, w, b, stride))


@pytest.mark.parametrize("m,c,f", [(16, 192, 768), (16, 768, 1536), (1024, 384, 1152),
                                   (128, 576, 576), (195, 128, 1000)])
def test_bf16_conv_dense_view_matches_plain(cuda, m, c, f):
    """The dense view: a 1 x 1 conv over (1, 1, M, C), ragged M and F."""
    g = torch.Generator(device=cuda).manual_seed(c + f)
    x = torch.randn(1, 1, m, c, generator=g, device=cuda).bfloat16()
    w = torch.randn(f, c, 1, 1, generator=g, device=cuda) / c ** 0.5
    bias = 0.1 * torch.randn(f, generator=g, device=cuda)
    out = kc.conv_nhwc(x, w, bias)
    torch.cuda.synchronize()
    _bf16_conv_gate(out, kc.conv_nhwc_plain(x, w, bias))


@pytest.mark.parametrize("shape,f,k,stride", [
    ((64, 64, 192), 192, 3, 1), ((8, 8, 768), 768, 3, 1), ((32, 32, 384), 192, 1, 1),
    ((16, 16, 384), 384, 3, 2), ((1, 16, 768), 1536, 1, 1), ((64, 64, 3), 192, 3, 1)])
def test_bf16_conv_row_is_batch_invariant(cuda, shape, f, k, stride):
    """One example's output bit-identical alone, at rows 0, 3 and 7 of a
    batch of 8 and at rows 0 and 15 of a batch of 16, among random batch
    mates and among zeros."""
    x0, w, bias = _bf16_conv_inputs(cuda, (1, *shape), f, k, seed=f)
    ref = kc.conv_nhwc(x0, w, bias, stride)
    g = torch.Generator(device=cuda).manual_seed(1)
    for batch, row, mates in ((8, 0, "random"), (8, 3, "random"), (8, 7, "zeros"),
                              (16, 0, "zeros"), (16, 15, "random")):
        x = (torch.randn((batch, *shape), generator=g, device=cuda).bfloat16()
             if mates == "random" else torch.zeros((batch, *shape), dtype=torch.bfloat16,
                                                   device=cuda))
        x[row] = x0[0]
        assert torch.equal(kc.conv_nhwc(x, w, bias, stride)[row], ref[0]), (batch, row, mates)


@pytest.mark.parametrize("shape,k,stride", [((2, 16, 16, 384), 3, 1), ((2, 16, 16, 384), 1, 1),
                                            ((2, 16, 16, 384), 3, 2)])
def test_bf16_conv_filter_tiles_give_the_same_bits(cuda, shape, k, stride):
    """wgmma m64n64, m64n128 and m64n192 sum a column block in the same
    order: the three filter tiles give the same bits at F = 384."""
    x, w, bias = _bf16_conv_inputs(cuda, shape, 384, k, seed=7)
    outs = [kc.conv_nhwc(x, w, bias, stride, filter_tile=t) for t in (64, 128, 192)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1)], ids=["halo", "row"])
def test_bf16_conv_tma_and_copy_staging_give_the_same_bits(cuda, k, stride):
    """C = 8: x loaded by TMA, by cp.async (forced) and by byte loads from a
    view one element into its storage, stored by TMA or from registers, give
    the same bits; C = 3 (no tensor map: cp.async) equals C = 8 with five
    zero channels, loaded by TMA."""
    x, w, bias = _bf16_conv_inputs(cuda, (2, 20, 12, 8), 48, k, seed=8)
    tma = kc.conv_nhwc(x, w, bias, stride)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = flat[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    for out in (*(kc.conv_nhwc(x, w, bias, stride, staging=s) for s in kc.STAGINGS),
                kc.conv_nhwc(xv, w, bias, stride), kc.conv_nhwc(x, w, bias, stride, blocks=3,
                                                                staging="copy")):
        assert torch.equal(out, tma)
    _bf16_conv_gate(tma, kc.conv_nhwc_plain(x, w, bias, stride))
    x3, w3 = x[..., :3].contiguous(), w[:, :3].contiguous()
    padded, wpadded = torch.zeros_like(x), torch.zeros_like(w)
    padded[..., :3], wpadded[:, :3] = x3, w3
    out3 = kc.conv_nhwc(x3, w3, bias, stride)
    assert torch.equal(out3, kc.conv_nhwc(padded, wpadded, bias, stride))
    _bf16_conv_gate(out3, kc.conv_nhwc_plain(x3, w3, bias, stride))


@pytest.mark.parametrize("shape,f,k,stride", [
    ((4, 16, 16, 64), 128, 3, 1), ((4, 16, 16, 64), 128, 1, 1), ((3, 30, 18, 40), 72, 3, 2)],
    ids=["halo", "row", "row_s2"])
def test_bf16_conv_persistent_grid_with_fewer_blocks_than_units(cuda, shape, f, k, stride):
    """A grid of 1, 3 or units - 1 blocks walks every work unit (the ring's
    stages and phases carried across units) and gives the bits of one block
    a unit, by TMA and by cp.async."""
    x, w, bias = _bf16_conv_inputs(cuda, shape, f, k, seed=5)
    b, h, wd, _ = shape
    tile = kc.conv_nhwc_plan(h, wd, k, stride, f)[1]
    units = kc.conv_nhwc_units(b, h, wd, k, stride, f, tile)
    assert units > 3
    ref = kc.conv_nhwc(x, w, bias, stride)
    _bf16_conv_gate(ref, kc.conv_nhwc_plain(x, w, bias, stride))
    for blocks in (1, 3, units - 1):
        for staging in ("tma", "copy"):
            assert torch.equal(kc.conv_nhwc(x, w, bias, stride, blocks=blocks, staging=staging),
                               ref), (blocks, staging)


@pytest.mark.parametrize("hw,c", [(8, 96), (16, 96), (16, 384)])
@pytest.mark.parametrize("k", [3, 1], ids=["halo", "row"])
def test_bf16_conv_every_plan_choice_gives_the_same_bits(cuda, hw, c, k):
    """At 8 x 8 and 16 x 16 maps (C = 96: three channel steps, an odd number
    of (step, kernel row) pairs; C = 384: twelve), every filter tile, a
    capped grid and every way to load and store give the bits of the plan's
    choice, each twice: a race between the loads and the products in flight
    shows as bits that move from launch to launch."""
    x, w, bias = _bf16_conv_inputs(cuda, (16, hw, hw, c), 384, k, seed=hw + k + c)
    ref = kc.conv_nhwc(x, w, bias)
    _bf16_conv_gate(ref, kc.conv_nhwc_plain(x, w, bias))
    for tile in kc.FILTER_TILES:
        for blocks in (None, 5):
            for staging in kc.STAGINGS:
                for _ in range(2):
                    out = kc.conv_nhwc(x, w, bias, filter_tile=tile, blocks=blocks,
                                       staging=staging)
                    assert torch.equal(out, ref), (tile, blocks, staging)


@pytest.mark.parametrize("shape,f,k", [((8, 8, 768), 768, 3), ((16, 16, 576), 576, 3),
                                       ((16, 16, 384), 576, 1), ((64, 64, 3), 192, 3)])
def test_bf16_conv_row_is_bit_identical_at_rows_0_7_15_of_batches_1_8_16(cuda, shape, f, k):
    """One example's output at row 0 of a batch of 1 equals it at rows 0 and
    7 of a batch of 8 and rows 0, 7 and 15 of a batch of 16, among random
    batch mates: the plan and the grid change with the batch, the sums do not."""
    x0, w, bias = _bf16_conv_inputs(cuda, (1, *shape), f, k, seed=f + k)
    ref = kc.conv_nhwc(x0, w, bias)[0]
    g = torch.Generator(device=cuda).manual_seed(2)
    for batch in (8, 16):
        for row in (r for r in (0, 7, 15) if r < batch):
            x = torch.randn((batch, *shape), generator=g, device=cuda).bfloat16()
            x[row] = x0[0]
            assert torch.equal(kc.conv_nhwc(x, w, bias)[row], ref), (batch, row)


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)], ids=["halo", "row", "row_s2"])
def test_bf16_conv_on_a_misaligned_view(cuda, k, stride):
    """x a contiguous view one element into its storage (no tensor map, no
    16-byte copy) and C = 72: the byte loads give the aligned call's bits."""
    x, w, bias = _bf16_conv_inputs(cuda, (2, 9, 10, 72), 80, k, seed=11)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = flat[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    out = kc.conv_nhwc(xv, w, bias, stride)
    assert torch.equal(out, kc.conv_nhwc(x, w, bias, stride))
    _bf16_conv_gate(out, kc.conv_nhwc_plain(x, w, bias, stride))


def test_bf16_conv_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(64, 64, 3, 3, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        kc.conv_nhwc(x.float(), w)
    with pytest.raises(NotImplementedError, match="k in"):
        kc.conv_nhwc(x, torch.zeros(64, 64, 5, 5, device=cuda))
    with pytest.raises(ValueError, match="channels"):
        kc.conv_nhwc(x, torch.zeros(64, 32, 3, 3, device=cuda))
    with pytest.raises(ValueError, match="bias"):
        kc.conv_nhwc(x, w, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="staging"):
        kc.conv_nhwc(x, w, staging="bulk")
    with pytest.raises(ValueError, match="blocks"):
        kc.conv_nhwc(x, w, blocks=0)


def test_bf16_conv_model_runs_every_bf16_conv_through_the_kernel(cuda):
    """A bf16 kernels=True model with grad mode off sends every Conv2d call
    to the kernel; under autograd, in f32 and with kernels=False none."""
    from nicediffusion_tpu_torch.models.unet import Conv2d

    cfg = dict(resolution=16, in_channels=3, model_channels=64, out_channels=6,
               num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
               num_heads=2, num_classes=10, resblock_updown=True, use_adaptive_gn=True)
    x = torch.randn(2, 16, 16, 3, device=cuda)
    t, y = torch.tensor([3, 500], device=cuda), torch.tensor([1, 2], device=cuda)
    for dtype, kernels, grad, expect in ((torch.bfloat16, True, False, True),
                                         (torch.bfloat16, True, True, False),
                                         (torch.float32, True, False, False),
                                         (torch.bfloat16, False, False, False)):
        model = DiffusionModel(**cfg, dtype=dtype, kernels=kernels, device=cuda).eval()
        n = sum(isinstance(m, Conv2d) for m in model.modules())
        before = kc.conv_nhwc.launches
        with torch.set_grad_enabled(grad):
            out = model(x, t, y)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert kc.conv_nhwc.launches - before == (n if expect else 0), (dtype, kernels, grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [
    # --model_channels 96 --num_heads 4 (24, 48, 96), 128 with 4 heads at
    # channel_mult 3 (96), and odd ones: not a multiple of 8 (no 16-byte copy)
    (256, 24, 4), (64, 48, 4), (1024, 96, 2), (65, 96, 2), (100, 20, 3), (49, 100, 2),
    (17, 200, 1), (64, 160, 2),
])
def test_k1_k2_at_head_dims_between_builds(cuda, dtype, split_first, n, hc, heads):
    """K1 and K2 at head dims between two builds, on the build for the next
    one up: every element written (outputs pre-filled with NaN), no column
    past the head dim touched, within K1's and K2's gates of their plain
    versions (and K2's relative gate in bf16); the row log-sum-exp too."""
    assert k1.head_dim_build(hc) > hc
    g = torch.Generator(device=cuda).manual_seed(n + hc)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).to(dtype)
    out = torch.full((2, n, heads * hc), float("nan"), dtype=dtype, device=cuda)
    lse = torch.empty(2, heads, n, device=cuda)
    k1.fused_qkv_attention(qkv, heads, split_first, out=out, lse=lse)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k1"])
    q, k, _ = k1.split_qkv(qkv.float(), heads, split_first)
    logits = torch.matmul(q, k.transpose(-1, -2)) * hc ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4, rtol=1e-5)
    dqkv = torch.full_like(qkv, float("nan"))
    k1.fused_qkv_attention_bwd(qkv, cot, out, heads, split_first, lse=lse, out=dqkv)
    torch.cuda.synchronize()
    assert not torch.isnan(dqkv).any()
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, out, heads, split_first, lse)
    torch.testing.assert_close(dqkv.float(), ref.float(), **TOL[dtype, "k2"])
    if dtype == torch.bfloat16:
        assert _k2_rel_err(dqkv, ref, heads, split_first) <= K2_BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n", [17, 64, 65, 256, 1024, k1.RESIDENT_N_LIMIT, k1.RESIDENT_N_LIMIT + 1])
@pytest.mark.parametrize("hc", [257, 300, 320, 384, 512, 768, 1024])
def test_k1_k2_above_256(cuda, dtype, split_first, n, hc):
    """K1 and K2 at head dims above 256, on the chunked build: in bf16 up to
    the N limit the P-resident route (the logits once a tile pair, p or dS
    kept in shared memory), above it and in f32 the walk (a block per chunk
    of the output's columns, each summing the logits over all of D), each
    counted on its route's launch counter: every element written (outputs
    pre-filled with NaN), within K1's and K2's gates of their plain versions
    (and K2's relative gate in bf16); the row log-sum-exp against
    torch.logsumexp. Odd head dims and 300 take the 2-byte staging (no
    16-byte copy, no tensor map)."""
    assert k1.head_dim_build(hc) == k1.CHUNKED
    heads = 2
    route = "resident" if dtype == torch.bfloat16 and n <= k1.RESIDENT_N_LIMIT else "walk"
    g = torch.Generator(device=cuda).manual_seed(n + hc)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).to(dtype)
    out = torch.full((2, n, heads * hc), float("nan"), dtype=dtype, device=cuda)
    lse = torch.full((2, heads, n), float("nan"), device=cuda)
    launches = k1.fused_qkv_attention.launches, k1.fused_qkv_attention_bwd.launches
    routes = dict(k1.route_launches)
    k1.fused_qkv_attention(qkv, heads, split_first, out=out, lse=lse)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    ref = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k1"])
    q, k, _ = k1.split_qkv(qkv.float(), heads, split_first)
    logits = torch.matmul(q, k.transpose(-1, -2)) * hc ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4, rtol=1e-5)
    dqkv = torch.full_like(qkv, float("nan"))
    k1.fused_qkv_attention_bwd(qkv, cot, out, heads, split_first, lse=lse, out=dqkv)
    torch.cuda.synchronize()
    assert (k1.fused_qkv_attention.launches, k1.fused_qkv_attention_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    ran = {key: v - routes.get(key, 0) for key, v in k1.route_launches.items()
           if v != routes.get(key, 0)}
    assert ran == {("K1", route): 1, ("K2", route): 1}
    assert not torch.isnan(dqkv).any()
    ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, out, heads, split_first, lse)
    torch.testing.assert_close(dqkv.float(), ref.float(), **TOL[dtype, "k2"])
    if dtype == torch.bfloat16:
        assert _k2_rel_err(dqkv, ref, heads, split_first) <= K2_BF16_REL


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_k1_k2_above_256_batch_position_independent(cuda, n):
    """One example's bf16 K1 output, row log-sum-exp and K2 gradient at head
    dim 512 are the same bits at positions 0 and 3 of batches 4 and 8 (other
    examples around it; the plan's split follows the batch, the bits do not)."""
    heads, hc = 1, 512
    g = torch.Generator(device=cuda).manual_seed(n)
    row = torch.randn(1, n, 3 * hc, generator=g, device=cuda).bfloat16()
    row_cot = (2 * torch.rand(1, n, hc, generator=g, device=cuda) - 1).bfloat16()
    seen = []
    for batch in (4, 8):
        for pos in (0, 3):
            qkv = torch.randn(batch, n, 3 * hc, generator=g, device=cuda).bfloat16()
            cot = (2 * torch.rand(batch, n, hc, generator=g, device=cuda) - 1).bfloat16()
            qkv[pos], cot[pos] = row[0], row_cot[0]
            lse = torch.empty(batch, heads, n, device=cuda)
            out = k1.fused_qkv_attention(qkv, heads, True, lse=lse)
            dqkv = k1.fused_qkv_attention_bwd(qkv, cot, out, heads, True, lse=lse)
            torch.cuda.synchronize()
            seen.append((out[pos], lse[pos], dqkv[pos]))
    for other in seen[1:]:
        for a, b in zip(seen[0], other):
            assert torch.equal(a, b)


def test_k1_k2_k5_resident_repeat_bit_for_bit(cuda):
    """The P-resident route's K1 (with its lse), K5 on contiguous copies and
    K2 at openai_128's widest one-head call, 20 times each: every result the
    first's bits. A race between the ring's producer and its consumers shows
    in some calls only (a build with four TMA issuers passed every other test
    here and differed in 3 of 60 calls)."""
    g = torch.Generator(device=cuda).manual_seed(512)
    qkv = torch.randn(8, 1024, 3 * 512, generator=g, device=cuda).bfloat16()
    copies = [t.contiguous() for t in k1.split_qkv(qkv, 1, True)]
    qkv2 = torch.randn(2, 1024, 3 * 512, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(2, 1024, 512, generator=g, device=cuda) - 1).bfloat16()
    lse2 = torch.empty(2, 1, 1024, device=cuda)
    out2 = k1.fused_qkv_attention(qkv2, 1, True, lse=lse2)

    def once():
        lse = torch.empty(8, 1, 1024, device=cuda)
        return (k1.fused_qkv_attention(qkv, 1, True, lse=lse), lse, k1.mha_attention(*copies),
                k1.fused_qkv_attention_bwd(qkv2, cot, out2, 1, True, lse=lse2))

    first = once()
    for _ in range(19):
        for a, b in zip(first, once()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("split_first", [False, True])
def test_k2_resident_making_its_lse_repeat_bit_for_bit(cuda, split_first):
    """K2 with no lse handed over (the wrapper launches K1 for it) at two
    heads of 1024 channels, N = 1024 (five ring slots), 50 times: every
    result the first's bits, none NaN. Two consumer warpgroups that waited on
    one full barrier a slot in turn let one pass on a fill still in flight in
    some calls only; this call was where it showed."""
    g = torch.Generator(device=cuda).manual_seed(2048 + split_first)
    qkv = torch.randn(4, 1024, 3 * 2048, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(4, 1024, 2048, generator=g, device=cuda) - 1).bfloat16()
    out = k1.fused_qkv_attention(qkv, 2, split_first)
    first = k1.fused_qkv_attention_bwd(qkv, cot, out, 2, split_first)
    assert not torch.isnan(first).any()
    for _ in range(49):
        assert torch.equal(k1.fused_qkv_attention_bwd(qkv, cot, out, 2, split_first), first)


@pytest.mark.parametrize("hc", [320, 512, 768])
@pytest.mark.parametrize("n", [64, 200])
def test_k1_k2_k5_resident_split_gives_equal_bits(cuda, n, hc):
    """The P-resident route with a row tile's output columns over one block
    and over the most blocks the plan allows (each repeating the logits):
    K1 with its lse, K5 on the views and K2 give the same bits."""
    heads = 2
    most = max(1, -(-hc // 64) // 2)
    g = torch.Generator(device=cuda).manual_seed(n * hc)
    qkv = torch.randn(2, n, 3 * heads * hc, generator=g, device=cuda).bfloat16()
    cot = (2 * torch.rand(2, n, heads * hc, generator=g, device=cuda) - 1).bfloat16()
    views = k1.split_qkv(qkv, heads, False)
    results = []
    for split in (1, most):
        lse = torch.empty(2, heads, n, device=cuda)
        out = k1.fused_qkv_attention(qkv, heads, False, lse=lse, split=split)
        out5 = k1.mha_attention(*views, split=split)
        dqkv = k1.fused_qkv_attention_bwd(qkv, cot, out, heads, False, lse=lse, split=split)
        torch.cuda.synchronize()
        results.append((out, lse, out5, dqkv))
    for a, b in zip(*results):
        assert torch.equal(a, b)
    assert torch.equal(results[0][2].transpose(1, 2).reshape(results[0][0].shape), results[0][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_above_256_equals_k1_on_views(cuda, dtype):
    """K5 at D = 512 on the strided views of a projection and on contiguous
    copies: every element written, within K1's gate of its plain version,
    and equal to K1 on the projection bit for bit (one chunked kernel)."""
    heads, n, d = 2, 256, 512
    g = torch.Generator(device=cuda).manual_seed(d)
    qkv = torch.randn(2, n, 3 * heads * d, generator=g, device=cuda).to(dtype)
    fused = k1.fused_qkv_attention(qkv, heads, True)
    views = k1.split_qkv(qkv, heads, True)
    for q, k, v in (views, tuple(t.contiguous() for t in views)):
        out = torch.full((2, heads, n, d), float("nan"), dtype=dtype, device=cuda)
        k1.mha_attention(q, k, v, out=out)
        torch.cuda.synchronize()
        assert not torch.isnan(out).any()
        torch.testing.assert_close(out.float(), k1.mha_attention_plain(q, k, v).float(),
                                   **TOL[dtype, "k1"])
        assert torch.equal(out.transpose(1, 2).reshape(fused.shape), fused)


# ---------------------------------------------------------------------------
# the Winograd conv (csrc/winograd.cu): against its plain version at the
# bf16 conv's gate (the same V and U, exact products, f32 sums over C in
# another order, one rounding after the bias)
# ---------------------------------------------------------------------------

def _winograd_inputs(dev, shape, f, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn(f, c, 3, 3, generator=g, device=dev) / (9 * c) ** 0.5).bfloat16()
    return x, transform_weights_3x3(w), 0.1 * torch.randn(f, generator=g, device=dev)


@pytest.mark.parametrize("shape,f", [
    # openai_64 (model batch 2 here): a level's convs and decoder inputs
    ((2, 64, 64, 192), 192), ((2, 32, 32, 384), 384), ((2, 16, 16, 576), 576),
    ((2, 8, 8, 768), 768), ((2, 8, 8, 1536), 768), ((2, 32, 32, 960), 384),
    # the stem (C = 3), EMNIST's stem (C = 1) and its odd 7x7 and 14x14 maps,
    # odd and ragged maps, C not a multiple of 8 or of 32, F not of 32 or 2
    ((2, 64, 64, 3), 192), ((3, 28, 28, 1), 64), ((3, 7, 7, 256), 256), ((3, 14, 14, 128), 128),
    ((1, 5, 11, 12), 7), ((2, 9, 7, 40), 24), ((2, 6, 6, 200), 130), ((1, 1, 1, 8), 16),
    ((2, 7, 10, 5), 33),
])
def test_winograd_conv_matches_plain(cuda, shape, f):
    """Within the gate of the plain version, with and without the bias; one
    count per launch."""
    x, u, bias = _winograd_inputs(cuda, shape, f, seed=shape[-1] + f)
    for b in (bias, None):
        before = kw.winograd_conv_nhwc.launches
        out = kw.winograd_conv_nhwc(x, u, b)
        torch.cuda.synchronize()
        assert kw.winograd_conv_nhwc.launches == before + 1
        assert torch.isfinite(out).all()
        _bf16_conv_gate(out, kw.winograd_conv_nhwc_plain(x, u, b))


@pytest.mark.parametrize("shape,f", [((64, 64, 192), 192), ((8, 8, 768), 768),
                                     ((7, 7, 256), 256), ((64, 64, 3), 192)])
def test_winograd_conv_row_is_batch_invariant(cuda, shape, f):
    """One example's output bit-identical alone, at rows 0, 3 and 7 of a
    batch of 8 and at rows 0 and 15 of a batch of 16, among random batch
    mates and among zeros: the plan and the order of sums never see the
    batch."""
    x0, u, bias = _winograd_inputs(cuda, (1, *shape), f, seed=f)
    ref = kw.winograd_conv_nhwc(x0, u, bias)
    g = torch.Generator(device=cuda).manual_seed(1)
    for batch, row, mates in ((8, 0, "random"), (8, 3, "random"), (8, 7, "zeros"),
                              (16, 0, "zeros"), (16, 15, "random")):
        x = (torch.randn((batch, *shape), generator=g, device=cuda).bfloat16()
             if mates == "random" else torch.zeros((batch, *shape), dtype=torch.bfloat16,
                                                   device=cuda))
        x[row] = x0[0]
        assert torch.equal(kw.winograd_conv_nhwc(x, u, bias)[row], ref[0]), (batch, row, mates)


@pytest.mark.parametrize("views", ["x", "u", "x_and_u"])
@pytest.mark.parametrize("shape,f", [((2, 32, 32, 384), 384), ((2, 9, 10, 72), 80)],
                         ids=["32x32", "ragged_9x10"])
def test_winograd_conv_on_a_misaligned_view(cuda, views, shape, f):
    """x, u or both a contiguous view one element into its storage (no
    tensor map and no 16-byte copy for that tensor, while the other, aligned,
    may take its tensor map): the aligned call's bits, within the plain
    version's gate."""
    x, u, bias = _winograd_inputs(cuda, shape, f, seed=f)

    def misaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    xv = misaligned(x) if "x" in views.split("_") else x
    uv = misaligned(u) if "u" in views.split("_") else u
    out = kw.winograd_conv_nhwc(xv, uv, bias)
    assert torch.equal(out, kw.winograd_conv_nhwc(x, u, bias))
    _bf16_conv_gate(out, kw.winograd_conv_nhwc_plain(x, u, bias))


def test_winograd_conv_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor launches or raises: f32 x or u, a u of other channels;
    nothing falls back to the plain version."""
    x, u, bias = _winograd_inputs(cuda, (1, 8, 8, 16), 16)
    before = kw.winograd_conv_nhwc.launches
    with pytest.raises(TypeError):
        kw.winograd_conv_nhwc(x.float(), u, bias)
    with pytest.raises(TypeError):
        kw.winograd_conv_nhwc(x, u.float(), bias)
    with pytest.raises(ValueError):
        kw.winograd_conv_nhwc(x, u[:, :, :8].contiguous(), bias)
    assert kw.winograd_conv_nhwc.launches == before


def test_winograd_model_launches_once_per_conv(cuda):
    """A bf16 DiffusionModel(winograd=True) forward with grad mode off: one
    Winograd launch per WinogradConv, the head and the 1x1 skips on the bf16
    conv; within 5% of its f32 forward."""
    from nicediffusion_tpu_torch.models.unet import WinogradConv

    cfg = dict(resolution=16, in_channels=3, model_channels=64, out_channels=6,
               num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
               num_heads=2, resblock_updown=True, use_adaptive_gn=True, num_classes=5)
    torch.manual_seed(0)
    f32 = DiffusionModel(**cfg, winograd=True, device=cuda).eval()
    with torch.no_grad():  # the zero-initialised output convs take part
        for p in f32.parameters():
            p.add_(0.02 * torch.randn_like(p))
    bf16 = DiffusionModel(**cfg, winograd=True, dtype=torch.bfloat16, device=cuda).eval()
    bf16.load_state_dict(f32.state_dict(), strict=True)
    n = sum(isinstance(m, WinogradConv) for m in bf16.modules())
    x = torch.randn(4, 16, 16, 3, device=cuda)
    t, y = torch.tensor([1, 200, 500, 999], device=cuda), torch.tensor([0, 1, 2, 4], device=cuda)
    before = kw.winograd_conv_nhwc.launches
    with torch.no_grad():
        out, ref = bf16(x, t, y), f32(x, t, y)
    torch.cuda.synchronize()
    assert kw.winograd_conv_nhwc.launches == before + n and n > 0
    assert (out - ref).abs().max() <= 0.05 * ref.abs().max()


# ----------------------------------------------------------------------
# the chain's CUDA graphs (diffusion/graphs.py) against the eager loop
# ----------------------------------------------------------------------

GRAPH_CFG = dict(resolution=16, in_channels=3, model_channels=64, out_channels=6,
                 num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
                 num_heads=2, resblock_updown=True, use_adaptive_gn=True, num_classes=5)
GRAPH_DIFF = dict(original_num_steps=1000, rescaled_num_steps=6, beta_schedule="linear",
                  sampling_var_type="learned_interpolation", loss_type="hybrid",
                  guidance_method="classifier_free", guidance_strength=0.8)


@pytest.mark.parametrize("case", [
    "ddpm", "ddim", "dpm++-cache2-interval", "f32-ddpm", "int8-ddpm", "winograd-ddim",
])
def test_graph_chain_equals_the_eager_chain(cuda, case):
    """A bf16 (or f32) chain at a narrow width: graphed (the default on the
    card) against ``cuda_graph=False`` bit for bit, the generator left in
    the same state; a second graphed chain replays every step, and its
    launches are the eager chain's (the replays' counts added, the capture's
    taken out). Tolerance: none."""
    from nicediffusion_tpu_torch import Diffusion
    from nicediffusion_tpu_torch.diffusion import graphs

    kw = dict(quantized=case.startswith("int8"), winograd=case.startswith("winograd"))
    dtype = None if case.startswith("f32") else torch.bfloat16
    torch.manual_seed(0)
    model = DiffusionModel(**GRAPH_CFG, dtype=dtype, device=cuda, **kw).eval()
    with torch.no_grad():  # the zero-initialised output convs take part
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
    y = torch.tensor([1, 2, 3, 4], device=cuda)
    if kw["quantized"]:
        with torch.no_grad(), model.calibrating():
            model(torch.randn(8, 16, 16, 3, device=cuda), torch.tensor([999, 500] * 4, device=cuda),
                  torch.cat([y, torch.zeros_like(y)]))
        model.freeze_int8(model.int8_calibration())
    dkw = dict(GRAPH_DIFF)
    levers = {}
    if "ddim" in case:
        dkw.update(sampler="ddim", ddim_eta=0.5)
    if "dpm++" in case:
        dkw.update(sampler="dpm++")
        levers = dict(encoder_cache=2, guidance_interval=(0.1, 0.7))
    d = Diffusion(model=model, **dkw)

    def chain(seed, cuda_graph):
        g = torch.Generator(device=cuda).manual_seed(seed)
        out = d.denoise(g, y=y, batch_size=4, cuda_graph=cuda_graph, **levers)
        torch.cuda.synchronize()
        return out, g.get_state()

    graphed, eager = chain(1, None), chain(1, False)
    assert torch.isfinite(eager[0]).all() and d._graphs.graphs
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    before = graphs.read_tallies(graphs.TALLIES)
    eager2 = chain(2, False)
    eager_counts = graphs.tallies_since(graphs.TALLIES, before)
    before = graphs.read_tallies(graphs.TALLIES)
    graphed2 = chain(2, None)
    assert graphs.tallies_since(graphs.TALLIES, before) == eager_counts
    assert torch.equal(graphed2[0], eager2[0])
    assert any(n for n in eager_counts if isinstance(n, int))


# ----------------------------------------------------------------------
# the training steps' CUDA graphs (training/graphs.py) against the eager step
# ----------------------------------------------------------------------

GRAPH_TRAIN_DIFF = dict(original_num_steps=40, rescaled_num_steps=40, beta_schedule="cosine",
                        sampling_var_type="learned_interpolation", loss_type="hybrid",
                        guidance_method="classifier_free", guidance_strength=0.8)


def _graph_model(cuda, seed, dtype=torch.bfloat16, **kw):
    """A narrow UNet with every weight off zero, the same for a given seed."""
    torch.manual_seed(seed)
    model = DiffusionModel(**GRAPH_CFG, dtype=dtype, device=cuda, **kw)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return model


def _train_state(tr):
    """Everything a step updates: parameters, EMA, AdamW's state, the
    accumulated gradients, the generator."""
    out = [p.detach().clone() for p in tr.model.parameters()]
    out += [p.clone() for p in tr.ema_model.parameters()]
    out += [v.clone() for s in tr.optimizer.state.values() for v in s.values()]
    out += [a.clone() for a in (tr._grad_accum or ())]
    return out + [tr.generator.get_state()]


@pytest.mark.parametrize("case", ["k1", "k2", "f32-k1", "winograd-k1"])
def test_graph_train_step_equals_the_eager_step(cuda, monkeypatch, case):
    """``Trainer.train_step`` graphed (the default on the card) against
    ``cuda_graph=False``, from the same weights and seed: bf16 (or f32),
    dropout 0.05 with remat, HYBRID loss under CFG (label drop 0.3), k = 1
    over 5 steps or k = 2 over 6 (the keys' eager first steps, their
    captures and replays). Bit for bit: every step's loss and gradient norm (each
    returned tensor kept), then the parameters, EMA, AdamW's state, the
    accumulators and the generator; the replayed steps' launches equal the
    eager steps'. A ``winograd=True`` model samples the same bits from both
    trainers before and after replayed steps (its U made anew from the
    bumped versions). Tolerance: none."""
    from nicediffusion_tpu_torch import Trainer
    from nicediffusion_tpu_torch.diffusion import graphs
    from nicediffusion_tpu_torch.training.data import synthetic_batches

    k = 2 if case.endswith("k2") else 1
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    # in f32 cuDNN's default weight-gradient algorithms do not repeat their
    # bits from run to run (eager against eager differs): graph and eager are
    # held to each other on its deterministic algorithms there
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", dtype == torch.float32)

    def trainer(cuda_graph):
        model = _graph_model(cuda, 3, dtype, dropout=0.05, use_remat=True,
                             winograd=case.startswith("winograd"))
        loader = synthetic_batches(4, 16, 3, 5, seed=1)
        return Trainer(model, GRAPH_TRAIN_DIFF, loader, iterations=5, batch_size=4, lr=1e-3,
                       weight_decay=1e-3, ema_rate=0.9, grad_accumulation=k,
                       label_drop_prob=0.3, seed=7, device=cuda, cuda_graph=cuda_graph,
                       checkpoint_dir="unused")

    def steps(tr, n):
        out = [tr.train_step(*next(tr.loader)) for _ in range(n)]
        torch.cuda.synchronize()
        return out

    graphed, eager = trainer(None), trainer(False)
    runs = {}
    for name, tr in (("graph", graphed), ("eager", eager)):
        first = steps(tr, 2 * k)
        samples = [tr.sample(2)] if case.startswith("winograd") else []
        before = graphs.read_tallies(graphs.TALLIES)
        rest = steps(tr, 3 if k == 1 else 2)
        counts = graphs.tallies_since(graphs.TALLIES, before)
        if samples:
            samples.append(tr.sample(2))
        runs[name] = (first + rest, counts, samples, _train_state(tr))
    assert graphed._graphs.graphs and not eager._graphs.graphs
    (g_metrics, g_counts, g_samples, g_state), (e_metrics, e_counts, e_samples, e_state) = (
        runs["graph"], runs["eager"])
    for a, b in zip(g_metrics, e_metrics):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"], b["grad_norm"])
    assert len({m["loss"].item() for m in g_metrics}) == len(g_metrics)  # each step's own
    assert all(torch.equal(a, b) for a, b in zip(g_state, e_state))
    assert g_counts == e_counts and any(n for n in e_counts if isinstance(n, int))
    for a, b in zip(g_samples, e_samples):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rate", ["host", "tensor"])
def test_graph_capturable_adamw_matches_the_plain_adamw(cuda, rate):
    """``make_adamw`` on the card (capturable: the step counts on the card,
    the bias corrections and the decay computed there in f32), which the
    graphed and the eager steps both take, against ``torch.optim.AdamW``
    with ``capturable=False`` (the optimizer the CPU tests hold to optax):
    5 updates from the same f32 parameters (0.05 N(0, 1)) and gradients
    (four shapes, four scales), weight decay 0.1, the rate moving each
    update, written as a host float or filled into the device tensor as the
    distillers' schedule fills it. Tolerance: the moments to 1e-6 of their
    largest element; each parameter's change from its start to 5e-5 of its
    largest change (f32's rounding of 1 - 0.999 ** step moves the update by
    about 1e-5 of itself; a decay left out moves it by 5e-3)."""
    from nicediffusion_tpu_torch.training.graphs import make_adamw

    g = torch.Generator(device=cuda).manual_seed(11)
    shapes = [(64, 3, 3, 32), (256,), (512, 128), (7,)]
    start = [0.05 * torch.randn(s, generator=g, device=cuda) for s in shapes]
    grads = [[torch.randn(s, generator=g, device=cuda) * 10.0 ** -i
              for i, s in enumerate(shapes)] for _ in range(5)]
    rates = [1e-2 * (0.5 + 0.25 * i) for i in range(5)]
    ours = [p.clone().requires_grad_() for p in start]
    plain = [p.clone().requires_grad_() for p in start]
    opt = make_adamw(ours, rates[0], 0.1, tensor_lr=rate == "tensor")
    ref = torch.optim.AdamW(plain, lr=rates[0], betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
                            capturable=False)
    assert opt.defaults["capturable"]
    for gs, r in zip(grads, rates):
        if rate == "tensor":
            opt.param_groups[0]["lr"].fill_(r)
        else:
            opt.param_groups[0]["lr"] = r
        ref.param_groups[0]["lr"] = r
        for p, q, grad in zip(ours, plain, gs):
            p.grad, q.grad = grad.clone(), grad.clone()
        opt.step()
        ref.step()
    torch.cuda.synchronize()
    for p, q, s in zip(ours, plain, start):
        assert opt.state[p]["step"].device.type == "cuda" and float(opt.state[p]["step"]) == 5
        for k in ("exp_avg", "exp_avg_sq"):
            a, b = opt.state[p][k], ref.state[q][k]
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
        ours_d, plain_d = (p - s).detach(), (q - s).detach()
        assert (ours_d - plain_d).abs().max() <= 5e-5 * plain_d.abs().max()


@pytest.mark.parametrize("case", ["guided", "progressive"])
def test_graph_distill_step_equals_the_eager_step(cuda, case):
    """Both distillers' ``train_step`` graphed against ``cuda_graph=False``
    over 4 steps, bf16, the warmup-cosine rate (a device tensor filled each
    step), the clip, the variance term: every step's metrics, the student,
    EMA, AdamW's state and the generator bit for bit; the replays' launches
    the eager steps'. Tolerance: none."""
    from nicediffusion_tpu_torch.diffusion import graphs
    from nicediffusion_tpu_torch.training import distill
    from nicediffusion_tpu_torch.training.data import synthetic_batches

    dargs = dict(GRAPH_TRAIN_DIFF, rescaled_num_steps=20)
    teacher = _graph_model(cuda, 4).state_dict()

    def distiller(cuda_graph):
        model = _graph_model(cuda, 5)
        loader = synthetic_batches(4, 16, 3, 5, seed=2)
        kw = dict(model=model, teacher_params=teacher, diffusion_args=dargs,
                  dataloader=loader, iterations=8, lr=1e-3, ema_rate=0.9, seed=9,
                  lr_schedule="warmup_cosine", var_weight=1.0, cuda_graph=cuda_graph)
        if case == "guided":
            return distill.GuidedDistiller(guidance_strength=0.8, **kw)
        return distill.ProgressiveDistiller(**kw)

    runs = {}
    for name, cuda_graph in (("graph", None), ("eager", False)):
        d = distiller(cuda_graph)
        metrics = [d.train_step(*next(d.loader)) for _ in range(2)]
        torch.cuda.synchronize()
        before = graphs.read_tallies(graphs.TALLIES)
        metrics += [d.train_step(*next(d.loader)) for _ in range(2)]
        torch.cuda.synchronize()
        counts = graphs.tallies_since(graphs.TALLIES, before)
        state = [p.detach().clone() for p in d.model.parameters()]
        state += [p.clone() for p in d.ema_model.parameters()]
        state += [v.clone() for s in d.optimizer.adamw.state.values() for v in s.values()]
        runs[name] = (metrics, counts, state + [d.generator.get_state()], d)
    (g_metrics, g_counts, g_state, g), (e_metrics, e_counts, e_state, _) = (
        runs["graph"], runs["eager"])
    assert g._graphs.graphs
    for a, b in zip(g_metrics, e_metrics):
        assert all(torch.equal(a[n], b[n]) for n in ("loss", "loss_eps", "loss_var", "grad_norm"))
    assert all(torch.equal(a, b) for a, b in zip(g_state, e_state))
    assert g_counts == e_counts and any(n for n in e_counts if isinstance(n, int))


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_graph_classifier_guided_chain_equals_the_eager_chain(cuda, sampler):
    """A classifier-guided chain (a narrow bf16 UNet and noisy classifier):
    graphed, the classifier's gradient inside each step's graph, against
    ``cuda_graph=False`` bit for bit, the generator too; a second graphed
    chain replays every step with the eager chain's launches (K2 and K3's
    backward among them). Tolerance: none."""
    from nicediffusion_tpu_torch import Diffusion, EncoderUNet
    from nicediffusion_tpu_torch.diffusion import graphs

    model = _graph_model(cuda, 6).eval()
    torch.manual_seed(8)
    cls = EncoderUNet(resolution=16, in_channels=3, model_channels=32, out_channels=5,
                      num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
                      num_head_channels=32, resblock_updown=True, use_adaptive_gn=True,
                      dtype=torch.bfloat16, device=cuda)
    with torch.no_grad():
        for p in cls.parameters():
            p.add_(0.02 * torch.randn_like(p))
    dkw = dict(GRAPH_DIFF, rescaled_num_steps=6, guidance_method="classifier",
               guidance_strength=1.0, classifier=cls)
    if sampler == "ddim":
        dkw.update(use_ddim=True, ddim_eta=0.5)
    d = Diffusion(model=model, **dkw)
    y = torch.tensor([1, 2, 3, 4], device=cuda)

    def chain(seed, cuda_graph):
        g = torch.Generator(device=cuda).manual_seed(seed)
        out = d.denoise(g, y=y, batch_size=4, cuda_graph=cuda_graph)
        torch.cuda.synchronize()
        return out, g.get_state()

    graphed, eager = chain(1, None), chain(1, False)
    assert torch.isfinite(eager[0]).all() and d._graphs.graphs
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    before = graphs.read_tallies(graphs.TALLIES)
    eager2 = chain(2, False)
    eager_counts = graphs.tallies_since(graphs.TALLIES, before)
    before = graphs.read_tallies(graphs.TALLIES)
    graphed2 = chain(2, None)
    assert graphs.tallies_since(graphs.TALLIES, before) == eager_counts
    assert torch.equal(graphed2[0], eager2[0])
    assert eager_counts[1] > 0  # K2 launched in the classifier's backward
