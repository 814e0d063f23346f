"""K1 (CUDA C++) and K3 (Triton) against their plain torch versions on the card.

Every test here needs an NVIDIA card and is marked ``cuda``; without one it
skips. On a machine with a card run:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

This file imports no JAX, so it runs where only torch is installed;
``--noconftest`` skips tests/conftest.py, which imports jax.
"""

import pytest
import torch

from nicediffusion_tpu_torch.ops.kernels import attention as k1
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3

pytestmark = pytest.mark.cuda

# the JAX package's Pallas gates (tests/test_pallas.py); bf16 GN outputs
# reach ~10, where one bf16 ulp is 0.06, hence its rtol (test_pallas.py:206)
TOL = {
    (torch.float32, "k1"): dict(atol=2e-5, rtol=0),
    (torch.bfloat16, "k1"): dict(atol=3e-2, rtol=0),
    (torch.float32, "k3"): dict(atol=1e-5, rtol=0),
    (torch.bfloat16, "k3"): dict(atol=3e-2, rtol=1e-2),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_first", [True, False])
@pytest.mark.parametrize("n,hc,heads", [
    (1024, 64, 6), (256, 64, 9), (64, 64, 12), (196, 32, 2), (49, 64, 4), (100, 128, 2),
])
def test_k1_matches_plain(cuda, dtype, split_first, n, hc, heads):
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(4, n, 3 * heads * hc, generator=g, device=cuda).to(dtype)
    before = k1.fused_qkv_attention.launches
    out = k1.fused_qkv_attention(qkv, heads, split_first)
    torch.cuda.synchronize()
    assert k1.fused_qkv_attention.launches == before + 1
    ref = k1.fused_qkv_attention_plain(qkv, heads, split_first)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k1"])


def test_k1_refuses_what_it_does_not_take(cuda):
    with pytest.raises(NotImplementedError, match="head dim 192"):
        k1.fused_qkv_attention(torch.zeros(1, 64, 3 * 384, device=cuda), 2, True)
    with pytest.raises(TypeError):
        k1.fused_qkv_attention(torch.zeros(1, 64, 3 * 128, device=cuda).half(), 2, True)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_qkv_attention(torch.zeros(1, 3 * 128, 64, device=cuda).mT, 2, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "silu", "ada"])
@pytest.mark.parametrize("shape", [(4, 64, 64, 384), (4, 8, 8, 1536), (3, 7, 7, 96)])
def test_k3_matches_plain(cuda, dtype, mode, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    b, _, _, c = shape
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    sc = torch.randn(c, generator=g, device=cuda)
    bi = torch.randn(c, generator=g, device=cuda)
    emb = (0.1 * torch.randn(b, 2 * c, generator=g, device=cuda)).to(dtype)
    es, esh = emb.chunk(2, dim=-1) if mode == "ada" else (None, None)
    before = k3.group_norm_fused.launches
    out = k3.group_norm_fused(x, sc, bi, es, esh, silu=mode != "plain")
    torch.cuda.synchronize()
    assert k3.group_norm_fused.launches == before + 1
    ref = k3.group_norm_fused_plain(x, sc, bi, es, esh, silu=mode != "plain")
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype, "k3"])
