"""Multi-head QKV self-attention over flattened image tokens (torch).

Counterpart of nicediffusion_tpu/ops/attention.py. The fused qkv projection
has two channel layouts, selected by ``split_qkv_first`` (see
:func:`split_qkv`); both compute the same softmax(q k^T * hc^-0.5) v and
give the same output order (head h in channels [h*hc, (h+1)*hc)). Logits
and softmax run in f32 for every input dtype.

``kernels=True`` (the model's default) sends the call to kernel K1
(ops/kernels/attention.py), which takes its plain version on a CPU tensor
and the CUDA kernel on a CUDA tensor; when a gradient is wanted the call is
a ``torch.autograd.Function`` whose backward is kernel K2, the counterpart
of the JAX package's custom VJP. ``kernels=False`` is the plain version
everywhere, differentiated by autograd.
"""

from __future__ import annotations

import torch

from .kernels.attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    split_qkv,
)

__all__ = ["split_qkv", "qkv_attention"]


def qkv_attention(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool,
    kernels: bool = True,
) -> torch.Tensor:
    """softmax(q k^T * hc^-0.5) v over a (B, N, 3C) projection -> (B, N, C)."""
    if kernels:
        return fused_qkv_attention(qkv, num_heads, split_qkv_first)
    return fused_qkv_attention_plain(qkv, num_heads, split_qkv_first)
