"""GroupNorm (NHWC) with optional fused SiLU / AdaGN epilogues (torch).

Counterpart of nicediffusion_tpu/ops/groupnorm.py: the original reference's
``nn.GroupNorm(32, C, eps=1e-5)`` followed by SiLU and, in AdaGN mode, the
per-channel ``(1 + scale) * GN(h) + shift`` modulation. The plain versions
here are the JAX package's plain ops, line for line: f32 statistics,
biased variance, output in x's dtype (the AdaGN path rounds the normalised
value to x's dtype before modulating, as the JAX op does).

``kernels=True`` (the model's default) sends every call to kernel K3
(ops/kernels/groupnorm.py), which takes the plain version of its own on a
CPU tensor and the Triton kernel on a CUDA tensor. The JAX package keeps
its TPU kernel opt-in for a TPU-only DMA reason; the port does not.
"""

from __future__ import annotations

import torch

from .kernels.groupnorm import group_norm_fused, group_stats

__all__ = ["group_norm", "group_norm_silu", "ada_group_norm_silu"]


def _check_groups(c: int, num_groups: int) -> None:
    if c % num_groups:
        # same constraint as the reference's GroupNorm32(32, channels)
        raise ValueError(
            f"GroupNorm: channels {c} not divisible by num_groups "
            f"{num_groups} (model_channels * channel_mult must be "
            f"multiples of 32 at every level, like the reference)"
        )


def _plain_group_norm(x, scale, bias, num_groups=32, eps=1e-5):
    b, h, w, c = x.shape
    xg, mean, var = group_stats(x, num_groups)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _silu_f32(x):
    x = x.float()
    return x * torch.sigmoid(x)


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
               kernels: bool = True):
    """Plain GroupNorm over NHWC, channel c in group c // (C/G)."""
    _check_groups(x.shape[-1], num_groups)
    if kernels:
        return group_norm_fused(
            x, scale, bias, num_groups=num_groups, eps=eps, silu=False
        )
    return _plain_group_norm(x, scale, bias, num_groups, eps)


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                    kernels: bool = True):
    """GroupNorm followed by SiLU (reference model.py:190)."""
    _check_groups(x.shape[-1], num_groups)
    if kernels:
        return group_norm_fused(
            x, scale, bias, num_groups=num_groups, eps=eps, silu=True
        )
    out = _plain_group_norm(x, scale, bias, num_groups, eps)
    return _silu_f32(out).to(x.dtype)


def ada_group_norm_silu(x, scale, bias, emb_scale, emb_shift,
                        num_groups: int = 32, eps: float = 1e-5,
                        kernels: bool = True):
    """Adaptive GroupNorm ``SiLU((1 + s) * GN(h) + b)`` with per-example
    (B, C) modulation (reference model.py:199-207)."""
    _check_groups(x.shape[-1], num_groups)
    if kernels:
        return group_norm_fused(
            x, scale, bias, emb_scale, emb_shift,
            num_groups=num_groups, eps=eps, silu=True,
        )
    out = _plain_group_norm(x, scale, bias, num_groups, eps).float()
    out = out * (1.0 + emb_scale[:, None, None, :].float())
    out = out + emb_shift[:, None, None, :].float()
    return _silu_f32(out).to(x.dtype)
