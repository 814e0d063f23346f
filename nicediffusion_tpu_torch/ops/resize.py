"""Spatial resampling primitives on NHWC tensors (torch).

Counterpart of nicediffusion_tpu/ops/resize.py: the 2x nearest upsample and
the 2x2 average pool of the original reference (model.py:77, 111), and the
bilinear resize the super-resolution model and the ESRGAN stage's display
use (reference model.py:497, scripts/sample.py:137).
"""

from __future__ import annotations

import torch

__all__ = ["upsample_nearest_2x", "avg_pool_2x", "resize_bilinear"]


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of an NHWC tensor."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The (n_in, n_out) weight matrix of one axis of
    ``jax.image.resize(..., "linear")`` (antialias on, its default), made in
    float32 as JAX makes it: half-pixel centres, the triangle kernel widened
    by the downsampling factor, each column renormalised over the taps inside
    the image, zero where the centre falls outside."""
    f32 = torch.float32
    # made on the device (no host copy, so a CUDA graph can capture it)
    inv = 1.0 / torch.full((), n_out / n_in, dtype=f32, device=device)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv - 0.5
    taps = torch.arange(n_in, dtype=f32, device=device)[:, None]
    w = (1.0 - (sample[None, :] - taps).abs() / torch.clamp(inv, min=1.0)).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to (height, width): the JAX
    package's ``jax.image.resize(..., "linear")``, as the same two weight
    matrices contracted with x. Half-pixel centres (torch's
    align_corners=False); at the border JAX renormalises the weights over
    the taps inside, which for upsampling is what ``F.interpolate`` gets by
    clamping the source coordinate to the edge."""
    _, h, w, _ = x.shape
    wh = _linear_weights(h, height, x.device).to(x.dtype)
    ww = _linear_weights(w, width, x.device).to(x.dtype)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)
