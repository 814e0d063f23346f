"""Spatial resampling primitives on NHWC tensors (torch).

Counterpart of nicediffusion_tpu/ops/resize.py: the 2x nearest upsample and
the 2x2 average pool of the original reference (model.py:77, 111).
``resize_bilinear`` is used only by the super-resolution model and waits
for it (ROADMAP queue A, "SR and ESRGAN").
"""

from __future__ import annotations

import torch

__all__ = ["upsample_nearest_2x", "avg_pool_2x"]


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of an NHWC tensor."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
