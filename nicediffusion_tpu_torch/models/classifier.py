"""Noisy-image classifier for classifier guidance (EncoderUNet, NHWC, torch).

Counterpart of nicediffusion_tpu/models/classifier.py. The checkpoints users
have (OpenAI ``64x64_classifier.pt`` and its 128 and 256 siblings) are
guided-diffusion ``EncoderUNetModel``s: the UNet's encoder trunk and middle
block, then a norm/SiLU/attention-pool classification head. This module
builds it from the same blocks as models/unet.py.

  * encoder trunk: DiffusionModel's ``downsampling`` and ``middle_block``
    stacks (reference model.py:363-412) without the skip bookkeeping,
    BigGAN up/down residual blocks and AdaGN included;
  * the trunk's attention blocks use guided-diffusion's legacy head order
    (``split_qkv_first=False``, kernel K1's interleaved layout);
  * attention pool (guided-diffusion ``AttentionPool2d``): tokens =
    [mean(x) | x] + positional embedding, a fused qkv projection, multi-head
    attention in the new order (``split_qkv_first=True`` whatever the
    trunk's), an output projection, and the first (mean) token as the pooled
    feature. Its token count H*W + 1 is ragged for K1 and K2 (65 at every
    preset);
  * the 'adaptive' pool: GN -> SiLU -> global mean -> zero-init 1x1 conv.

Parameter names are guided-diffusion's after the rename map of
utils/convert.py (``downsampling.{i}.{j}``, ``out.0``,
``out.2.positional_embedding``, ``out.2.qkv_proj``, ``out.2.c_proj``;
``out.3`` for the adaptive head's conv), so a raw ``*_classifier.pt``, a
converted one and the JAX package's tree through
``flax_params_to_torch_state_dict`` all load with ``strict=True``.
``positional_embedding`` keeps torch's (C, N+1) shape and is transposed in
``forward`` (the JAX side holds (N+1, C)). Precision follows models/unet.py:
f32 parameters cast to the compute ``dtype`` per call; logits leave in f32.
``device=None`` means the CUDA card (utils/device.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.attention import qkv_attention
from ..ops.math import timestep_embedding
from ..utils.device import resolve_device
from .unet import (
    AttentionBlock,
    Conv2d,
    Downsample,
    EmbedMLP,
    GroupNormOp,
    Linear,
    ResidualBlock,
    StepSequential,
)

__all__ = ["AttentionPool", "EncoderUNet"]


class AttentionPool(nn.Module):
    """CLIP-style attention pooling (guided-diffusion AttentionPool2d).

    (B, H, W, C) -> f32 (B, out_features): prepend the mean token, add the
    learned positional embedding, run one multi-head attention over all
    H*W + 1 tokens, and return the projected mean-token output.
    """

    def __init__(self, spatial_dim: int, channels: int, num_head_channels: int,
                 out_features: int, dtype=None, kernels: bool = True, device=None):
        super().__init__()
        if channels % num_head_channels:
            raise ValueError(
                f"channels {channels} not divisible by num_head_channels {num_head_channels}"
            )
        self.heads, self.kernels = channels // num_head_channels, kernels
        self.positional_embedding = nn.Parameter(
            torch.randn(channels, spatial_dim**2 + 1, device=device) / channels**0.5
        )
        self.qkv_proj = Linear(channels, 3 * channels, conv1d_weight=True,
                               dtype=dtype, device=device)
        self.c_proj = Linear(channels, out_features, conv1d_weight=True,
                             dtype=dtype, device=device)

    def forward(self, x):
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.T[None].to(tokens.dtype)
        qkv = self.qkv_proj(tokens)
        # AttentionPool2d hardcodes the new attention order (q|k|v split
        # first), regardless of the trunk's order
        out = qkv_attention(qkv, self.heads, True, kernels=self.kernels)
        return self.c_proj(out)[:, 0].float()


class _AdaptivePool(nn.Module):
    """Global mean over H and W, (B, H, W, C) -> (B, 1, 1, C)."""

    def forward(self, x):
        return x.mean(dim=(1, 2), keepdim=True)


class _Squeeze(nn.Module):
    """(B, 1, 1, F) -> f32 (B, F)."""

    def forward(self, x):
        return x[:, 0, 0, :].float()


def _attention_pool_head(features, spatial_dim, num_head_channels, out_features,
                         dtype, kernels, device):
    """GN -> SiLU -> AttentionPool at indices 0, 1, 2 of torch's
    ``out = Sequential(norm, SiLU, AttentionPool2d)``; the SiLU is fused
    into the GroupNorm."""
    return nn.Sequential(
        GroupNormOp(features, "silu", kernels=kernels, device=device),
        nn.Identity(),
        AttentionPool(spatial_dim, features, num_head_channels, out_features,
                      dtype=dtype, kernels=kernels, device=device),
    )


def _adaptive_pool_head(features, out_features, dtype, kernels, device):
    """GN -> SiLU -> global mean pool -> zero-init 1x1 conv, the conv at
    index 3 as in torch's ``Sequential(norm, SiLU, AdaptiveAvgPool2d(1),
    zero_conv, Flatten)``."""
    return nn.Sequential(
        GroupNormOp(features, "silu", kernels=kernels, device=device),
        nn.Identity(),
        _AdaptivePool(),
        Conv2d(features, out_features, 1, zero_init=True, dtype=dtype, device=device,
               kernels=kernels),
        _Squeeze(),
    )


class EncoderUNet(nn.Module):
    """Half-UNet noisy classifier: ``(x[B,H,W,C], timestep[B]) -> f32 logits``.

    ``timestep`` follows whatever convention the checkpoint was trained
    with; when driven by Diffusion's classifier-guidance hook it receives
    the *rescaled* timestep (the reference quirk, reference diffusion.py:301).
    ``out_channels`` is the number of classes. ``generator`` feeds dropout
    masks and is needed only in ``train()`` mode with ``dropout > 0``.
    """

    def __init__(
        self,
        resolution: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 1,
        num_head_channels: int | None = None,
        resblock_updown: bool = False,
        use_adaptive_gn: bool = False,
        # guided-diffusion classifiers use the legacy head order in the trunk
        split_qkv_first: bool = False,
        pool: str = "attention",
        dtype: torch.dtype | None = None,
        kernels: bool = True,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.resolution, self.in_channels = resolution, in_channels
        self.model_channels, self.dtype, self.kernels = model_channels, dtype, kernels
        emb_dim = 4 * model_channels
        kw = dict(dtype=dtype, device=device)

        def res(cin, cout, down=False):
            return ResidualBlock(cin, cout, emb_dim, downsample=down,
                                 use_adaptive_gn=use_adaptive_gn, dropout=dropout,
                                 kernels=kernels, **kw)

        def attn(ch):
            return AttentionBlock(ch, num_heads, num_head_channels, split_qkv_first,
                                  kernels=kernels, **kw)

        self.step_embed = EmbedMLP(model_channels, emb_dim, **kw)

        # encoder trunk: the construction of DiffusionModel's (reference
        # model.py:363-412) without the skip bookkeeping
        ch = int(model_channels * channel_mult[0])
        curr_res = resolution
        down = [StepSequential([Conv2d(in_channels, ch, 3, kernels=kernels, **kw)])]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(model_channels * mult))]
                ch = int(model_channels * mult)
                if curr_res in attention_resolutions:
                    layers.append(attn(ch))
                down.append(StepSequential(layers))
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    down.append(StepSequential([res(ch, ch, down=True)]))
                else:
                    down.append(StepSequential([Downsample(ch, conv_resample, kernels=kernels,
                                                           **kw)]))
                curr_res //= 2
        self.downsampling = nn.ModuleList(down)
        self.middle_block = StepSequential([res(ch, ch), attn(ch), res(ch, ch)])

        if pool == "attention":
            if num_head_channels is None:
                raise ValueError("attention pool needs num_head_channels")
            self.out = _attention_pool_head(ch, curr_res, num_head_channels, out_channels,
                                            dtype, kernels, device)
        elif pool == "adaptive":
            self.out = _adaptive_pool_head(ch, out_channels, dtype, kernels, device)
        else:
            raise NotImplementedError(f"pool={pool!r}")

    def forward(self, x, timestep, generator=None):
        emb = self.step_embed(timestep_embedding(timestep, self.model_channels))
        x = x.to(self.dtype or x.dtype)
        for module in self.downsampling:
            x = module(x, emb, generator)
        x = self.middle_block(x, emb, generator)
        return self.out(x)
