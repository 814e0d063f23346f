"""Gaussian math helpers and sinusoidal timestep embeddings (torch).

Counterpart of nicediffusion_tpu/ops/math.py, itself the analogue of the
original reference's diffusion.py:499-549 (kl_div, approx_cdf,
log_likelihood, mean_flat) and model.py:514-523 (timestep_embedding).
Plain functions on tensors.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "kl_div",
    "approx_cdf",
    "discretized_gaussian_log_likelihood",
    "mean_flat",
    "timestep_embedding",
]


def kl_div(mean_1, log_var_1, mean_2, log_var_2):
    """KL divergence between two diagonal Gaussians, in nats."""
    return (
        (log_var_2 - log_var_1)
        + torch.exp(log_var_1 - log_var_2)
        + ((mean_1 - mean_2) ** 2) * torch.exp(-log_var_2)
        - 1.0
    ) / 2


def approx_cdf(x):
    """Page (1977) tanh approximation of the standard normal CDF, with the
    reference's 0.0444715 constant."""
    y = math.sqrt(2.0 / math.pi) * (x + 0.0444715 * (x**3))
    return 0.5 * (1.0 + torch.tanh(y))


def discretized_gaussian_log_likelihood(target, mean, log_var):
    """Log-likelihood of a Gaussian discretized to 256 image bins, in nats.

    `target` must be in [-1, 1]: bins of width 2/255, edge bins for
    target <= -0.999 / >= 0.999, CDFs floored at 1e-12 before the log.
    """
    assert target.shape == mean.shape == log_var.shape
    std_recip = torch.exp(-0.5 * log_var)
    centered = target - mean

    plus = (centered + 1.0 / 255.0) * std_recip
    minus = (centered - 1.0 / 255.0) * std_recip
    cdf_minus, cdf_plus = approx_cdf(minus), approx_cdf(plus)
    cdf_delta = cdf_plus - cdf_minus

    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_minus = torch.log((1.0 - cdf_minus).clamp(min=1e-12))
    return torch.where(
        target < -0.999,
        log_cdf_plus,
        torch.where(
            target > 0.999,
            log_one_minus_cdf_minus,
            torch.log(cdf_delta.clamp(min=1e-12)),
        ),
    )


def mean_flat(x):
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def timestep_frequencies(half: int, max_period: int = 10000, device=None) -> torch.Tensor:
    """The embedding's f32 frequencies exp(-log(max_period) k / half), k < half."""
    return torch.exp(
        torch.arange(half, dtype=torch.float32, device=device) * (-math.log(max_period) / half)
    )


def timestep_embedding(timesteps, embedding_dim: int, max_period: int = 10000):
    """Sinusoidal timestep embedding in f32, [cos | sin] channel order.

    The original reference concatenates **cos first, then sin**, which
    matters for checkpoint parity. Odd embedding_dim is zero-padded.
    """
    freqs = timestep_frequencies(embedding_dim // 2, max_period, timesteps.device)
    args = timesteps[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
