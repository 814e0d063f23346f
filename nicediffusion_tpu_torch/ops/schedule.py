"""Noise schedules, IDDPM timestep respacing, and diffusion coefficient tables.

Numpy-only copy of nicediffusion_tpu/ops/schedule.py (the JAX package cannot
be imported without jax). All schedule precomputation happens on the host in
numpy float64, like the original reference's diffusion.py:87-130, 445-475;
diffusion/process.py casts the tables to float32 device tensors once, at
construction. The tables must stay bit-equal to the JAX package's
(tests/test_torch_schedule.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "get_beta_schedule",
    "respace_betas",
    "respace_betas_karras",
    "DiffusionSchedule",
]


def get_beta_schedule(
    schedule_method: str,
    num_steps: int,
    beta_0: float | None = None,
    beta_T: float | None = None,
) -> np.ndarray:
    """Noise-variance (beta) schedule, float64.

    Mirrors reference diffusion.py:445-475:
      - 'linear':   np.linspace(beta_0, beta_T, num_steps)
      - 'constant': beta_0 everywhere
      - 'cosine':   IDDPM eq. 17 with s=0.008, clipped at 0.999

    beta_0/beta_T default to the T-invariant values the reference uses
    (diffusion.py:88-89): 0.0001*1000/T and 0.02*1000/T.
    """
    if beta_0 is None:
        beta_0 = 0.0001 * 1000 / num_steps
    if beta_T is None:
        beta_T = 0.02 * 1000 / num_steps

    if schedule_method == "linear":
        return np.linspace(beta_0, beta_T, num_steps, dtype=np.float64)
    elif schedule_method == "constant":
        return beta_0 * np.ones(num_steps, dtype=np.float64)
    elif schedule_method == "cosine":
        # IDDPM eq. 17; f(t) = cos((t + s)/(1 + s) * pi/2)^2 with s = 0.008.
        def f(t: float) -> float:
            s = 0.008
            return math.cos((t + s) / (1.0 + s) * math.pi / 2) ** 2

        betas = []
        for step in range(num_steps):
            frac_prev = step / num_steps
            frac = (step + 1) / num_steps
            betas.append(min(1 - f(frac) / f(frac_prev), 0.999))
        return np.array(betas, dtype=np.float64)
    else:
        raise NotImplementedError(
            f"unimplemented variance scheduling method: {schedule_method}"
        )


def respace_betas(
    betas: np.ndarray, rescaled_num_steps: int
) -> tuple[np.ndarray, np.ndarray]:
    """Rescale an original-length beta chain to `rescaled_num_steps` steps.

    IDDPM eq. 19 as implemented at reference diffusion.py:94-111: keep
    alphas_cumprod at the strided original indices
    ``range(T//(2S), T + T//(2S), T//S)`` and recompute betas as
    ``1 - abar_i / abar_last``.

    Returns (new_betas[S], timestep_map[S]) where timestep_map maps a rescaled
    index to its original-chain timestep (e.g. T=1000, S=25 -> [20, 60, ..., 980]).
    """
    original_num_steps = len(betas)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    stride = original_num_steps // rescaled_num_steps
    half = original_num_steps // (2 * rescaled_num_steps)
    candidate = range(half, original_num_steps + half, stride)
    # The reference iterates over all original indices and keeps members of the
    # candidate set, so indices >= T are implicitly dropped.
    timestep_map = np.array([i for i in candidate if i < original_num_steps])

    return _betas_from_kept_indices(alphas_cumprod, timestep_map), timestep_map


def _betas_from_kept_indices(
    alphas_cumprod: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Recompute betas for a kept-index subset of a chain (the eq.-19 rule:
    beta_j = 1 - abar_j / abar_prev-kept), shared by every respacing mode."""
    new_betas, last = [], 1.0
    for j in indices:
        new_betas.append(1.0 - alphas_cumprod[j] / last)
        last = alphas_cumprod[j]
    new_betas = np.array(new_betas, dtype=np.float64)
    if not ((new_betas > 0).all() and (new_betas <= 1).all()):
        raise ValueError("betas in invalid range after respacing")
    return new_betas


def respace_betas_karras(
    betas: np.ndarray, rescaled_num_steps: int, rho: float = 7.0
) -> tuple[np.ndarray, np.ndarray]:
    """Respace by matching a Karras rho-grid of sigmas instead of the
    reference's even stride (capability extension; Karras et al.,
    arXiv:2206.00364 eq. 5 — the standard grid for few-step samplers).

    sigma_i spans [sigma_min, sigma_max] of the original chain with
    sigma = sqrt((1 - abar)/abar). Matching is done in log-sigma space with
    a monotone assignment that guarantees exactly ``rescaled_num_steps``
    DISTINCT indices: walking the grid from high to low sigma, each point
    takes the nearest original index still below the previous pick (the
    rho-grid is denser than the discrete chain near sigma_min, so naive
    nearest-then-unique silently shrank the grid — cosine-1000 requested
    20 kept only 12/13). Betas are recomputed from the kept alphas_cumprod
    exactly as eq.-19 respacing does, so every coefficient table
    downstream is consistent.
    """
    original_num_steps = len(betas)
    if rescaled_num_steps > original_num_steps:
        raise ValueError("cannot respace to more steps than the chain has")
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    # EDM's sampling sigma range [0.002, 80] (arXiv:2206.00364 Table 1):
    # cosine chains have beta clipped at 0.999, making tail sigmas explode
    # (~3e4) — without the cap most of the rho grid lands inside the last
    # few (pure-noise) timesteps. At sigma=80 the signal fraction is
    # sqrt(acp) ~ 0.012, consistent with the N(0,I) start.
    s_min = max(sigmas[0], 2e-3)
    s_max = min(sigmas[-1], 80.0)
    i = np.linspace(0, 1, rescaled_num_steps)
    grid = (
        s_max ** (1.0 / rho) + i * (s_min ** (1.0 / rho) - s_max ** (1.0 / rho))
    ) ** rho  # descending sigma
    log_sigmas = np.log(sigmas)
    nearest = np.abs(
        log_sigmas[None, :] - np.log(grid)[:, None]
    ).argmin(axis=1)  # per grid point, descending in t

    picks = []
    prev = original_num_steps
    for k in range(rescaled_num_steps):
        j = min(int(nearest[k]), prev - 1)
        # leave room for the remaining points below
        j = max(j, rescaled_num_steps - k - 1)
        picks.append(j)
        prev = j
    timestep_map = np.array(picks[::-1], dtype=np.int64)  # ascending

    return _betas_from_kept_indices(alphas_cumprod, timestep_map), timestep_map


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed per-timestep coefficient tables (float64 numpy).

    Field-for-field analogue of the tables built at reference
    diffusion.py:109-130, plus the derived log-variance tables used by the
    four sampling variance modes (diffusion.py:254-261). Arrays all have
    length ``rescaled_num_steps`` and are indexed by the *rescaled* timestep;
    ``timestep_map`` translates a rescaled index into the original-chain
    timestep that the model consumes.
    """

    original_num_steps: int
    rescaled_num_steps: int
    betas: np.ndarray
    timestep_map: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_reciprocal_alphas_cumprod: np.ndarray
    sqrt_reciprocal_alphas_minus_one_cumprod: np.ndarray
    posterior_mean_coef_x0: np.ndarray
    posterior_mean_coef_xt: np.ndarray
    posterior_variance: np.ndarray
    log_posterior_var_clipped: np.ndarray
    # Derived variance tables for the fixed/learned_interpolation modes.
    log_betas: np.ndarray  # log(beta_t) - max_log for LEARNED_INTERPOLATION
    log_var_large: np.ndarray  # VarType.LARGE (index 0 patched w/ posterior var)
    log_var_small: np.ndarray  # VarType.SMALL (floored at 1e-20)

    @classmethod
    def create(
        cls,
        original_num_steps: int,
        rescaled_num_steps: int,
        beta_schedule: str = "linear",
        betas: Sequence[float] | np.ndarray | None = None,
        respacing: str = "even",
        timestep_indices: "Sequence[int] | np.ndarray | None" = None,
    ) -> "DiffusionSchedule":
        """Build the full table set. Mirrors reference diffusion.py:87-130.
        ``respacing``: 'even' (reference eq.-19 stride) or 'karras'
        (rho-grid in sigma space, better step placement for few-step
        sampling — capability extension). ``timestep_indices`` pins the
        kept original-chain indices explicitly (ascending), overriding
        respacing — used e.g. by progressive distillation to nest the
        student grid exactly inside the teacher's (training/distill.py).
        """
        if betas is None:
            betas = get_beta_schedule(beta_schedule, original_num_steps)
        else:
            betas = np.asarray(betas, dtype=np.float64)
            if len(betas) != original_num_steps:
                raise ValueError("betas must have length original_num_steps")

        if timestep_indices is not None:
            idx = np.asarray(timestep_indices, dtype=np.int64)
            if not ((np.diff(idx) > 0).all() and 0 <= idx[0]
                    and idx[-1] < original_num_steps):
                raise ValueError("timestep_indices must be ascending and in range")
            acp = np.cumprod(1.0 - betas)
            betas, timestep_map = _betas_from_kept_indices(acp, idx), idx
        elif respacing == "even":
            betas, timestep_map = respace_betas(betas, rescaled_num_steps)
        elif respacing == "karras":
            betas, timestep_map = respace_betas_karras(betas, rescaled_num_steps)
        else:
            raise NotImplementedError(respacing)

        alphas = 1.0 - betas
        sqrt_alphas = np.sqrt(alphas)
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        log_posterior_var_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )

        return cls(
            original_num_steps=original_num_steps,
            rescaled_num_steps=len(betas),
            betas=betas,
            timestep_map=timestep_map,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            sqrt_reciprocal_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
            sqrt_reciprocal_alphas_minus_one_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
            posterior_mean_coef_x0=np.sqrt(alphas_cumprod_prev) * betas / (1.0 - alphas_cumprod),
            posterior_mean_coef_xt=sqrt_alphas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod),
            posterior_variance=posterior_variance,
            log_posterior_var_clipped=log_posterior_var_clipped,
            log_betas=np.log(betas),
            log_var_large=np.log(np.append(posterior_variance[1], betas[1:])),
            log_var_small=np.log(np.maximum(posterior_variance, 1e-20)),
        )
