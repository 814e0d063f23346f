"""Gaussian diffusion process: sampling and training losses (torch).

Counterpart of nicediffusion_tpu/diffusion/process.py: the coefficient
tables, the timestep map, the four variance modes, classifier-free guidance
(CFG) as one doubled-batch model call with null label 0 and the
log-variance taken from the conditional half, classifier guidance from the
gradient of a noisy classifier's log p(y | x_t), and the DDPM and DDIM steps.
``denoise`` runs the chain t = steps_to_do-1 ... 0 as a plain Python loop
over the steps, drawing its start noise and every step's noise from an
explicit ``torch.Generator``. Capturing the step in a CUDA graph is later
work.

Training: ``q_sample``/``diffuse`` (the forward process), ``loss`` with the
four loss types (SIMPLE, KL, KL_RESCALED, HYBRID with the VLB's epsilon
detached), ``variational_lower_bound`` and the full-chain ``bpd``. Noise is
injectable everywhere, else drawn from the caller's generator, which also
feeds the model's dropout masks in ``train()`` mode.

Schedule tables are computed in numpy float64 (ops/schedule.py) and held as
float32 tensors on ``device``, as the JAX package casts them. The model's
weights live in the model, so "sample with EMA weights" means passing the
EMA model. The chain state ``x`` is float32 (NHWC); the model casts it to
its compute dtype.

Not ported yet, and raising NotImplementedError where asked for:
DPM-Solver++, dynamic thresholding, v-prediction (sampling and loss target),
the encoder cache and limited-interval guidance (ROADMAP queue A, "Samplers
and serving levers").
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.math import discretized_gaussian_log_likelihood, kl_div, mean_flat
from ..ops.schedule import DiffusionSchedule
from ..utils.device import resolve_device

__all__ = ["Diffusion", "VarType", "LossType"]


class VarType(enum.Enum):
    """Sampling variance modes (reference diffusion.py:552-572)."""

    SMALL = enum.auto()
    LARGE = enum.auto()
    LEARNED = enum.auto()
    LEARNED_INTERPOLATION = enum.auto()

    @staticmethod
    def parse(s: "str | VarType") -> "VarType":
        if isinstance(s, VarType):
            return s
        try:
            return {
                "small": VarType.SMALL,
                "large": VarType.LARGE,
                "learned": VarType.LEARNED,
                "learned_interpolation": VarType.LEARNED_INTERPOLATION,
            }[s]
        except KeyError:
            raise NotImplementedError(s) from None

    @property
    def is_learned(self) -> bool:
        return self in (VarType.LEARNED, VarType.LEARNED_INTERPOLATION)


class LossType(enum.Enum):
    """Training loss modes (reference diffusion.py:575-595)."""

    SIMPLE = enum.auto()
    KL = enum.auto()
    KL_RESCALED = enum.auto()
    HYBRID = enum.auto()

    @staticmethod
    def parse(s: "str | LossType") -> "LossType":
        if isinstance(s, LossType):
            return s
        try:
            return {
                "simple": LossType.SIMPLE,
                "KL": LossType.KL,
                "KL_rescaled": LossType.KL_RESCALED,
                "hybrid": LossType.HYBRID,
            }[s]
        except KeyError:
            raise NotImplementedError(s) from None


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported yet (ROADMAP queue A, "{where}")')


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast over trailing dims."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


class Diffusion:
    """Diffusion chain handler: ``.denoise()`` and its steps, ``.loss()``
    and ``.bpd()``.

    Takes the JAX package's constructor surface (so the presets apply
    unchanged) plus the ``device`` the tables live on: by default the
    model's, and with no model the CUDA card (utils/device.py). ``model``
    is a nicediffusion_tpu_torch DiffusionModel.

    ``classifier`` is a callable ``(x_nhwc, t_rescaled) -> logits``, such as
    an EncoderUNet, used for classifier guidance; per the reference quirk it
    receives the *rescaled* timestep, not the mapped original one
    (diffusion.py:301). A classifier that is an ``nn.Module`` is put in
    ``eval()`` mode with its parameters frozen, so that the gradient pass
    computes input gradients only.
    """

    def __init__(
        self,
        model: Any,
        original_num_steps: int,
        rescaled_num_steps: int,
        sampling_var_type: str | VarType,
        loss_type: str | LossType,
        betas: Sequence[float] | np.ndarray | None = None,
        beta_schedule: str = "linear",
        guidance_method: str | None = None,
        guidance_strength: float | None = None,
        classifier: Callable | None = None,
        use_ddim: bool = False,
        ddim_eta: float | None = None,
        clip_x: "bool | str" = True,
        sampler: str | None = None,
        respacing: str = "even",
        timestep_indices=None,
        prediction_type: str = "eps",
        device: torch.device | str | None = None,
    ):
        if guidance_method not in (None, "classifier", "classifier_free"):
            raise NotImplementedError(guidance_method)
        if guidance_method == "classifier" and classifier is None:
            raise ValueError("classifier guidance needs a classifier")
        if model is not None and guidance_method is not None:
            assert model.conditional, "can only use guidance if model is conditional"
        if use_ddim:
            assert ddim_eta is not None, "please supply eta if you want to use ddim"
        if sampler is None:
            sampler = "ddim" if use_ddim else "ddpm"
        if sampler == "dpm++":
            raise _not_ported("the dpm++ sampler", "Samplers and serving levers")
        if sampler not in ("ddpm", "ddim"):
            raise NotImplementedError(sampler)
        if sampler == "ddim" and ddim_eta is None:
            ddim_eta = 0.0
        if clip_x == "dynamic":
            raise _not_ported("dynamic thresholding", "Samplers and serving levers")
        if clip_x not in (True, False):
            raise NotImplementedError(clip_x)
        if prediction_type == "v":
            raise _not_ported("v-prediction", "Samplers and serving levers")
        if prediction_type != "eps":
            raise NotImplementedError(prediction_type)

        self.sampler = sampler
        self.model = model
        self.guidance = guidance_method
        self.strength = guidance_strength
        self.classifier = classifier
        if isinstance(classifier, torch.nn.Module):
            classifier.eval().requires_grad_(False)
        self.ddim_eta = ddim_eta
        self.clip_x = clip_x
        self.sampling_var_type = VarType.parse(sampling_var_type)
        self.loss_type = LossType.parse(loss_type)
        self.original_num_steps = original_num_steps
        self.prediction_type = prediction_type
        if device is None and model is not None:
            device = next(model.parameters()).device
        self.device = resolve_device(device)

        self.schedule = s = DiffusionSchedule.create(
            original_num_steps=original_num_steps,
            rescaled_num_steps=rescaled_num_steps,
            beta_schedule=beta_schedule,
            betas=betas,
            respacing=respacing,
            timestep_indices=timestep_indices,
        )
        self.rescaled_num_steps = s.rescaled_num_steps
        self.timestep_map = torch.as_tensor(
            s.timestep_map, dtype=torch.long, device=self.device
        )

        def as32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._sqrt_acp = as32(s.sqrt_alphas_cumprod)
        self._sqrt_1macp = as32(s.sqrt_one_minus_alphas_cumprod)
        self._sqrt_recip_acp = as32(s.sqrt_reciprocal_alphas_cumprod)
        self._sqrt_recipm1_acp = as32(s.sqrt_reciprocal_alphas_minus_one_cumprod)
        self._acp = as32(s.alphas_cumprod)
        self._acp_prev = as32(s.alphas_cumprod_prev)
        self._post_coef_x0 = as32(s.posterior_mean_coef_x0)
        self._post_coef_xt = as32(s.posterior_mean_coef_xt)
        self._log_post_var = as32(s.log_posterior_var_clipped)
        self._log_betas = as32(s.log_betas)
        self._log_var_large = as32(s.log_var_large)
        self._log_var_small = as32(s.log_var_small)

    # ------------------------------------------------------------------
    # Forward (q) process
    # ------------------------------------------------------------------

    def q_sample(self, x_0, t, noise):
        """Sample q(x_t | x_0) (DDPM eq. 4; reference diffusion.py:232-240)."""
        return (
            _bcast(self._sqrt_acp, t, x_0.ndim) * x_0
            + _bcast(self._sqrt_1macp, t, x_0.ndim) * noise
        )

    def diffuse(self, x_0, generator=None, steps_to_do=None, noise=None):
        """Jump straight to q(x_t | x_0) at rescaled step ``steps_to_do - 1``
        (reference diffusion.py:132-153)."""
        if steps_to_do is None or steps_to_do > self.rescaled_num_steps:
            steps_to_do = self.rescaled_num_steps
        if noise is None:
            assert generator is not None, "pass generator or explicit noise"
            noise = self._noise(x_0, generator).to(x_0.dtype)
        t = torch.full((x_0.shape[0],), steps_to_do - 1, dtype=torch.long, device=x_0.device)
        return self.q_sample(x_0, t, noise)

    # ------------------------------------------------------------------
    # Model output handling
    # ------------------------------------------------------------------

    def _apply_model(self, x, t, y, generator=None):
        """Run the UNet at the mapped original timestep (diffusion.py:246).
        ``generator`` feeds the dropout masks of a model in ``train()`` mode."""
        y = y if self.model.conditional else None
        if generator is None:
            return self.model(x, self.timestep_map[t], y)
        return self.model(x, self.timestep_map[t], y, generator=generator)

    def _resolve_log_var(self, raw_log_var, t, ndim):
        """Resolve the log-variance per sampling_var_type (reference
        diffusion.py:248-263). `raw_log_var` is the model's second channel
        half (learned modes) or None (fixed modes)."""
        vt = self.sampling_var_type
        if vt == VarType.LEARNED:
            return raw_log_var
        if vt == VarType.LEARNED_INTERPOLATION:
            min_log = _bcast(self._log_post_var, t, ndim)
            max_log = _bcast(self._log_betas, t, ndim)
            frac = (raw_log_var + 1) / 2
            return frac * max_log + (1 - frac) * min_log
        if vt == VarType.LARGE:
            return _bcast(self._log_var_large, t, ndim)
        return _bcast(self._log_var_small, t, ndim)

    def _split_out(self, out):
        """Split the model output into (eps, raw_log_var-or-None)."""
        if self.sampling_var_type.is_learned:
            eps, raw = out.chunk(2, dim=-1)
            return eps, raw
        return out, None

    def _to_eps(self, pred, x_t, t):
        """Convert the model's native prediction to epsilon: the identity for
        ``prediction_type='eps'``, the only type the constructor lets by
        (v-prediction is ROADMAP queue A)."""
        return pred

    def get_eps_and_log_var(self, x_t, t, y=None):
        """Predicted epsilon and (learned or fixed) log variance
        (reference diffusion.py:242-264)."""
        pred, raw = self._split_out(self._apply_model(x_t, t, y))
        return self._to_eps(pred, x_t, t), self._resolve_log_var(raw, t, x_t.ndim)

    def _cfg_combine(self, out2):
        """CFG on a doubled-batch model output: ``(1+w)*eps_c - w*eps_0``;
        the log-var half comes from the conditional branch."""
        cond, uncond = out2.chunk(2, dim=0)
        if self.sampling_var_type.is_learned:
            eps_c, raw = cond.chunk(2, dim=-1)
            eps_u, _ = uncond.chunk(2, dim=-1)
            eps = (1 + self.strength) * eps_c - self.strength * eps_u
            return torch.cat([eps, raw], dim=-1)
        return (1 + self.strength) * cond - self.strength * uncond

    def _guided_eps(self, x, t, y, *, want_log_var: bool):
        """Epsilon (+ log_var), with CFG as one doubled-batch model call:
        the conditional rows, then the same rows with null label 0."""
        if self.guidance != "classifier_free":
            out = self._apply_model(x, t, y)
        else:
            x2 = torch.cat([x, x], dim=0)
            t2 = torch.cat([t, t], dim=0)
            y2 = torch.cat([y, torch.zeros_like(y)], dim=0)
            out = self._cfg_combine(self._apply_model(x2, t2, y2))
        eps, raw = self._split_out(out)
        if not want_log_var:
            return eps, None
        return eps, self._resolve_log_var(raw, t, x.ndim)

    def _clip_x0(self, pred_x0):
        """Hard [-1, 1] clamp of pred_x0 (the reference default) or none."""
        return pred_x0.clamp(-1, 1) if self.clip_x else pred_x0

    def _classifier_grad(self, x, t, y):
        """grad_x log p(y | x, t) -> f32, through torch.autograd (reference
        diffusion.py:299-304). The classifier sees the rescaled t.

        ``denoise`` runs under ``torch.inference_mode()``, where autograd
        records nothing and whose tensors cannot be saved for a backward
        pass: the gradient is taken with inference mode off, on copies of
        x, t and y made there. The UNet's forward stays outside the graph.
        """
        with torch.inference_mode(False), torch.enable_grad():
            xx = x.detach().clone().requires_grad_(True)
            t, y = t.clone(), y.clone()
            log_probs = torch.log_softmax(self.classifier(xx, t).float(), dim=-1)
            selected = log_probs.gather(1, y.reshape(-1, 1)).sum()
            grad, = torch.autograd.grad(selected, xx)
        return grad.float()

    def _noise(self, like, generator):
        return torch.randn(
            like.shape, generator=generator, dtype=torch.float32, device=like.device
        )

    # ------------------------------------------------------------------
    # Reverse (p) steps
    # ------------------------------------------------------------------

    def ddpm_step(self, x_t, t, generator=None, y=None, noise=None):
        """One DDPM ancestral step (reference diffusion.py:266-316).

        Returns (sample, pred_x0). `t` is a (B,) rescaled-index tensor;
        `noise` may be injected (parity tests), else it is drawn from
        `generator`.
        """
        eps, log_var = self._guided_eps(x_t, t, y, want_log_var=True)
        nd = x_t.ndim
        pred_x0 = self._clip_x0(
            _bcast(self._sqrt_recip_acp, t, nd) * x_t
            - _bcast(self._sqrt_recipm1_acp, t, nd) * eps
        )
        mean = (
            _bcast(self._post_coef_x0, t, nd) * pred_x0
            + _bcast(self._post_coef_xt, t, nd) * x_t
        )
        if self.guidance == "classifier":
            grad = self._classifier_grad(x_t, t, y)
            mean = mean + self.strength * grad * torch.exp(log_var)
        if noise is None:
            noise = self._noise(x_t, generator)
        mask = (t != 0).float().reshape((-1,) + (1,) * (nd - 1))
        sample = mean + mask * torch.exp(0.5 * log_var) * noise
        return sample.float(), pred_x0

    def ddim_step(self, x_t, t, generator=None, y=None, noise=None):
        """One DDIM step, eq. 12 of DDIM (reference diffusion.py:318-369)."""
        eps, _ = self._guided_eps(x_t, t, y, want_log_var=False)
        nd = x_t.ndim
        if self.guidance == "classifier":
            # classifier guidance applied to eps before the x0 projection
            # (OpenAI Alg. 2, reference diffusion.py:330-337)
            grad = self._classifier_grad(x_t, t, y)
            eps = eps - self.strength * grad * _bcast(self._sqrt_1macp, t, nd)
        pred_x0 = self._clip_x0(
            _bcast(self._sqrt_recip_acp, t, nd) * x_t
            - _bcast(self._sqrt_recipm1_acp, t, nd) * eps
        )
        alpha_bar = _bcast(self._acp, t, nd)
        alpha_bar_prev = _bcast(self._acp_prev, t, nd)
        var = (
            self.ddim_eta**2
            * (1.0 - alpha_bar_prev)
            * (1.0 - alpha_bar / alpha_bar_prev)
            / (1.0 - alpha_bar)
        )
        mean = pred_x0 * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            1 - alpha_bar_prev - var
        ) * eps
        if noise is None:
            noise = self._noise(x_t, generator)
        mask = (t != 0).float().reshape((-1,) + (1,) * (nd - 1))
        sample = mean + mask * torch.sqrt(var) * noise
        return sample.float(), pred_x0

    # ------------------------------------------------------------------
    # Reverse chain
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def denoise(
        self,
        generator: torch.Generator | None = None,
        x: torch.Tensor | None = None,
        y: torch.Tensor | None = None,
        start_step: int | None = None,
        steps_to_do: int | None = None,
        batch_size: int = 1,
        encoder_cache: int | None = None,
        guidance_interval: tuple[float, float] | None = None,
    ) -> torch.Tensor:
        """Run the reverse chain (reference diffusion.py:155-226) -> f32 NHWC.

        Starts from N(0, I) drawn from `generator` when `x` is None; every
        step's noise comes from the same generator, which must live on the
        tables' device.
        """
        if encoder_cache is not None:
            raise _not_ported("the encoder cache", "Samplers and serving levers")
        if guidance_interval is not None:
            raise _not_ported("limited-interval guidance", "Samplers and serving levers")
        if self.model.conditional:
            assert y is not None, "pass label iff model is class-conditional"
        else:
            assert y is None, "pass label iff model is class-conditional"

        if start_step is None:
            start_step = self.rescaled_num_steps
        if steps_to_do is None or steps_to_do > start_step:
            steps_to_do = start_step

        if x is None:
            assert start_step == self.rescaled_num_steps, (
                "cannot start from noise with current step that is not T"
            )
            m = self.model
            x = torch.randn(
                (batch_size, m.resolution, m.resolution, m.in_channels),
                generator=generator, dtype=torch.float32, device=self.device,
            )
        if y is not None:
            assert y.shape[0] == x.shape[0], "len(labels) != batch size"

        step = self.ddim_step if self.sampler == "ddim" else self.ddpm_step
        for ts in range(steps_to_do - 1, -1, -1):
            t = torch.full((x.shape[0],), ts, dtype=torch.long, device=x.device)
            x, _ = step(x, t, generator, y)
        return x

    # ------------------------------------------------------------------
    # Training losses
    # ------------------------------------------------------------------

    def loss(self, x_0, t, generator=None, y=None, noise=None):
        """Training loss in bits/dim, one value per example (reference
        diffusion.py:375-410).

        SIMPLE: mean MSE(eps_pred, noise). KL / KL_RESCALED: VLB term
        (x rescaled_num_steps). HYBRID: L_simple + 0.001 * L_vlb with the VLB
        epsilon detached so it only trains the variances (IDDPM eq. 16).
        ``noise`` may be injected; else it is drawn from ``generator``, which
        then feeds the model's dropout masks (``train()`` mode only).
        """
        if noise is None:
            noise = self._noise(x_0, generator).to(x_0.dtype)
        x_t = self.q_sample(x_0, t, noise)
        pred, raw = self._split_out(self._apply_model(x_t, t, y, generator))
        log_var = self._resolve_log_var(raw, t, x_t.ndim)
        eps_pred = self._to_eps(pred, x_t, t)

        if self.loss_type == LossType.SIMPLE:
            return mean_flat((pred - noise) ** 2)
        if self.loss_type in (LossType.KL, LossType.KL_RESCALED):
            loss = self.variational_lower_bound(x_0, x_t, t, eps_pred, log_var)
            if self.loss_type == LossType.KL_RESCALED:
                loss = loss * self.rescaled_num_steps
            return loss
        loss_simple = mean_flat((pred - noise) ** 2)  # HYBRID
        loss_vlb = (
            self.variational_lower_bound(x_0, x_t, t, eps_pred.detach(), log_var)
            * self.rescaled_num_steps
        )
        return loss_simple + 0.001 * loss_vlb

    def variational_lower_bound(self, x_0, x_t, t, eps_pred, log_var):
        """Per-t VLB term in bits/dim (reference diffusion.py:412-438)."""
        nd = x_0.ndim
        true_mean = (
            _bcast(self._post_coef_x0, t, nd) * x_0
            + _bcast(self._post_coef_xt, t, nd) * x_t
        )
        true_log_var = _bcast(self._log_post_var, t, nd).expand(x_0.shape)
        pred_x0 = (
            _bcast(self._sqrt_recip_acp, t, nd) * x_t
            - _bcast(self._sqrt_recipm1_acp, t, nd) * eps_pred
        )
        mean = (
            _bcast(self._post_coef_x0, t, nd) * pred_x0
            + _bcast(self._post_coef_xt, t, nd) * x_t
        )
        log_var = log_var.expand(x_0.shape)
        kl = mean_flat(kl_div(true_mean, true_log_var, mean, log_var)) / np.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x_0, mean, log_var)
        nll = mean_flat(nll) / np.log(2.0)
        return torch.where(t == 0, nll, kl)

    # ------------------------------------------------------------------
    # Evaluation: full-chain variational bound (bits/dim)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def bpd(self, x_0, generator=None, y=None, noise=None):
        """Full-chain NLL upper bound in bits/dim for a batch of images.

        A Python loop over every rescaled timestep computes the per-t VLB
        term (KL for t > 0, discretized NLL at t == 0) on a fresh q-sample
        of x_t, plus the prior term KL(q(x_T | x_0) || N(0, I)). ``noise``,
        shaped (T, *x_0.shape) with row i used at t == i, may be injected;
        else every step draws from ``generator``.

        Returns a dict: total_bpd [B], prior_bpd [B], vlb_terms [T, B],
        mse_terms [T, B] (per-t eps MSE), the [T, B] profiles in natural
        timestep order (row i is t == i). x_0 is NHWC in [-1, 1].
        """
        steps = self.rescaled_num_steps
        vlb_terms, mse_terms = [None] * steps, [None] * steps
        for ts in range(steps - 1, -1, -1):
            t = torch.full((x_0.shape[0],), ts, dtype=torch.long, device=x_0.device)
            eps = noise[ts] if noise is not None else self._noise(x_0, generator).to(x_0.dtype)
            x_t = self.q_sample(x_0, t, eps)
            eps_pred, log_var = self.get_eps_and_log_var(x_t, t, y)
            vlb_terms[ts] = self.variational_lower_bound(x_0, x_t, t, eps_pred, log_var)
            mse_terms[ts] = mean_flat((eps_pred - eps) ** 2)
        vlb_terms, mse_terms = torch.stack(vlb_terms), torch.stack(mse_terms)

        # prior: KL( N(sqrt(acp_T) x0, (1 - acp_T) I) || N(0, I) )
        t_last = torch.full((x_0.shape[0],), steps - 1, dtype=torch.long, device=x_0.device)
        mean_T = _bcast(self._sqrt_acp, t_last, x_0.ndim) * x_0
        log_var_T = torch.log1p(-_bcast(self._acp, t_last, x_0.ndim)).expand(x_0.shape)
        prior = kl_div(mean_T, log_var_T, torch.zeros_like(mean_T), torch.zeros_like(mean_T))
        prior_bpd = mean_flat(prior) / np.log(2.0)
        return {
            "total_bpd": vlb_terms.sum(dim=0) + prior_bpd,
            "prior_bpd": prior_bpd,
            "vlb_terms": vlb_terms,
            "mse_terms": mse_terms,
        }
