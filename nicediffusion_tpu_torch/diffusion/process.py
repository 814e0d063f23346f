"""Gaussian diffusion process: sampling and training losses (torch).

Counterpart of nicediffusion_tpu/diffusion/process.py: the coefficient
tables, the timestep map, the four variance modes, classifier-free guidance
(CFG) as one doubled-batch model call with null label 0 and the
log-variance taken from the conditional half, classifier guidance from the
gradient of a noisy classifier's log p(y | x_t), and the DDPM and DDIM steps.
``denoise`` runs the chain t = steps_to_do-1 ... 0, drawing its start noise
and every step's noise from an explicit ``torch.Generator``. On the CPU it is
a plain Python loop over the steps. On a CUDA device a chain without
autograd replays one captured CUDA graph a step instead (diffusion/graphs.py,
the counterpart of the JAX sampler's ``lax.scan`` under ``jax.jit``): the
host fills t, draws the step's noise as the loop does and replays, and the
bits are the loop's. ``cuda_graph=False`` keeps the loop on the card.
Classifier guidance (a gradient inside the step), a model paired by
``shard_module_`` (collectives in its forward) and int8 calibration while
its recorders are live stay on the loop.

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

Fast sampling: the DPM-Solver++(2M) step (``sampler="dpm++"``, its tables
made on the host in float64 like the others), v-prediction
(``prediction_type="v"``, converted to epsilon once at the model boundary,
and the native target of the simple loss), dynamic thresholding
(``clip_x="dynamic"``), and two levers of ``denoise``: limited-interval
guidance, where the steps outside the interval run one conditional forward
and the skipped half of the CFG batch is simply never called, and the
encoder cache, where only the first step of every group of k runs the
UNet's encoder.

Super-resolution: ``with_model_kwargs(low_res=...)`` hands the low-res batch
to every model call of a SuperResolutionModel (models/unet.py); the chain
then starts from an ``x`` the caller passes, with the image's channels.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.math import discretized_gaussian_log_likelihood, kl_div, mean_flat
from ..ops.schedule import DiffusionSchedule
from ..parallel.mesh import shard_rows
from ..utils.device import resolve_device
from .graphs import ChainGraphs

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
        dynamic_threshold: float = 0.995,
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
        # 'ddpm' (ancestral), 'ddim' (eq. 12) or 'dpm++' (DPM-Solver++(2M), a
        # second-order multistep ODE solver at DDIM's cost per step)
        if sampler not in ("ddpm", "ddim", "dpm++"):
            raise NotImplementedError(sampler)
        if sampler == "ddim" and ddim_eta is None:
            ddim_eta = 0.0
        # clip_x: True (clamp pred_x0 to [-1, 1], the reference default),
        # False, or 'dynamic' (Imagen's dynamic thresholding, arXiv:2205.11487
        # section 2.3: clamp to the per-sample `dynamic_threshold` quantile s
        # of |pred_x0|, s >= 1, and divide by s)
        if clip_x not in (True, False, "dynamic"):
            raise NotImplementedError(clip_x)
        # 'eps' predicts the noise; 'v' predicts v = alpha*eps - sigma*x0
        # (Salimans & Ho, arXiv:2202.00512 appendix D)
        if prediction_type not in ("eps", "v"):
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
        self.dynamic_threshold = dynamic_threshold
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

        # DPM-Solver++(2M) coefficient tables, made on the host in float64 so
        # that the t == 0 boundary (sigma_prev == 0, h -> inf) is exact. With
        # the half-log-SNR lambda_t = log(alpha_t / sigma_t), the t -> t-1
        # transition is
        #   x <- (sigma_prev / sigma_t) * x + alpha_prev * (1 - e^{-h}) * D
        #   D  = (1 + m_t) * x0_t - m_t * x0_{t+1},  m_t = h_t / (2 h_{t+1})
        # (DPM-Solver++ eq. 4.3/4.4 in multistep form). m is 0 at the first
        # step (no history) and at the last (first order, since h_0 = inf).
        acp64 = np.asarray(s.alphas_cumprod, dtype=np.float64)
        acp_prev64 = np.asarray(s.alphas_cumprod_prev, dtype=np.float64)
        alpha_t = np.sqrt(acp64)
        sigma_t = np.sqrt(1.0 - acp64)
        alpha_p = np.sqrt(acp_prev64)
        sigma_p = np.sqrt(1.0 - acp_prev64)
        # e^{-h} = (sigma_prev * alpha_t) / (sigma_t * alpha_prev): exactly 0
        # at t == 0, where sigma_prev == 0
        exp_mh = (sigma_p * alpha_t) / (sigma_t * alpha_p)
        n = len(acp64)
        with np.errstate(divide="ignore"):
            lam = 0.5 * np.log(acp64 / (1.0 - acp64))
            lam_p = 0.5 * np.log(acp_prev64 / np.maximum(1.0 - acp_prev64, 1e-300))
        h = lam_p - lam  # h[0] may be inf (unused: m[0] = 0)
        m = np.zeros(n, dtype=np.float64)
        if n > 2:
            m[1 : n - 1] = h[1 : n - 1] / (2.0 * h[2:n])
        self._dpmpp_c_xt = as32(sigma_p / sigma_t)
        self._dpmpp_c_d = as32(alpha_p * (1.0 - exp_mh))
        self._dpmpp_m = as32(m)

        # extra keyword arguments of every model call, such as low_res for a
        # SuperResolutionModel (with_model_kwargs)
        self.model_kwargs: dict = {}
        # the captured step graphs of denoise on a CUDA device
        self._graphs = ChainGraphs()

    def with_model_kwargs(self, **kwargs) -> "Diffusion":
        """Set extra keyword arguments for every model call (e.g.
        ``low_res=<image batch>`` to drive a SuperResolutionModel); returns
        self. They go to the model as given: under classifier-free guidance
        the model batch is doubled, so batched kwargs must be doubled
        already. The encoder cache refuses them."""
        self.model_kwargs = kwargs
        return self

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
        ``generator`` feeds the dropout masks of a model in ``train()`` mode;
        ``model_kwargs`` go with every call."""
        kwargs = dict(self.model_kwargs, y=y if self.model.conditional else None)
        if generator is not None:
            kwargs["generator"] = generator
        return self.model(x, self.timestep_map[t], **kwargs)

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
        """Convert the model's native prediction to epsilon. For 'v':
        eps = sigma_t * x_t + alpha_t * v (from v = alpha*eps - sigma*x0 and
        x_t = alpha*x0 + sigma*eps). The identity for 'eps'."""
        if self.prediction_type == "eps":
            return pred
        a = _bcast(self._sqrt_acp, t, x_t.ndim)
        s = _bcast(self._sqrt_1macp, t, x_t.ndim)
        return s * x_t + a * pred

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

    def _doubled(self, x, t, y):
        """The CFG batch: the conditional rows, then the same rows with the
        null label 0."""
        return (torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                torch.cat([y, torch.zeros_like(y)], dim=0))

    def _eps_log_var(self, out, x, t, want_log_var: bool):
        """(eps, log_var or None) from a model output of x's batch. The
        conversion to epsilon comes after the CFG mix and after the split of
        the learned-variance half (for 'v' models the CFG mix in v-space
        equals the mix in eps-space: the map is affine in v at fixed x_t)."""
        pred, raw = self._split_out(out)
        eps = self._to_eps(pred, x, t)
        if not want_log_var:
            return eps, None
        return eps, self._resolve_log_var(raw, t, x.ndim)

    def _guided_eps(self, x, t, y, *, want_log_var: bool, guided: bool = True):
        """Epsilon (+ log_var), with CFG as one doubled-batch model call.

        ``guided=False`` makes the plain conditional call (one forward
        instead of two) even when classifier-free guidance is configured:
        limited-interval guidance (Kynkaanniemi et al. 2024,
        arXiv:2404.07724)."""
        if self.guidance != "classifier_free" or not guided:
            out = self._apply_model(x, t, y)
        else:
            out = self._cfg_combine(self._apply_model(*self._doubled(x, t, y)))
        return self._eps_log_var(out, x, t, want_log_var)

    # ------------------------------------------------------------------
    # Encoder-cached model calls ("Faster Diffusion", arXiv:2312.09608)
    # ------------------------------------------------------------------

    def _apply_model_split(self, x, t, y, cache, refresh: bool):
        """Model call through the embed / encode / decode split, reusing the
        cached encoder features when ``refresh`` is False.

        The timestep embedding and the decoder always run at the current t;
        only the encoder stack (its bottom feature and skip activations) is
        frozen to the last refresh step. Returns (out, cache)."""
        if self.model_kwargs:
            raise NotImplementedError(
                "encoder_cache does not support extra model kwargs "
                "(e.g. SuperResolutionModel low_res)"
            )
        model = self.model
        emb = model.embed(self.timestep_map[t], y if model.conditional else None)
        if refresh:
            cache = model.encode(x, emb)
        h, xs = cache
        return model.decode(h, xs, emb), cache

    def _guided_eps_cached(self, x, t, y, cache, refresh: bool, *,
                           want_log_var: bool, guided: bool = True):
        """:meth:`_guided_eps` through the encoder-cached path; returns
        ((eps, log_var), cache). Under CFG the cache holds the doubled batch."""
        if self.guidance != "classifier_free" or not guided:
            out, cache = self._apply_model_split(x, t, y, cache, refresh)
        else:
            out2, cache = self._apply_model_split(*self._doubled(x, t, y), cache, refresh)
            out = self._cfg_combine(out2)
        return self._eps_log_var(out, x, t, want_log_var), cache

    def _clip_x0(self, pred_x0):
        """The configured clamp of pred_x0: hard [-1, 1] (the reference
        default), none, or dynamic thresholding (per-sample quantile of
        |pred_x0|, floored at 1: clamp and divide)."""
        if self.clip_x == "dynamic":
            s = torch.quantile(
                pred_x0.abs().reshape(pred_x0.shape[0], -1), self.dynamic_threshold, dim=1
            )
            s = s.clamp(min=1.0).reshape((-1,) + (1,) * (pred_x0.ndim - 1))
            return pred_x0.clamp(-s, s) / s
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

    def _noise(self, like, generator, row_shard=None):
        """N(0, I) shaped like ``like``, f32, from ``generator``.

        Under a row shard ``(rank, world)``, ``like`` holds this rank's rows
        of a global batch ``world`` times as large: the draw is made at the
        global shape from the generator every rank holds alike, and the rank
        keeps its rows (``parallel/mesh.py::shard_rows``), so a sharded chain
        draws what the unsharded one draws. The cost is one global-shape
        ``randn`` a draw: 64 x 3 x 64 x 64 f32, 3.1 MB at ``openai_64`` batch
        64, next to a UNet forward."""
        if row_shard is None:
            return torch.randn(
                like.shape, generator=generator, dtype=torch.float32, device=like.device
            )
        rank, world = row_shard
        full = torch.randn((like.shape[0] * world, *like.shape[1:]), generator=generator,
                           dtype=torch.float32, device=like.device)
        return shard_rows(full, rank, world)

    # ------------------------------------------------------------------
    # Reverse (p) steps
    # ------------------------------------------------------------------

    def ddpm_step(self, x_t, t, generator=None, y=None, noise=None, eps_log_var=None):
        """One DDPM ancestral step (reference diffusion.py:266-316).

        Returns (sample, pred_x0). `t` is a (B,) rescaled-index tensor;
        `noise` may be injected (parity tests), else it is drawn from
        `generator`; `eps_log_var` may carry an (eps, log_var) pair made
        already (the levers of ``denoise``).
        """
        if eps_log_var is None:
            eps_log_var = self._guided_eps(x_t, t, y, want_log_var=True)
        eps, log_var = eps_log_var
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

    def _eps_guided_x0(self, x_t, t, y, eps):
        """The shared tail of DDIM and DPM++: classifier guidance applied to
        eps (OpenAI Alg. 2, reference diffusion.py:330-337), then the x0
        projection with the configured clamp. Returns (eps, pred_x0)."""
        nd = x_t.ndim
        if self.guidance == "classifier":
            grad = self._classifier_grad(x_t, t, y)
            eps = eps - self.strength * grad * _bcast(self._sqrt_1macp, t, nd)
        pred_x0 = (
            _bcast(self._sqrt_recip_acp, t, nd) * x_t
            - _bcast(self._sqrt_recipm1_acp, t, nd) * eps
        )
        return eps, self._clip_x0(pred_x0)

    def ddim_step(self, x_t, t, generator=None, y=None, noise=None, eps_log_var=None):
        """One DDIM step, eq. 12 of DDIM (reference diffusion.py:318-369)."""
        if eps_log_var is None:
            eps_log_var = self._guided_eps(x_t, t, y, want_log_var=False)
        eps, pred_x0 = self._eps_guided_x0(x_t, t, y, eps_log_var[0])
        nd = x_t.ndim
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

    def dpmpp_step(self, x_t, t, x0_prev, y=None, first=False, eps_log_var=None):
        """One DPM-Solver++(2M) multistep update (deterministic).

        `x0_prev` is the previous step's pred_x0; `first` marks the first
        executed step, where there is no history and the update is first
        order (m forced to 0: a partial denoise starts mid-chain at an index
        whose table m is not 0). Returns (x_next, pred_x0); pred_x0 is the
        next step's x0_prev. Classifier guidance applies to eps, as in DDIM.
        """
        if eps_log_var is None:
            eps_log_var = self._guided_eps(x_t, t, y, want_log_var=False)
        _, pred_x0 = self._eps_guided_x0(x_t, t, y, eps_log_var[0])
        nd = x_t.ndim
        m = _bcast(self._dpmpp_m, t, nd)
        if first:
            m = torch.zeros_like(m)
        d = (1.0 + m) * pred_x0 - m * x0_prev
        x_next = _bcast(self._dpmpp_c_xt, t, nd) * x_t + _bcast(self._dpmpp_c_d, t, nd) * d
        return x_next.float(), pred_x0

    # ------------------------------------------------------------------
    # Reverse chain
    # ------------------------------------------------------------------

    def _chain_plan(self, steps_to_do: int, encoder_cache: int | None,
                    gi: tuple[int, int] | None) -> list[tuple[int, bool, str | None]]:
        """The chain's steps in order, t = steps_to_do - 1 down to 0, as
        (t, guided, cache): ``guided`` makes the doubled CFG call, ``cache``
        is None for a plain model call, "refresh" for the first step of an
        encoder-cache group (it runs the encoder) and "reuse" for the others.
        The cached head runs in groups of k, the last ``steps % k`` steps
        plain; a group is guided iff any of its steps lies in ``gi``."""
        def in_gi(ts):
            return gi is None or gi[0] <= ts < gi[1]

        chain = list(range(steps_to_do - 1, -1, -1))
        k = max(1, min(encoder_cache or 1, steps_to_do))
        head = steps_to_do - steps_to_do % k if k > 1 else 0
        plan = []
        for i in range(0, head, k):
            group = chain[i:i + k]
            guided = any(map(in_gi, group))
            plan += [(ts, guided, "reuse" if j else "refresh") for j, ts in enumerate(group)]
        return plan + [(ts, in_gi(ts), None) for ts in chain[head:]]

    def _chain_step(self, x, x0_prev, t, y, noise, guided: bool, cache_mode: str | None,
                    cache, first: bool):
        """One reverse update of the configured sampler: the model call the
        plan names (``_chain_plan``: guided or not, through the encoder cache
        or not), then the DDPM, DDIM or DPM++ step; ``first`` marks the
        chain's first step. DDPM and DDIM take ``noise`` drawn already (one
        tensor a step, masked at t == 0), DPM++ none. Returns (x, x0_prev,
        cache). The eager loop of ``denoise`` and every captured step graph
        (diffusion/graphs.py) run this."""
        want_lv = self.sampler == "ddpm"
        if cache_mode is None:
            eps_lv = self._guided_eps(x, t, y, want_log_var=want_lv, guided=guided)
        else:
            eps_lv, cache = self._guided_eps_cached(
                x, t, y, cache, refresh=cache_mode == "refresh", want_log_var=want_lv,
                guided=guided)
        if self.sampler == "dpm++":
            x, x0_prev = self.dpmpp_step(x, t, x0_prev, y, first=first, eps_log_var=eps_lv)
        else:
            step = self.ddim_step if self.sampler == "ddim" else self.ddpm_step
            x, _ = step(x, t, None, y, noise=noise, eps_log_var=eps_lv)
        return x, x0_prev, cache

    def _graph_refusal(self) -> str | None:
        """Why this Diffusion's chain cannot be captured, or None."""
        if self.guidance == "classifier":
            return "classifier guidance takes a gradient inside the step"
        mesh = getattr(self.model, "tp_mesh", None)
        if mesh is not None and mesh.num_model > 1:
            return "a model paired by shard_module_ runs collectives in its forward"
        layers = getattr(self.model, "int8_layers", dict)()
        if any(m.recording for m in layers.values()):
            return "int8 calibration is recording inside the forward"
        return None

    def _use_graphs(self, cuda_graph: bool | None) -> bool:
        """``denoise``'s ``cuda_graph``: None graphs a chain on a CUDA device
        unless ``_graph_refusal`` names a reason; True demands the graphs
        and raises where they cannot be had; False runs the eager loop."""
        if cuda_graph is False:
            return False
        refusal = self._graph_refusal()
        if cuda_graph is None:
            return self.device.type == "cuda" and refusal is None
        if refusal is not None:
            raise NotImplementedError(
                f"cuda_graph=True: {refusal}; the graphs of the autograd paths are the next "
                "slice of ROADMAP.md queue A")
        if self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device, the chain is on {self.device}")
        return True

    def reset_graphs(self) -> None:
        """Free the captured step graphs, their memory pool and their static
        buffers; the next graphed chain captures anew."""
        self._graphs.reset()

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
        row_shard: tuple[int, int] | None = None,
        cuda_graph: bool | None = None,
    ) -> torch.Tensor:
        """Run the reverse chain (reference diffusion.py:155-226) -> f32 NHWC.

        Starts from N(0, I) drawn from `generator` when `x` is None; every
        step's noise comes from the same generator, which must live on the
        tables' device.

        ``cuda_graph``: None (the default) replays one captured CUDA graph a
        step on a CUDA device (diffusion/graphs.py; the first step of a key
        runs eagerly, then the key is captured) and runs the eager loop on
        the CPU; False runs the eager loop on the card too; True demands the
        graphs and raises on the CPU, under classifier guidance, on a model
        paired by ``shard_module_`` and while int8 calibration records
        (``NotImplementedError``), where None runs the loop. Both give the
        same bits and draw the same stream. A capture or replay that raises
        surfaces here: nothing reruns the loop.

        ``row_shard=(rank, world)`` runs this rank's rows of a data-parallel
        chain (the counterpart of a ``P('data')``-sharded batch): ``x`` and
        ``y`` are the rank's rows of the global batch, ``batch_size`` (when
        ``x`` is None) is the global batch, and every draw is made at the
        global shape from ``generator``, which every rank seeds alike
        (``_noise``). The rank's rows then come out as the unsharded chain's
        rows: the chain is independent per example.

        ``encoder_cache=k`` ("Faster Diffusion", arXiv:2312.09608) runs the
        chain in groups of k steps: the first step of a group runs the UNet's
        encoder, the other k-1 reuse its bottom feature and skip activations
        while the timestep embedding and the decoder run at the current t.
        Opt-in and lossy; k = 1 is the plain chain. k is clamped to the
        chain's length; the last ``steps % k`` steps, nearest t = 0, run
        uncached; the cache never outlives its group.

        ``guidance_interval=(lo, hi)`` restricts classifier-free guidance to
        the chain fraction [lo, hi): 0.0 is the clean end (t = 0), 1.0 the
        noise end. Outside it a step makes one conditional model call instead
        of the doubled CFG batch. Opt-in and lossy against the always-guided
        chain. With the cache, a group is guided iff any of its steps falls
        in the interval (the cache's batch must be one within a group), so
        the guided range is never narrower than asked for.
        """
        if self.model.conditional:
            assert y is not None, "pass label iff model is class-conditional"
        else:
            assert y is None, "pass label iff model is class-conditional"

        if encoder_cache is not None and encoder_cache < 1:
            raise ValueError(
                f"encoder_cache must be >= 1 (got {encoder_cache}); k=1 is "
                "the exact uncached sampler, k>1 reuses encoder features "
                "for k-1 of every k steps"
            )

        if start_step is None:
            start_step = self.rescaled_num_steps
        if steps_to_do is None or steps_to_do > start_step:
            steps_to_do = start_step

        gi = None
        if guidance_interval is not None:
            if self.guidance != "classifier_free":
                raise ValueError(
                    "guidance_interval requires classifier-free guidance "
                    f"(this Diffusion uses {self.guidance!r})"
                )
            lo, hi = guidance_interval
            if not (0.0 <= lo < hi <= 1.0):
                raise ValueError(
                    f"guidance_interval must satisfy 0 <= lo < hi <= 1 "
                    f"(got {guidance_interval})"
                )
            # fractions of the executed chain -> rescaled step bounds;
            # guided iff lo_step <= t < hi_step
            gi = (round(lo * steps_to_do), round(hi * steps_to_do))
            if gi == (0, steps_to_do):  # covers everything: the plain chain
                gi = None
        graphed = self._use_graphs(cuda_graph)

        if x is None:
            assert start_step == self.rescaled_num_steps, (
                "cannot start from noise with current step that is not T"
            )
            m = self.model
            x = torch.randn(
                (batch_size, m.resolution, m.resolution, m.in_channels),
                generator=generator, dtype=torch.float32, device=self.device,
            )
            if row_shard is not None:
                x = shard_rows(x, *row_shard)
        if y is not None:
            assert y.shape[0] == x.shape[0], "len(labels) != batch size"

        plan = self._chain_plan(steps_to_do, encoder_cache, gi)
        if graphed and plan:
            return self._graphs.run(self, plan, x, y, generator, row_shard)
        x0_prev = torch.zeros_like(x) if self.sampler == "dpm++" else None
        cache = None
        for i, (ts, guided, cache_mode) in enumerate(plan):
            t = torch.full((x.shape[0],), ts, dtype=torch.long, device=x.device)
            # drawn before the model call: the generator feeds nothing else
            noise = None if self.sampler == "dpm++" else self._noise(x, generator, row_shard)
            x, x0_prev, cache = self._chain_step(x, x0_prev, t, y, noise, guided, cache_mode,
                                                 cache, i == 0)
        return x

    # ------------------------------------------------------------------
    # Training losses
    # ------------------------------------------------------------------

    def loss(self, x_0, t, generator=None, y=None, noise=None):
        """Training loss in bits/dim, one value per example (reference
        diffusion.py:375-410).

        SIMPLE: mean MSE(prediction, its native target). KL / KL_RESCALED: VLB term
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

        # the simple loss regresses the model's native target ('eps': the
        # noise; 'v': alpha*noise - sigma*x_0; regressing the converted eps
        # would re-weight the loss by alpha_t^2); the VLB always takes epsilon
        if self.prediction_type == "v":
            target = (_bcast(self._sqrt_acp, t, x_t.ndim) * noise
                      - _bcast(self._sqrt_1macp, t, x_t.ndim) * x_0)
        else:
            target = noise
        eps_pred = self._to_eps(pred, x_t, t)

        if self.loss_type == LossType.SIMPLE:
            return mean_flat((pred - target) ** 2)
        if self.loss_type in (LossType.KL, LossType.KL_RESCALED):
            loss = self.variational_lower_bound(x_0, x_t, t, eps_pred, log_var)
            if self.loss_type == LossType.KL_RESCALED:
                loss = loss * self.rescaled_num_steps
            return loss
        loss_simple = mean_flat((pred - target) ** 2)  # HYBRID
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
