"""Distillation for fast serving: guided (stage 1) and progressive (stage 2),
torch, one device.

Counterpart of nicediffusion_tpu/training/distill.py (see its docstring for
the math). ``GuidedDistiller`` bakes classifier-free guidance into a
single-forward conditional student (Meng et al., arXiv:2210.03142): the
student matches the guided teacher's epsilon on the teacher's own grid, so
serving makes one model call a step instead of the doubled CFG batch.
``ProgressiveDistiller`` halves the step count (Salimans & Ho,
arXiv:2202.00512): the student, on the teacher's odd rescaled indices
(``make_student_diffusion``), learns in one DDIM step what two teacher DDIM
steps (eta = 0) do, through the implied one-step target

    x~0 = (z'' - (sigma''/sigma_t) z_t) / (alpha'' - (sigma''/sigma_t) alpha_t)

Loss space (``_distill_loss``): ``"eps"`` (plain epsilon MSE, stage 1's
default for eps students) or ``"x0_snr"`` (the paper's truncated-SNR x0 loss,
max(1, s^2/a^2) times the epsilon MSE; stage 2's default, and stage 1's for
v students). ``var_weight`` also trains the learned-variance head: stage 1
pins the student's log-variance to the guided teacher's, stage 2 trains it
by the VLB on the student's own grid with its epsilon detached.

What differs from the JAX package, by design:

  * The JAX code runs one stateless Flax model under two parameter trees.
    Here there are modules: the ``model`` passed in is the student (loaded
    with ``teacher_params``, trained in place), the teacher a frozen copy of
    it with the teacher's weights, always called under ``torch.no_grad()``,
    and the EMA a third copy. All three stay in ``eval()`` mode, as the JAX
    steps are deterministic (no dropout).
  * The optimizer is optax's ``chain(clip_by_global_norm(c), adamw(rate))``
    over ``torch.optim.AdamW`` (``_make_optimizer``): the clip scales by
    c / norm only when norm >= c, with no epsilon (``clip_grad_norm_``
    divides by norm + 1e-6), and the rate is read at the update count before
    the update, so a warmup's first update has rate 0.
  * ``var_weight=0`` is normalised to ``None`` (off). The JAX distillers
    gate on ``is not None``, so there a weight of 0 computes a zero term and
    the CLI prints the "variance head trained" hint for an untrained head.
    Loss and gradients are the same either way.
  * Draws (the student step j, the noise) come from one ``torch.Generator``
    on the device seeded from ``seed``; ``train_step`` also takes them
    injected, so a test can feed the port the JAX run's draws. Metrics stay
    on the device and are read only at log boundaries.

CUDA graphs (``cuda_graph=None``, the default; the counterpart of the JAX
distillers' jitted steps): on a CUDA device ``train_step`` replays one
captured graph a step (training/graphs.py): j and the noise are drawn before
the replay, the schedule's rate is a device tensor filled before it, and the
graph holds the teacher's forwards, the student's forward and backward, the
clip, AdamW and the EMA, with the eager step's bits. ``cuda_graph=False``
keeps the eager step; ``True`` raises on the CPU and while int8 calibration
records.
"""

from __future__ import annotations

import copy
import math
from typing import Iterator, Mapping

import numpy as np
import torch

from ..diffusion.graphs import int8_recording, use_graphs, weight_signature
from ..diffusion.process import Diffusion, _bcast
from .graphs import TrainGraphs, hyperparameters, make_adamw, pointers, to_device

__all__ = ["GuidedDistiller", "ProgressiveDistiller", "make_student_diffusion"]


def _warmup_cosine(lr: float, iterations: int):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(iterations,
    warmup + 1), 0.1 * lr) with warmup = min(200, max(iterations // 20, 1))."""
    warmup = min(200, max(iterations // 20, 1))
    decay = max(iterations, warmup + 1) - warmup
    alpha = 0.1

    def rate(count: int) -> float:
        if count < warmup:  # linear 0 -> lr
            return -lr * (1.0 - count / warmup) + lr
        c = min(count - warmup, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

    return rate


class _Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(rate, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay))`` over ``params``, on
    ``torch.optim.AdamW`` (decoupled weight decay, optax's update term for
    term). ``step(grads)`` applies one update and returns the gradients'
    global norm before clipping, on the device: ``set_rate()`` (the host's
    part: the schedule's rate, a device tensor on the card, filled before a
    graph's replay), then ``apply(grads)`` (the device's, which a graph
    captures)."""

    def __init__(self, params, lr, weight_decay, iterations, grad_clip, lr_schedule):
        if lr_schedule == "warmup_cosine":
            self.rate = _warmup_cosine(lr, iterations)
        elif lr_schedule == "constant":
            self.rate = lambda count: lr
        else:
            raise ValueError(f"unknown lr_schedule {lr_schedule!r} (constant | warmup_cosine)")
        self.params = list(params)
        self.grad_clip = grad_clip
        self.adamw = make_adamw(self.params, lr, weight_decay, tensor_lr=True)
        self.count = 0  # updates so far: the schedule's argument

    def set_rate(self) -> None:
        """The rate of update ``count`` into the param groups."""
        rate = self.rate(self.count)
        for group in self.adamw.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(rate)
            else:
                group["lr"] = rate

    def apply(self, grads) -> torch.Tensor:
        """The clip and the AdamW update at the rate set; the norm before
        clipping."""
        grads = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip is not None:
            # optax: g where norm < c, else g / norm * c; no epsilon
            clip = norm.new_full((), self.grad_clip)
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm

    def step(self, grads) -> torch.Tensor:
        self.set_rate()
        norm = self.apply(grads)
        self.count += 1
        return norm


def _make_optimizer(params, lr: float, weight_decay: float, iterations: int,
                    grad_clip: float | None, lr_schedule: str) -> _Optimizer:
    """AdamW with optional global-norm clipping and warmup-cosine decay
    (``"warmup_cosine"`` ramps linearly to ``lr`` then cosine-decays to
    0.1 * lr over the run; ``"constant"`` keeps the flat rate)."""
    return _Optimizer(params, lr, weight_decay, iterations, grad_clip, lr_schedule)


def _distill_loss(loss_space: str, eps_s, eps_target, a, s):
    """MSE between student and target epsilon in the chosen space: ``"eps"``
    uniform, ``"x0_snr"`` the truncated-SNR x0 loss, max(1, s^2/a^2) times
    the epsilon MSE per sample."""
    if loss_space == "eps":
        return torch.mean((eps_s - eps_target) ** 2)
    if loss_space == "x0_snr":
        w = torch.clamp(a**2 / s**2, min=1.0)  # truncated SNR (App. E)
        x0_s = -(s / a) * eps_s  # offsets cancel in the difference
        x0_t = -(s / a) * eps_target
        return torch.mean(w * (x0_s - x0_t) ** 2)
    raise ValueError(f"unknown loss_space {loss_space!r} (eps | x0_snr)")


def make_student_diffusion(model, diffusion_args: dict, teacher: Diffusion,
                           prediction_type: str | None = None) -> Diffusion:
    """Student Diffusion on the teacher's odd rescaled indices (exact
    nesting: student acp[j] == teacher acp[2j+1]), DDIM with eta 0 and no
    guidance, on the teacher's device. ``prediction_type`` overrides the
    teacher's output convention for the student."""
    n = teacher.rescaled_num_steps
    assert n % 2 == 0, f"teacher steps must be even to halve, got {n}"
    args = dict(diffusion_args)
    args.update(
        rescaled_num_steps=n // 2, guidance_method=None, guidance_strength=None,
        use_ddim=True, ddim_eta=0.0,
        timestep_indices=teacher.timestep_map.cpu().numpy()[1::2],
        device=teacher.device,
    )
    if prediction_type is not None:
        args.update(prediction_type=prediction_type)
    return Diffusion(model=model, **args)


def _sqrt_tables(acp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sqrt(acp) and sqrt(1 - acp) of an f32 schedule table, made once on
    the host by numpy, whose f32 sqrt is correctly rounded as XLA's is
    (torch's CPU sqrt is not on every host: it moved JAX's bits by an ulp)."""
    a = acp.detach().cpu().numpy()
    return (torch.from_numpy(np.sqrt(a)).to(acp.device),
            torch.from_numpy(np.sqrt(np.float32(1) - a)).to(acp.device))


class _Distiller:
    """What both stages share: the three modules, the optimizer, the draws,
    the step and the loop. A subclass builds ``self.teacher`` and
    ``self.student`` (Diffusions over ``teacher_model`` and ``model``) and
    defines ``_losses``."""

    _label = "distill"

    def _init_state(self, model, teacher_params, dataloader, iterations, lr, weight_decay,
                    ema_rate, seed, grad_clip, lr_schedule, var_weight, cuda_graph):
        if teacher_params is not None:
            model.load_state_dict(
                {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                 for k, v in teacher_params.items()}, strict=True)
        self.model = model.eval().requires_grad_(True)
        self.device = next(model.parameters()).device
        self.teacher_model = copy.deepcopy(model).requires_grad_(False)
        self.ema_model = copy.deepcopy(model).requires_grad_(False)
        self._params = list(model.parameters())
        self._ema_params = list(self.ema_model.parameters())
        self.loader = dataloader
        self.iterations = iterations
        # 0 is off: a zero-weight term trains nothing (module docstring)
        self.var_weight = var_weight or None
        self.optimizer = _make_optimizer(self._params, lr, weight_decay, iterations,
                                         grad_clip, lr_schedule)
        self.ema_rate = ema_rate
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.cuda_graph = cuda_graph
        self._graphs = TrainGraphs()
        self._use_graphs()  # cuda_graph=True raises here where it cannot be had

    def train_step(self, batch, labels=None, *, j=None, noise=None):
        """One update of the student and its EMA. ``j`` (B,) student steps
        and ``noise`` (like batch) may be injected, else they are drawn from
        the generator (j first). Returns ``{"loss", "loss_eps", "loss_var",
        "grad_norm"}`` as scalars on the device; ``grad_norm`` is the norm
        before clipping."""
        x0 = to_device(batch, torch.float32, self.device)
        b = x0.shape[0]
        if j is None:
            j = torch.randint(0, self.student.rescaled_num_steps, (b,),
                              generator=self.generator, device=self.device)
        j = to_device(j, torch.long, self.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=self.generator, device=self.device)
        noise = to_device(noise, torch.float32, self.device)
        y = None
        if self.model.conditional and labels is not None:
            y = to_device(labels, torch.long, self.device)

        inputs = {"x0": x0, "y": y, "j": j, "noise": noise}
        if self._use_graphs():
            # the rate is set on the host before the replay, the update in the graph
            opt = self.optimizer
            opt.set_rate()
            out = self._graphs.run(self._graph_signature, self._graph_written(), inputs,
                                   self.generator, None,
                                   lambda inputs, draws: self._update(inputs, opt.apply))
            opt.count += 1
        else:
            out = self._update(inputs, self.optimizer.step)
        self.step += 1
        return out

    def _update(self, inputs: dict, update) -> dict:
        """The step past its draws: the losses, the student's gradients,
        ``update`` (the clipped AdamW update) and the EMA (no dropout: every
        model is in eval mode). What a graph captures; eager, it is the step
        itself."""
        loss_eps, loss_var = self._losses(inputs["x0"], inputs["y"], inputs["j"],
                                          inputs["noise"])
        loss = loss_eps + loss_var
        grads = torch.autograd.grad(loss, self._params)
        grad_norm = update(grads)
        with torch.no_grad():
            torch._foreach_mul_(self._ema_params, self.ema_rate)
            torch._foreach_add_(self._ema_params, self._params, alpha=1.0 - self.ema_rate)
        return {"loss": loss.detach(), "loss_eps": loss_eps.detach(),
                "loss_var": loss_var.detach(), "grad_norm": grad_norm}

    def _use_graphs(self) -> bool:
        """``cuda_graph``'s rule (diffusion/graphs.py ``use_graphs``) for
        this step."""
        return use_graphs(self.cuda_graph, self.device, self._graph_refusal())

    def _graph_refusal(self) -> str | None:
        """Why this distiller's step cannot be captured, or None."""
        if int8_recording(self.model) or int8_recording(self.teacher_model):
            return "int8 calibration is recording inside the forward"
        return None

    def _graph_written(self) -> list:
        """What a graphed step writes in place outside the pool: the
        student's parameters, the EMA and AdamW's state."""
        state = [v for s in self.optimizer.adamw.state.values() for v in s.values()
                 if isinstance(v, torch.Tensor)]
        return [*self._params, *self._ema_params, *state]

    def _graph_signature(self) -> tuple:
        """What the captures baked in: the pointers of what they write, the
        frozen teacher's weights (their versions too: a Winograd U made from
        them is read by the graph), the settings."""
        return (pointers(self._graph_written()), pointers(self.model.buffers()),
                weight_signature(self.teacher_model), hyperparameters(self.optimizer.adamw),
                self.optimizer.grad_clip, self.ema_rate, self.loss_space, self.var_weight,
                id(self.model), id(self.teacher), id(self.student),
                self.model.training, self.teacher_model.training,
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def reset_graphs(self) -> None:
        """Free the captured step graphs, their pool and static buffers."""
        self._graphs.reset()

    def _next_batch(self):
        return next(self.loader)

    def run(self, log_every: int | None = None):
        """Train for ``iterations`` steps; returns (the student's state dict,
        the student Diffusion). The live parameters, not the EMA copy: at
        typical budgets a 0.9999-decay EMA still carries most of its weight
        on the teacher's initialisation. The EMA stays in ``ema_model``."""
        for it in range(self.iterations):
            batch, labels = self._next_batch()
            metrics = self.train_step(batch, labels)
            if log_every and (it + 1) % log_every == 0:
                var_part = (f" (eps={metrics['loss_eps'].item():.5f}"
                            f" var={metrics['loss_var'].item():.5f})"
                            if self.var_weight is not None else "")
                print(f"{self._label} step {it + 1}/{self.iterations}: "
                      f"loss={metrics['loss'].item():.5f}{var_part} "
                      f"gnorm={metrics['grad_norm'].item():.3f}")
        return self.model.state_dict(), self.student


class GuidedDistiller(_Distiller):
    """Stage-1 guided distillation (Meng et al., arXiv:2210.03142 section
    3.1): train a single-forward conditional student to match the
    classifier-free-guided teacher (the doubled-batch call and the CFG mix at
    strength ``guidance_strength``) on the same timestep grid. The returned
    student samples unguided, with any sampler of ``diffusion_args``
    (stochastic DDPM too: the grid, and so the variance head, is the
    teacher's). ``model`` is the student, initialised from
    ``teacher_params`` (a state dict; None keeps the model's weights)."""

    _label = "guided-distill"

    def __init__(
        self,
        model,
        teacher_params: Mapping | None,
        diffusion_args: dict,
        dataloader: Iterator,
        iterations: int,
        guidance_strength: float,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        ema_rate: float = 0.9999,
        seed: int = 0,
        loss_space: str | None = None,
        grad_clip: float | None = 1.0,
        lr_schedule: str = "constant",
        student_prediction_type: str | None = None,
        var_weight: float | None = None,
        cuda_graph: bool | None = None,
    ):
        assert model.conditional, (
            "guided distillation needs a class-conditional model "
            "(the CFG teacher calls the null class internally)"
        )
        self._init_state(model, teacher_params, dataloader, iterations, lr, weight_decay,
                         ema_rate, seed, grad_clip, lr_schedule, var_weight, cuda_graph)
        t_args = dict(diffusion_args, guidance_method="classifier_free",
                      guidance_strength=guidance_strength)
        s_args = dict(diffusion_args, guidance_method=None, guidance_strength=None)
        if student_prediction_type is not None:
            # same-grid reparameterisation (e.g. eps teacher -> v student);
            # the eps-space target is unchanged
            s_args.update(prediction_type=student_prediction_type)
        self.teacher = Diffusion(model=self.teacher_model, **t_args)
        self._sqrt_acp, self._sqrt_1macp = _sqrt_tables(self.teacher._acp)
        self.student = Diffusion(model=self.model, **s_args)
        if loss_space is None:
            loss_space = "x0_snr" if self.student.prediction_type == "v" else "eps"
        self.loss_space = loss_space

    def _next_batch(self):
        batch, labels = next(self.loader)
        assert labels is not None, "guided distillation needs labels"
        return batch, labels

    def _losses(self, x0, y, j, noise):
        z = self.student.q_sample(x0, j, noise)
        a = _bcast(self._sqrt_acp, j, z.ndim)
        s = _bcast(self._sqrt_1macp, j, z.ndim)
        want_lv = self.var_weight is not None
        with torch.no_grad():
            eps_t, lv_t = self.teacher._guided_eps(z, j, y, want_log_var=want_lv)
        eps_s, lv_s = self.student._guided_eps(z, j, y, want_log_var=want_lv)
        loss_eps = _distill_loss(self.loss_space, eps_s, eps_t, a, s)
        if not want_lv:
            return loss_eps, torch.zeros((), device=z.device)
        # same grid: the guided teacher's resolved log-variance is the target
        return loss_eps, self.var_weight * torch.mean((lv_s - lv_t) ** 2)


class ProgressiveDistiller(_Distiller):
    """Distills ``model`` from ``teacher_params`` at N steps down to N/2
    (one ``run()`` is one halving round; chain rounds by building the next
    with the returned student as its teacher, as scripts/distill.py does).
    The teacher samples DDIM with eta 0 and no guidance; the student lives
    on the teacher's odd rescaled indices."""

    def __init__(
        self,
        model,
        teacher_params: Mapping | None,
        diffusion_args: dict,
        dataloader: Iterator,
        iterations: int,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        ema_rate: float = 0.9999,
        seed: int = 0,
        loss_space: str | None = None,
        grad_clip: float | None = 1.0,
        lr_schedule: str = "constant",
        student_prediction_type: str | None = None,
        var_weight: float | None = None,
        cuda_graph: bool | None = None,
    ):
        self._init_state(model, teacher_params, dataloader, iterations, lr, weight_decay,
                         ema_rate, seed, grad_clip, lr_schedule, var_weight, cuda_graph)
        args = dict(diffusion_args, guidance_method=None, guidance_strength=None,
                    use_ddim=True, ddim_eta=0.0)
        self.teacher = Diffusion(model=self.teacher_model, **args)
        self._sqrt_acp, self._sqrt_1macp = _sqrt_tables(self.teacher._acp)
        self._sqrt_acp_prev, self._sqrt_1macp_prev = _sqrt_tables(self.teacher._acp_prev)
        self.student = make_student_diffusion(self.model, diffusion_args, self.teacher,
                                              prediction_type=student_prediction_type)
        # the stage-2 default: the halving must be accurate where image
        # structure forms; also the bounded v-space weighting for v students
        self.loss_space = "x0_snr" if loss_space is None else loss_space

    @torch.no_grad()
    def _target_x0(self, z, j, y):
        """Two teacher DDIM steps from rescaled index t1 = 2j+1, then the
        implied one-step x0 target; returns (target, (a_t, s_t))."""
        t1, t2 = 2 * j + 1, 2 * j
        zero = torch.zeros_like(z)
        z1, _ = self.teacher.ddim_step(z, t1, y=y, noise=zero)
        z2, _ = self.teacher.ddim_step(z1, t2, y=y, noise=zero)
        nd = z.ndim
        a_t = _bcast(self._sqrt_acp, t1, nd)
        s_t = _bcast(self._sqrt_1macp, t1, nd)
        a_b = _bcast(self._sqrt_acp_prev, t2, nd)
        s_b = _bcast(self._sqrt_1macp_prev, t2, nd)
        ratio = s_b / s_t
        return (z2 - ratio * z) / (a_b - ratio * a_t), (a_t, s_t)

    def _losses(self, x0, y, j, noise):
        # q-sample at the student's grid point j (== teacher 2j+1)
        z = self.student.q_sample(x0, j, noise)
        target, (a_t, s_t) = self._target_x0(z, j, y)
        # the epsilon whose one DDIM step lands where the teacher's two did
        eps_t = (z - a_t * target) / s_t
        want_lv = self.var_weight is not None
        eps_s, lv_s = self.student._guided_eps(z, j, y, want_log_var=want_lv)
        loss_eps = _distill_loss(self.loss_space, eps_s, eps_t, a_t, s_t)
        if not want_lv:
            return loss_eps, torch.zeros((), device=z.device)
        # the variance head: the VLB on the student's halved grid, its
        # epsilon detached (IDDPM eq. 16 structure)
        vlb = self.student.variational_lower_bound(x0, z, j, eps_s.detach(), lv_s)
        return loss_eps, self.var_weight * torch.mean(vlb)
