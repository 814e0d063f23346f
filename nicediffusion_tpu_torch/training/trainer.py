"""Training orchestration: train step, AdamW, EMA, gradient accumulation,
checkpoint/resume, periodic sampling, metrics (torch, one device).

Counterpart of nicediffusion_tpu/training/trainer.py, with the same surface
(``train()``, ``sample()``, ``save()``, ``restore()``,
``latest_checkpoint_step()``, ``resume_step="auto"``) and the same
deliberate divergences from the original reference trainer:

  * ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``,
    which is optax's ``adamw`` update term for term.
  * Gradient accumulation with every micro-batch contributing and the mean
    taken over k, as ``optax.MultiSteps`` does (the reference only called
    backward() on accumulation boundaries, dropping the other micro-batches).
  * EMA is a *copy* of the model (the reference aliased the live
    parameters), updated on every call, also between accumulation
    boundaries: ``ema = r * ema + (1 - r) * p``.
  * t is drawn over the training chain's rescaled length (the reference drew
    over the original length and indexed rescaled tables).
  * CFG label drop is per example, to class 0, at 2%, and only under
    classifier-free guidance (the reference nulled the whole batch).
  * Metrics go to stdout and a JSONL sink (step, loss, grad_norm,
    steps_per_sec); the loss is summed on the device and read with
    ``.item()`` only at log boundaries, so a step does not wait for the host.

Every draw (t, label drop, noise, dropout masks, sampling) comes from one
``torch.Generator`` on the trainer's device, seeded from ``seed``;
``train_step`` also takes injected draws, so a test can feed this trainer
and the JAX one the same numbers. Checkpoints are ``checkpoint_dir/step_{N}/
state.pt`` written with ``torch.save``: model, EMA, optimizer state, pending
accumulated gradients and step. Multi-GPU training is ROADMAP work. Reading
the JAX trainer's orbax directories is not ported (orbax is built on jax):
the JAX package's scripts/export.py turns one into a ``.pt``, and
utils/convert.py::train_state_to_torch carries its optimizer state across.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from ..diffusion.process import Diffusion
from ..utils.device import resolve_device

__all__ = ["Trainer"]


class Trainer:
    """Owns the training loop; mirrors the JAX Trainer's surface. The state
    is the model (live parameters), ``ema_model``, ``optimizer`` and
    ``step`` (the number of ``train_step`` calls so far)."""

    def __init__(
        self,
        model,
        diffusion_args: dict,
        dataloader: Iterator,
        iterations: int,
        batch_size: int,
        lr: float,
        weight_decay: float,
        ema_rate: float = 0.9999,
        grad_accumulation: int = 1,
        checkpoint_dir: str = "checkpoints",
        resume_step: int | str | None = None,
        init_params: Mapping[str, torch.Tensor] | None = None,
        print_every: int | None = None,
        sample_every: int | None = None,
        save_every: int | None = None,
        label_drop_prob: float = 0.02,
        seed: int = 0,
        metrics_path: str | None = None,
        sample_callback: Callable | None = None,
        device: torch.device | str | None = None,
    ):
        if device is None:
            device = next(model.parameters()).device
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loader = dataloader
        self.iterations = iterations
        self.batch_size = batch_size
        self.ema_rate = ema_rate
        self.grad_accumulation = grad_accumulation
        self.checkpoint_dir = checkpoint_dir
        self.print_every = print_every
        self.sample_every = sample_every
        self.save_every = save_every
        self.label_drop_prob = label_drop_prob
        self.sample_callback = sample_callback
        self.metrics_path = metrics_path

        if init_params is not None:
            self.model.load_state_dict(init_params, strict=True)
        # copy, not alias (reference trainer.py:55 aliases)
        self.ema_model = copy.deepcopy(self.model).eval().requires_grad_(False)
        self._params = list(self.model.parameters())
        self._ema_params = list(self.ema_model.parameters())

        # Two diffusion objects from one args dict, like reference
        # trainer.py:34-36: the training chain as configured, and a forced
        # 250-step DDPM chain (clamped to the original chain length) over
        # the EMA weights for in-training sampling.
        diffusion_args = dict(diffusion_args)
        self.train_diffusion = Diffusion(model=self.model, **diffusion_args)
        sampling_args = dict(
            diffusion_args,
            rescaled_num_steps=min(250, diffusion_args["original_num_steps"]),
            use_ddim=False,
        )
        self.sampling_diffusion = Diffusion(model=self.ema_model, **sampling_args)
        self._use_cfg_drop = (
            self.model.conditional
            and self.train_diffusion.guidance == "classifier_free"
            and label_drop_prob > 0
        )

        self.optimizer = torch.optim.AdamW(
            self._params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
        # mean of the micro-batch gradients since the last optimizer step
        self._grad_accum: list[torch.Tensor] | None = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0

        if resume_step == "auto":
            # crash-resume ergonomics: pick the newest checkpoint if any
            resume_step = self.latest_checkpoint_step()
        if resume_step is not None:
            self.restore(resume_step)

    # ------------------------------------------------------------------

    def train_step(self, batch, labels, *, t=None, noise=None, drop=None):
        """One micro-batch: loss, gradients, (every k-th call) the AdamW
        update, and the EMA update. ``t`` (B,), ``noise`` (like batch) and
        ``drop`` (B,) bool may be injected; else they are drawn from the
        trainer's generator. Returns ``{"loss", "grad_norm"}`` as scalars
        on the device."""
        x0 = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        b = x0.shape[0]
        diffusion = self.train_diffusion
        if t is None:
            # fixed t-range: sample over the *training* chain
            t = torch.randint(0, diffusion.rescaled_num_steps, (b,),
                              generator=self.generator, device=self.device)
        t = torch.as_tensor(t, dtype=torch.long, device=self.device)
        y = None
        if self.model.conditional:
            y = torch.as_tensor(labels, dtype=torch.long, device=self.device)
            if self._use_cfg_drop:
                if drop is None:
                    drop = torch.rand((b,), generator=self.generator,
                                      device=self.device) < self.label_drop_prob
                drop = torch.as_tensor(drop, dtype=torch.bool, device=self.device)
                y = torch.where(drop, torch.zeros_like(y), y)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)

        self.model.train()
        loss = diffusion.loss(x0, t, generator=self.generator, y=y, noise=noise).mean()
        grads = torch.autograd.grad(loss, self._params)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

        k = self.grad_accumulation
        if k > 1:
            # running mean over the micro-batches, in optax.MultiSteps' form:
            # acc += (g - acc) / (micro-batches so far)
            mini = self.step % k
            if self._grad_accum is None:
                self._grad_accum = [torch.zeros_like(g) for g in grads]
            torch._foreach_add_(self._grad_accum, torch._foreach_sub(grads, self._grad_accum),
                                alpha=1.0 / (mini + 1))
            grads = self._grad_accum if mini == k - 1 else None
        if grads is not None:
            for p, g in zip(self._params, grads):
                p.grad = g
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self._grad_accum = None

        with torch.no_grad():
            torch._foreach_mul_(self._ema_params, self.ema_rate)
            torch._foreach_add_(self._ema_params, self._params, alpha=1.0 - self.ema_rate)
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    # ------------------------------------------------------------------

    def train(self):
        """Run the training loop (reference trainer.py:66-115)."""
        metrics_file = None
        if self.metrics_path:
            os.makedirs(os.path.dirname(self.metrics_path) or ".", exist_ok=True)
            metrics_file = open(self.metrics_path, "a")

        running_loss = torch.zeros((), device=self.device)
        running_count = 0
        t_last = time.time()
        start_step = self.step
        try:
            for step in range(self.iterations):
                batch, labels = next(self.loader)
                if labels is None:  # unconditional loaders may yield labels=None
                    labels = np.zeros((np.shape(batch)[0],), dtype=np.int64)
                metrics = self.train_step(batch, labels)

                log_every = self.print_every
                if log_every is None and metrics_file is not None:
                    log_every = 10  # JSONL sink works without stdout printing
                if log_every is not None:
                    running_loss = running_loss + metrics["loss"]
                    running_count += 1
                    if step % log_every == 0 or step == self.iterations - 1:
                        avg = running_loss.item() / max(running_count, 1)
                        dt = time.time() - t_last
                        sps = running_count / dt if dt > 0 else 0.0
                        if self.print_every is not None:
                            print(
                                f"Step #{step}  ------------------------------"
                                f"------------\n\tLoss={avg}  ({sps:.2f} steps/s)"
                            )
                        if metrics_file is not None:
                            metrics_file.write(json.dumps({
                                "step": start_step + step,
                                "loss": avg,
                                "grad_norm": metrics["grad_norm"].item(),
                                "steps_per_sec": sps,
                            }) + "\n")
                            metrics_file.flush()
                        running_loss = torch.zeros((), device=self.device)
                        running_count = 0
                        t_last = time.time()

                # periodic sample/save skip step 0; None or 0 mean "never"
                if self.sample_every and step > 0 and step % self.sample_every == 0:
                    self.sample(4)
                if self.save_every and step > 0 and step % self.save_every == 0:
                    self.save(start_step + step)

            self.save(start_step + self.iterations)
        finally:
            if metrics_file is not None:
                metrics_file.close()

    # ------------------------------------------------------------------

    def sample(self, num_samples: int):
        """Sample with EMA weights through the forced 250-step DDPM chain
        (reference trainer.py:117-134). Returns uint8 NHWC images as numpy;
        a ``sample_callback(images, labels)`` (e.g. save-to-png) replaces the
        reference's blocking matplotlib display."""
        y = None
        if self.model.conditional:
            y = torch.randint(0, self.model.num_classes, (num_samples,),
                              generator=self.generator, device=self.device)
        out = self.sampling_diffusion.denoise(self.generator, y=y, batch_size=num_samples)
        out = ((out + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        if self.sample_callback is not None:
            self.sample_callback(out, y.cpu().numpy() if y is not None else None)
        return out

    # ------------------------------------------------------------------

    def latest_checkpoint_step(self) -> int | None:
        """Newest step_{N} checkpoint under checkpoint_dir, or None."""
        if not os.path.isdir(self.checkpoint_dir):
            return None
        steps = [
            int(name[len("step_"):])
            for name in os.listdir(self.checkpoint_dir)
            if name.startswith("step_") and name[len("step_"):].isdigit()
        ]
        return max(steps) if steps else None

    def _ckpt_path(self, step: int) -> str:
        return os.path.abspath(os.path.join(self.checkpoint_dir, f"step_{step}", "state.pt"))

    def save(self, step: int):
        """Write {model, ema, optimizer, grad_accum, step} to
        ``checkpoint_dir/step_{step}/state.pt`` (the reference wrote three
        .pt files, trainer.py:136-141). The file is written beside its final
        name and renamed, so a reader never sees half a checkpoint."""
        path = self._ckpt_path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({
            "step": self.step,
            "model": self.model.state_dict(),
            "ema": self.ema_model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "grad_accum": self._grad_accum,
        }, path + ".tmp")
        os.replace(path + ".tmp", path)
        print("Saved checkpoint!")

    def restore(self, step: int) -> int:
        """Load a checkpoint written by save() into the model, the EMA, the
        optimizer and the step count (reference trainer.py:45-52); returns
        the restored step count."""
        state = torch.load(self._ckpt_path(step), map_location=self.device, weights_only=True)
        self.load_train_state(state["model"], state["ema"], state["optimizer"]["state"],
                              state["step"])
        self._grad_accum = state["grad_accum"]
        return self.step

    def load_train_state(self, model_state, ema_state, adamw_state, step: int):
        """Set the whole training state: model and EMA state dicts, AdamW's
        per-parameter state keyed by position in ``model.parameters()``
        (``exp_avg``, ``exp_avg_sq``, ``step``; empty before the first
        update), and the step count. Values may be tensors or numpy arrays,
        as utils/convert.py::train_state_to_torch gives them."""
        def tensors(tree):
            # numpy values are copied: AdamW updates its state in place, and
            # an array may be a view of memory its maker still uses
            return {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
                    for k, v in tree.items()}

        self.model.load_state_dict(tensors(model_state), strict=True)
        self.ema_model.load_state_dict(tensors(ema_state), strict=True)
        state = {i: tensors(s) for i, s in adamw_state.items()}
        for s in state.values():
            # AdamW reads its step count on the host at every update; a count
            # on the card would make each parameter's update wait for it
            s["step"] = s["step"].cpu()
        self.optimizer.load_state_dict({
            "state": state,
            "param_groups": self.optimizer.state_dict()["param_groups"],
        })
        self._grad_accum = None
        self.step = int(step)
