"""Training orchestration: train step, AdamW, EMA, gradient accumulation,
checkpoint/resume, periodic sampling, metrics (torch; one device, or one
process per GPU, data-parallel).

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
and the JAX one the same numbers.

CUDA graphs (``cuda_graph=None``, the default; the counterpart of the JAX
trainer's one jitted step): on a CUDA device ``train_step`` replays one
captured graph a step (training/graphs.py; a key's first step eager, then
captured), its draws made before the replay in the eager order, with the
eager step's bits. AdamW is capturable on the card either way.
``cuda_graph=False`` keeps the eager step; ``True`` raises on the CPU, on
the data- and tensor-parallel trainers (their collectives) and while int8
calibration records, where None runs eagerly.

Checkpoints are ``checkpoint_dir/step_{N}/state.pt`` written with
``torch.save``: model, EMA, optimizer state, pending accumulated gradients
and step. Reading the JAX trainer's orbax directories
is not ported (orbax is built on jax): the JAX package's scripts/export.py
turns one into a ``.pt``, and utils/convert.py::train_state_to_torch carries
its optimizer state across.

Data parallelism (``distributed=True``, the counterpart of the JAX
``Trainer(mesh=)``): one process per GPU in a ``torch.distributed`` group
(parallel/multihost.py), every rank holding the whole model.
  * ``batch_size`` is the global batch; each rank's loader yields its share,
    ``batch_size // world`` rows, and ``train_step`` takes that share (and
    the rank's rows of any injected t, noise or drop).
  * At construction the model is broadcast from rank 0, then copied into the
    EMA, so every rank starts from rank 0's weights.
  * Every micro-batch's gradients and loss are averaged over the ranks
    (``parallel/mesh.py::all_reduce_mean_``, flat buckets) before the norm,
    the accumulation and the update, as every jitted micro-step of the JAX
    trainer all-reduces: ``loss`` and ``grad_norm`` are the global batch's on
    every rank, and every rank takes the same update. The gradients are
    taken with ``torch.autograd.grad``, which fires none of
    DistributedDataParallel's hooks, so the reduce is explicit.
  * Rank 0 draws from ``seed``, so a group of one draws what a single
    process draws; rank r > 0 draws its t, label drop, noise and dropout
    masks from a generator seeded from (seed, r).
  * Rank 0 alone writes checkpoints and metrics, prints and calls
    ``sample_callback``; ``save`` ends in a barrier. ``restore`` reads on
    every rank; ``resume_step="auto"`` takes rank 0's newest step.
  * ``sample()`` runs sharded over the ranks (``Diffusion.denoise``'s row
    shard) from rank 0's generator state and gathers the images to rank 0.

Tensor parallelism (``mesh=make_mesh(num_data, num_model)`` with
``num_model > 1``, the counterpart of the JAX ``Trainer(mesh=)`` with a
'model' axis; ``distributed=True`` is ``mesh=make_mesh(world, 1)``):
  * the model is broadcast whole from rank 0, then sharded by the
    Megatron-paired table (models/unet.py ``shard_module_``); parameters,
    EMA and AdamW's moments are the rank's shards (the moments are
    elementwise, so the placement is exact);
  * everything data-parallel above goes by the **data coordinate**, not the
    global rank: the rows (``batch_size // num_data`` a rank; model peers
    feed the same rows, so a loader is seeded by the data coordinate), the
    draws (model peers draw the same t, drops, noise and dropout masks), the
    gradient mean (over the data group only) and the sample's row shard;
  * a replicated parameter's gradient is the same on model peers by
    construction (parallel/tensor.py), up to the card's kernels that are not
    bit-reproducible (a weight gradient summed with atomics): so the
    replicated gradients are also averaged over the model group, and model
    peers keep the same replicated parameters bit for bit (at ``openai_64``,
    37.8M of the 295.9M parameters); ``grad_norm`` sums the squares of the
    sharded gradients over the model group and counts the replicated ones
    once: the unsharded norm;
  * ``save`` gathers a full checkpoint to rank 0 (model, EMA, AdamW's
    moments, pending accumulated gradients, step): a one-process Trainer
    restores it, and the JAX package's export reads its model; ``restore``
    reads a full checkpoint and keeps the rank's slices, each checked
    against its parameter's shape;
  * ``sample()`` runs the chain on every model peer with the sharded EMA
    model and the same draws; the data group shards the rows and rank 0
    writes.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.graphs import int8_recording, use_graphs
from ..diffusion.process import Diffusion
from ..models.unet import shard_module_
from ..parallel.mesh import (
    all_reduce_mean_,
    broadcast_module_,
    gather_rows,
    make_mesh,
    shard_rows,
)
from ..parallel.sharding import gather_tensor, shard_tensor
from ..utils.device import resolve_device
from .graphs import TrainGraphs, hyperparameters, make_adamw, pointers, to_device

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
        distributed: bool = False,
        mesh=None,
        cuda_graph: bool | None = None,
    ):
        if device is None:
            device = next(model.parameters()).device
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.distributed = distributed or mesh is not None
        self.rank, self.world = 0, 1
        if self.distributed:
            if not dist.is_initialized():
                raise RuntimeError("distributed=True or a mesh needs a process group: call "
                                   "parallel.maybe_initialize_distributed() first")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if mesh is None:
                mesh = make_mesh(self.world, 1)
        self.mesh = mesh
        # the data coordinate and the data axis's size: what rows and draws go by
        self.data_rank, self.num_data = (mesh.data_rank, mesh.num_data) if mesh else (0, 1)
        self.tp = mesh if mesh is not None and mesh.num_model > 1 else None
        if batch_size % self.num_data:
            raise ValueError(f"global batch {batch_size} must divide the data axis "
                             f"{self.num_data}")
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
        if self.world > 1:
            broadcast_module_(self.model)  # rank 0's weights on every rank
        self._dims = {}  # parameter name -> its sharded dimension (None: replicated)
        if self.tp is not None:
            shard_module_(self.model, self.tp)
            self._dims = self.model.tp_dims
        # copy, not alias (reference trainer.py:55 aliases)
        self.ema_model = copy.deepcopy(self.model).eval().requires_grad_(False)
        self._names = [n for n, _ in self.model.named_parameters()]
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

        # capturable on the card, so the eager step and its graph take the same math
        self.optimizer = make_adamw(self._params, lr, weight_decay)
        # the accumulators, one per parameter (static: outside the graphs'
        # pool), and the pending round's mean of the micro-batch gradients
        # since the last optimizer step (them, a restored list, or None)
        self._accum_buffers: list[torch.Tensor] | None = None
        self._grad_accum: list[torch.Tensor] | None = None
        self.cuda_graph = cuda_graph
        self._graphs = TrainGraphs()
        self._use_graphs()  # cuda_graph=True raises here where it cannot be had
        # data coordinate 0 keeps the seed; the others draw their own t,
        # drops, noise and dropout masks (model peers draw the same)
        if self.data_rank:
            seed = int(np.random.SeedSequence([seed, self.data_rank]).generate_state(1)[0])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0

        if resume_step == "auto":
            # crash-resume ergonomics: pick the newest checkpoint if any
            # (rank 0's, on every rank)
            resume_step = self._from_rank0(self.latest_checkpoint_step())
        if resume_step is not None:
            self.restore(resume_step)

    def _from_rank0(self, value: int | None) -> int | None:
        """Rank 0's ``value`` (an int or None) on every rank."""
        if self.world == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # ------------------------------------------------------------------

    def train_step(self, batch, labels, *, t=None, noise=None, drop=None):
        """One micro-batch: loss, gradients, (every k-th call) the AdamW
        update, and the EMA update. ``t`` (B,), ``noise`` (like batch) and
        ``drop`` (B,) bool may be injected; else they are drawn from the
        trainer's generator. Data-parallel, ``batch``, ``labels`` and the
        injected draws are this data coordinate's rows. Returns ``{"loss",
        "grad_norm"}`` (of the global batch) as scalars on the device, each
        the caller's own.

        On a CUDA device (``cuda_graph=None``) the step replays one captured
        graph (training/graphs.py): its draws are made here, in the eager
        order, and the graph does the rest, with the eager step's bits.
        ``cuda_graph=False`` keeps the eager step."""
        x0, t, y, noise = self._draws(batch, labels, t, noise, drop)
        k = self.grad_accumulation
        mini = self.step % k
        if k > 1:
            self._start_accumulation()
        self.model.train()
        if self._use_graphs():
            out = self._graphed_step(x0, t, y, noise, mini)
        else:
            out = self._update({"x0": x0, "t": t, "y": y, "noise": noise}, self.generator,
                               mini)
        if k > 1 and mini == k - 1:
            self._grad_accum = None  # applied
        self.step += 1
        return out

    def _start_accumulation(self) -> None:
        """Point ``_grad_accum`` at the accumulators, made once a parameter
        layout: zeroed when a round starts, a restored round copied in.
        Eager and graphed steps alike, so a graph and the eager step read and
        write the same buffers."""
        acc = self._accum_buffers
        if acc is None or any(a.shape != p.shape or a.device != p.device
                              for a, p in zip(acc, self._params)):
            acc = self._accum_buffers = [torch.zeros_like(p) for p in self._params]
        if self._grad_accum is None:  # a new round
            torch._foreach_zero_(acc)
        elif self._grad_accum is not acc:  # restored: carried into the buffers
            torch._foreach_copy_(acc, self._grad_accum)
        self._grad_accum = acc

    def _draws(self, batch, labels, t, noise, drop):
        """The step's inputs on the device, every draw not injected made from
        the generator in the eager order: t, the CFG label drop, the loss
        noise (then, in the forward, the dropout masks)."""
        x0 = to_device(batch, torch.float32, self.device)
        b = x0.shape[0]
        diffusion = self.train_diffusion
        if t is None:
            # fixed t-range: sample over the *training* chain
            t = torch.randint(0, diffusion.rescaled_num_steps, (b,),
                              generator=self.generator, device=self.device)
        t = to_device(t, torch.long, self.device)
        y = None
        if self.model.conditional:
            y = to_device(labels, torch.long, self.device)
            if self._use_cfg_drop:
                if drop is None:
                    drop = torch.rand((b,), generator=self.generator,
                                      device=self.device) < self.label_drop_prob
                drop = to_device(drop, torch.bool, self.device)
                y = torch.where(drop, torch.zeros_like(y), y)
        if noise is None:
            noise = diffusion._noise(x0, self.generator)
        noise = to_device(noise, torch.float32, self.device)
        return x0, t, y, noise

    def _update(self, inputs: dict, dropout, mini: int) -> dict:
        """The step past its draws: loss, gradients, their mean over the
        group, the accumulation, AdamW and the EMA; ``dropout`` (the
        generator, or a graph's ``DropoutDraws``) feeds the masks. What a
        graph captures; eager, it is the step itself."""
        loss = self.train_diffusion.loss(inputs["x0"], inputs["t"], generator=dropout,
                                         y=inputs["y"], noise=inputs["noise"]).mean()
        grads = torch.autograd.grad(loss, self._params)
        grads, loss = self._reduce(grads, loss.detach())
        grad_norm = self._grad_norm(grads)

        k = self.grad_accumulation
        if k > 1:
            # running mean over the micro-batches, in optax.MultiSteps' form:
            # acc += (g - acc) / (micro-batches so far)
            acc = self._grad_accum
            torch._foreach_add_(acc, torch._foreach_sub(grads, acc), alpha=1.0 / (mini + 1))
            grads = acc if mini == k - 1 else None
        if grads is not None:
            for p, g in zip(self._params, grads):
                p.grad = g
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)

        with torch.no_grad():
            torch._foreach_mul_(self._ema_params, self.ema_rate)
            torch._foreach_add_(self._ema_params, self._params, alpha=1.0 - self.ema_rate)
        return {"loss": loss, "grad_norm": grad_norm}

    def _use_graphs(self) -> bool:
        """``cuda_graph``'s rule (diffusion/graphs.py ``use_graphs``) for
        this step."""
        return use_graphs(self.cuda_graph, self.device, self._graph_refusal())

    def _graph_refusal(self) -> str | None:
        """Why this trainer's step cannot be captured, or None (ROADMAP.md
        queue A item 2: the collectives need NCCL capture on a host with
        several GPUs)."""
        if self.tp is not None:
            return "a tensor-parallel trainer runs collectives over its model group"
        if self.distributed:
            return "a data-parallel trainer all-reduces its gradients over the process group"
        if int8_recording(self.model):
            return "int8 calibration is recording inside the forward"
        return None

    def _graph_written(self) -> list:
        """What a graphed step writes in place outside the pool: parameters,
        EMA, AdamW's state and the accumulators."""
        state = [v for s in self.optimizer.state.values() for v in s.values()
                 if isinstance(v, torch.Tensor)]
        return [*self._params, *self._ema_params, *state, *(self._accum_buffers or ())]

    def _graph_signature(self) -> tuple:
        """What the captures baked in: the pointers of what they read and
        write outside the pool, and the settings."""
        d = self.train_diffusion
        return (pointers(self._graph_written()), pointers(self.model.buffers()),
                hyperparameters(self.optimizer), self.ema_rate, self.grad_accumulation,
                id(self.model), id(d), d.loss_type, d.prediction_type, d.sampling_var_type,
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def _graphed_step(self, x0, t, y, noise, mini: int) -> dict:
        """``_update`` through one captured graph a key (the input shapes
        and, with accumulation, the micro-step's position)."""
        return self._graphs.run(
            self._graph_signature, self._graph_written(),
            {"x0": x0, "t": t, "y": y, "noise": noise}, self.generator, mini,
            lambda inputs, draws: self._update(inputs, draws, mini))

    def reset_graphs(self) -> None:
        """Free the captured step graphs, their pool and static buffers."""
        self._graphs.reset()

    def _reduce(self, grads, loss):
        """This micro-batch's gradients and loss averaged over the data
        group, in place, in flat buckets (data-parallel; in a group of one
        the collective runs and changes nothing); tensor-parallel, the
        replicated gradients then over the model group too."""
        if self.distributed and self.mesh.data_group is not None:
            all_reduce_mean_([*grads, loss], group=self.mesh.data_group)
        if self.tp is not None:
            all_reduce_mean_([g for n, g in zip(self._names, grads) if self._dims[n] is None],
                             group=self.mesh.model_group)
        return grads, loss

    def _grad_norm(self, grads):
        """The global norm of the gradients; under tensor parallelism the
        sharded ones' squares summed over the model group, the replicated
        ones counted once."""
        def squares(gs):
            if not gs:
                return torch.zeros((), device=self.device)
            return torch.stack(torch._foreach_norm(gs)).square().sum()

        if self.tp is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sharded = [g for n, g in zip(self._names, grads) if self._dims[n] is not None]
        replicated = [g for n, g in zip(self._names, grads) if self._dims[n] is None]
        total = squares(sharded)
        dist.all_reduce(total, group=self.mesh.model_group)
        return (total + squares(replicated)).sqrt()

    # ------------------------------------------------------------------

    def train(self):
        """Run the training loop (reference trainer.py:66-115)."""
        metrics_file = None
        if self.metrics_path and self.rank == 0:
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

                log_every = self.print_every if self.rank == 0 else None
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
                    # 4, or a multiple of the data axis
                    self.sample(-(-4 // self.num_data) * self.num_data)
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
        reference's blocking matplotlib display.

        Data-parallel, every rank calls it: each denoises its data
        coordinate's rows of the ``num_samples`` (which the data axis must
        divide) from rank 0's generator state (model peers the same rows,
        with their shards of the EMA model), the images are gathered to rank
        0, which advances its generator as a single process would, calls the
        callback and returns them; the other ranks return None."""
        generator = self.generator
        if self.world > 1:
            state = [self.generator.get_state() if self.rank == 0 else None]
            dist.broadcast_object_list(state, src=0)
            generator = torch.Generator(device=self.device)
            generator.set_state(state[0])
        y = None
        if self.model.conditional:
            y = torch.randint(0, self.model.num_classes, (num_samples,),
                              generator=generator, device=self.device)
        d, n = self.data_rank, self.num_data
        out = self.sampling_diffusion.denoise(
            generator, y=None if y is None else shard_rows(y, d, n),
            batch_size=num_samples, row_shard=(d, n) if n > 1 else None)
        out = ((out + 1) * 127.5).clamp(0, 255).to(torch.uint8)
        if n == 1:
            out = out.cpu()
        elif self.mesh.model_rank == 0:  # the data group that holds rank 0
            out = gather_rows(out, group=self.mesh.data_group)
        if self.rank:
            return None
        if generator is not self.generator:
            self.generator.set_state(generator.get_state())
        out = out.numpy()
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
        name and renamed, so a reader never sees half a checkpoint.
        Data-parallel, rank 0 writes (every rank holds the same state) and
        every rank waits for it at a barrier. Tensor-parallel, rank 0's
        model group first gathers the whole state, so the file is what one
        process would write."""
        state = None
        if self.tp is None:
            state = self._state()
        elif self.data_rank == 0:  # the model group that holds rank 0
            state = self._each_tensor(self._state(), lambda t, d: gather_tensor(t, d, self.tp))
        if self.rank == 0:
            path = self._ckpt_path(step)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(state, path + ".tmp")
            os.replace(path + ".tmp", path)
            print("Saved checkpoint!")
        if self.world > 1:
            dist.barrier()

    def _state(self) -> dict:
        """{step, model, ema, optimizer, grad_accum}: what ``save`` writes."""
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema_model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "grad_accum": self._grad_accum}

    def _each_tensor(self, state: dict, fn) -> dict:
        """``state`` (as ``_state`` gives it) with ``fn(tensor, dim)`` in
        place of every tensor of one parameter's shape: the model's and the
        EMA's by name, AdamW's moments and the accumulated gradients by
        position; ``dim`` is the parameter's sharded dimension or None."""
        names, dims = self._names, self._dims

        def by_name(sd):
            return {n: fn(v, dims.get(n)) for n, v in sd.items()}

        adamw = {i: {k: v if k == "step" else fn(v, dims[names[int(i)]]) for k, v in s.items()}
                 for i, s in state["optimizer"]["state"].items()}
        accum = state["grad_accum"]
        if accum is not None:
            accum = [fn(a, dims[n]) for n, a in zip(names, accum)]
        return dict(state, model=by_name(state["model"]), ema=by_name(state["ema"]),
                    optimizer=dict(state["optimizer"], state=adamw), grad_accum=accum)

    def restore(self, step: int) -> int:
        """Load a checkpoint written by save() into the model, the EMA, the
        optimizer and the step count (reference trainer.py:45-52); returns
        the restored step count. Tensor-parallel, each whole tensor of the
        checkpoint is cut to this rank's slice by the table."""
        state = torch.load(self._ckpt_path(step), map_location=self.device, weights_only=True)
        if self.tp is not None:
            state = self._each_tensor(state, lambda t, d: shard_tensor(t, d, self.tp))
        model, ema, adamw, accum = (state["model"], state["ema"], state["optimizer"]["state"],
                                    state["grad_accum"])
        self.load_train_state(model, ema, adamw, state["step"])
        if accum is not None:
            for n, p, a in zip(self._names, self._params, accum):
                if a.shape != p.shape:
                    raise ValueError(f"checkpoint's accumulated gradient of {n} has shape "
                                     f"{tuple(a.shape)}, the parameter {tuple(p.shape)}")
        self._grad_accum = accum
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
        for i, s in state.items():
            shape = self._params[int(i)].shape
            for k in ("exp_avg", "exp_avg_sq"):
                if k in s and s[k].shape != shape:
                    raise ValueError(f"AdamW's {k} of {self._names[int(i)]} has shape "
                                     f"{tuple(s[k].shape)}, the parameter {tuple(shape)}")
            # on the host as a plain AdamW reads it; a capturable one (on the
            # card) moves it to the device as f32 in load_state_dict
            s["step"] = s["step"].cpu()
        self.optimizer.load_state_dict({
            "state": state,
            "param_groups": self.optimizer.state_dict()["param_groups"],
        })
        self._grad_accum = None
        self.step = int(step)
        # AdamW's state tensors are new: a graph captured before would write
        # freed memory
        self._graphs.reset()
