"""CUDA graphs of the training steps (torch).

Counterpart of the JAX package's jitted steps: the JAX trainer runs one
jitted, donated train step (loss, gradient, optimizer and EMA in a single
XLA program; nicediffusion_tpu/training/trainer.py), and both distillers jit
theirs the same way (nicediffusion_tpu/training/distill.py). On a CUDA
device ``Trainer.train_step`` and the distillers' ``train_step`` replay one
captured ``torch.cuda.CUDAGraph`` a step instead of issuing the step's
thousands of launches from Python (forward, remat recompute, autograd's
backward, the kernels' backward launches, AdamW, EMA), with the eager step's
bits.

It builds on the chain's graphs (diffusion/graphs.py): ``KeyedGraphs`` (a
key's first step runs eagerly on the static buffers, then the key is
captured; one pool for all keys), ``StepGraph`` and ``TALLIES`` (the launch
counters read as the eager step's), ``use_graphs`` (the ``cuda_graph``
rule). What a training step adds:

- **Draws.** Every draw of a step is made on the host's stream before the
  replay, in the eager order, into static buffers: the Trainer's t, CFG
  label drop and loss noise, the distillers' j and noise, and the dropout
  masks' uniforms (``models/unet.py::DropoutDraws``: recorded at the first
  step, drawn anew before each later one). No generator is read inside a
  graph, so the generator's end state is the eager step's, and the remat
  recompute replays the masks by a host cursor.
- **AdamW.** ``make_adamw`` builds ``torch.optim.AdamW`` with
  ``capturable=True`` on a CUDA device, in the eager step too: the step
  counts live on the card and the bias corrections are computed there, so
  graph and eager take the same math. A rate that moves (the distillers'
  schedule) is a device tensor filled before each step.
- **Accumulation.** The Trainer's accumulated gradients are static buffers
  outside the pool; a key per micro-step position (its ``1 / (mini + 1)`` is
  baked in), and the buffers are zeroed or filled on the host before a step
  that starts a round or follows a restore.
- **Outputs.** The step's metrics are copied into static outputs, and each
  step returns clones of them: tensors the caller owns.
- **Versions.** A replay writes the parameters, the EMA, AdamW's state and
  the accumulators without moving their version counters, which
  ``WinogradConv``'s kept U and the chain graphs' ``weight_signature`` read;
  every step bumps them (``torch.autograd.graph.increment_version``).
- **Signature.** The pointers of everything a step writes or reads outside
  the pool (parameters, EMA, AdamW's state, the accumulators, a frozen
  teacher's weights with their versions) and the settings a capture bakes
  in (host floats, TF32 flags) drop every graph when they move: a restore or
  ``load_train_state`` replaces AdamW's tensors, and a graph captured before
  would write freed memory.

No graph reads what another graph left in the pool: every tensor that
outlives a step is a static buffer. ``capture=False`` runs each graph's body
eagerly in place of its replay, so the graphed path (buffers, keys, draws,
clones) runs on the CPU for the tests.

Memory: the pool keeps what one step allocates (activations, the saved
tensors of autograd, cuDNN's workspaces) for as long as the graphs live,
beside the eager allocator's cache. ``reset_graphs()`` on the owner, then
``torch.cuda.empty_cache()``, returns it; ``cuda_graph=False`` keeps the
eager step where memory is short.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..diffusion.graphs import KeyedGraphs, _spec
from ..models.unet import DropoutDraws

__all__ = ["TrainGraphs", "hyperparameters", "make_adamw", "pointers", "to_device"]


def to_device(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``, where a host
    array bound for the card goes through pinned memory and a non-blocking
    copy: a copy from pageable memory would wait for the step the card is
    still running, and the host could not stage the next one meanwhile."""
    t = torch.as_tensor(value, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def make_adamw(params, lr: float, weight_decay: float, tensor_lr: bool = False
               ) -> torch.optim.AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay) over
    ``params``. On a CUDA device ``capturable=True`` (the step counts on the
    card, the bias corrections computed there) whether or not the step is
    graphed, so the eager step and its graph take the same math; with
    ``tensor_lr`` the rate is a device tensor the caller fills before each
    update. On the CPU the plain optimizer with a host rate."""
    params = list(params)
    if params[0].device.type != "cuda":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    rate = torch.tensor(float(lr), device=params[0].device) if tensor_lr else lr
    opt = torch.optim.AdamW(params, lr=rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=True)
    # the eager step takes the capturable math on purpose (same bits as the
    # graph): no warning about running it uncaptured
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def hyperparameters(optimizer: torch.optim.Optimizer) -> tuple:
    """The param groups' settings a capture bakes in; a tensor (a rate filled
    before each step) by its pointer."""
    return tuple(tuple((k, ("tensor", v.data_ptr()) if isinstance(v, torch.Tensor) else v)
                       for k, v in sorted(g.items()) if k != "params")
                 for g in optimizer.param_groups)


def pointers(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


class _Buffers:
    """The static inputs of one input shape's graphs, the step's dropout
    draws and its outputs, all outside the pool."""

    def __init__(self, inputs: dict, generator):
        self.inputs = {k: None if v is None else torch.empty_like(v) for k, v in inputs.items()}
        self.draws = DropoutDraws(generator)
        self.outputs: dict | None = None  # made at the key's eager first step

    def load(self, inputs: dict) -> None:
        for k, v in inputs.items():
            if v is not None:
                self.inputs[k].copy_(v)
        self.draws.refill()


class TrainGraphs(KeyedGraphs):
    """A trainer's or distiller's captured steps (``_graphs``): one
    ``StepGraph`` a key (input shapes and the caller's ``variant``), one
    pool, the static buffers."""

    def run(self, signature: Callable[[], tuple], written: list, inputs: dict, generator,
            variant, body: Callable[[dict, DropoutDraws], dict]) -> dict:
        """One step of ``body(inputs, draws) -> {name: tensor}`` on the
        static copies of ``inputs`` (tensors or None): the key's first step
        eager, then captured; a replay after. ``signature()`` is read before
        the step (a move drops every graph) and again after a capture (the
        eager first step may make state, such as AdamW's). ``written``: the
        tensors the step updates in place outside the pool, whose versions
        are bumped. Returns clones of the outputs."""
        with self._lock:
            self.check(signature())
            spec = tuple(sorted((k, _spec(v)) for k, v in inputs.items()))
            buf = self.buffers.get(spec)
            if buf is None:
                buf = self.buffers[spec] = _Buffers(inputs, generator)
            buf.load(inputs)
            key = (spec, variant)
            captured = key not in self.graphs
            self._step(key, functools.partial(self._body, buf, body))
            if captured:
                self.signature = signature()
            torch.autograd.graph.increment_version(written)
            return {k: v.clone() for k, v in buf.outputs.items()}

    @staticmethod
    def _body(buf: _Buffers, body) -> None:
        """What a graph captures: the step from the static inputs, its
        outputs copied into theirs."""
        buf.draws.set_state(0)
        out = body(buf.inputs, buf.draws)
        if buf.outputs is None:  # at the key's eager first step: outside the pool
            buf.outputs = {k: torch.empty_like(v) for k, v in out.items()}
        for k, v in out.items():
            buf.outputs[k].copy_(v)
