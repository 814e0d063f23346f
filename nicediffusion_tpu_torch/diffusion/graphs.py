"""CUDA graphs of the reverse chain's step (torch).

Counterpart of the JAX sampler's compiled chain: ``_make_sampler`` in
nicediffusion_tpu/diffusion/process.py wraps the chain's ``lax.scan`` in
``jax.jit`` and keeps the program per key (``_sampler_cache``), so a chain
makes no host round trip a step. ``Diffusion.denoise`` on a CUDA device
replays one captured ``torch.cuda.CUDAGraph`` a step instead of issuing the
step's ~1,000 launches from Python, with the eager loop's bits.

One graph serves every t of a chain: t is an input. A graph is kept per key:

- the shapes and types of the static inputs (x, y and the tensors of
  ``model_kwargs``, such as SR's ``low_res``);
- ``guided`` (the doubled CFG batch or the single conditional call);
- the step's encoder-cache role (none, refresh or reuse);
- for DPM++, whether it is the chain's first step.

The sampler and its settings, the model's mode, the TF32 flags and a
signature of the model's weights (``data_ptr()`` and ``_version`` of every
parameter and buffer, read once a chain) are held for all of a cache's
graphs: when any of them changes, every graph is freed and captured anew.
So an in-place ``load_state_dict``, ``freeze_int8`` or a replaced module
never replays stale weights or a stale Winograd U (models/unet.py
``WinogradConv``).

What a graph holds: the static buffers (x f32 NHWC, t, y, ``x0_prev``, the
step's noise, the ``model_kwargs`` tensors, the encoder cache's features),
allocated outside the graphs' pool; the captured body (the guided eps, the
step update and a last in-place copy of the new x and ``x0_prev`` into
their buffers; on a refresh, of the encoder's features into theirs). What
the host does a step: fill t, draw the step's noise from the caller's
generator with the eager loop's ``_noise`` (so every variant draws the
stream it draws eagerly, and no generator state lives in a graph), replay.
The reuse graph reads the features the refresh graph wrote; no graph reads
what another graph left in the pool, so the graphs of one pool replay in
any order, one at a time.

Memory: the pool keeps what one step allocates for as long as the graphs
live (measured on an H100 at ``openai_64``, model batch 16: 0.645 GiB in
bf16, 5.086 GiB at model batch 128; 37.535 GiB in f32, where cuDNN's f32
convs take workspaces of up to 15 GiB that the eager loop frees between
convs, against the eager forward's 16.9 GiB peak). ``reset_graphs()`` then
``torch.cuda.empty_cache()`` returns it; ``cuda_graph=False`` keeps the
eager loop where memory is short.

The first step of a key runs its body eagerly on the static buffers (that
builds the kernels, makes U, initialises cuBLAS and cuDNN's plans), then the
key is captured, and its later steps replay. A capture, instantiation or
replay that raises surfaces from ``denoise``: nothing falls back.

The launch counters (each kernel wrapper's ``.launches``,
``attention.route_launches``) count in Python: a capture runs their
increments without launching, a replay launches without running them. So a
capture's increments are taken back out and each replay adds them again
(``StepGraph``): the counts read as the eager chain's, in every window.
``TALLIES`` lists the counters; a harness may add its own (an int, a
Counter or an append-only list) for the span of a run.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import types
from typing import Callable

import torch

from ..ops.kernels import attention, conv, groupnorm, int8conv, resblock, winograd

__all__ = ["ChainGraphs", "StepGraph", "TALLIES", "weight_signature"]

# (owner, name): the Python-side counts a step's kernels change, each an int,
# a Counter or an append-only list, read as ``owner[name]`` on a dict and
# ``getattr(owner, name)`` otherwise
TALLIES: list = [
    (attention.fused_qkv_attention, "launches"),
    (attention.fused_qkv_attention_bwd, "launches"),
    (attention.mha_attention, "launches"),
    (attention, "route_launches"),
    (conv.conv_nhwc, "launches"),
    (groupnorm.group_norm_fused, "launches"),
    (groupnorm.group_norm_fused_bwd, "launches"),
    (int8conv.int8_conv_nhwc, "launches"),
    (resblock.gn_silu_conv3x3, "launches"),
    (winograd.winograd_conv_nhwc, "launches"),
]


def _get(owner, name):
    return owner[name] if isinstance(owner, dict) else getattr(owner, name)


def _set(owner, name, value):
    if isinstance(owner, dict):
        owner[name] = value
    else:
        setattr(owner, name, value)


def read_tallies(tallies) -> list:
    """A snapshot: ints as they are, Counters copied, lists by length."""
    out = []
    for owner, name in tallies:
        v = _get(owner, name)
        out.append(len(v) if isinstance(v, list) else
                   collections.Counter(v) if isinstance(v, dict) else v)
    return out


def tallies_since(tallies, before) -> list:
    """What each tally gained since the snapshot ``before``."""
    out = []
    for (owner, name), b in zip(tallies, before):
        v = _get(owner, name)
        out.append(v[b:] if isinstance(v, list) else
                   collections.Counter(v) - b if isinstance(v, dict) else v - b)
    return out


def restore_tallies(tallies, before) -> None:
    """Put every tally back to the snapshot ``before`` (Counters and lists
    in place)."""
    for (owner, name), b in zip(tallies, before):
        v = _get(owner, name)
        if isinstance(v, list):
            del v[b:]
        elif isinstance(v, dict):
            v.clear()
            v.update(b)
        else:
            _set(owner, name, b)


def add_tallies(tallies, delta, times: int = 1) -> None:
    """Add ``delta`` (``tallies_since``'s) ``times`` over."""
    for (owner, name), d in zip(tallies, delta):
        v = _get(owner, name)
        if isinstance(v, list):
            v.extend(d * times)
        elif isinstance(v, dict):
            for key, n in d.items():
                v[key] = v.get(key, 0) + n * times
        else:
            _set(owner, name, v + d * times)


class StepGraph:
    """One captured step: ``record(body)`` captures it (``torch.cuda.graph``
    around the body) and returns what ``replay()`` runs; the tallies the
    capture changed are taken back out, and every replay adds them again."""

    def __init__(self, body: Callable[[], None], record: Callable, tallies=None):
        self.tallies = TALLIES if tallies is None else tallies
        before = read_tallies(self.tallies)
        try:
            self.graph = record(body)
            self.delta = tallies_since(self.tallies, before)
        finally:
            restore_tallies(self.tallies, before)

    def replay(self) -> None:
        self.graph.replay()
        add_tallies(self.tallies, self.delta)


def weight_signature(model: torch.nn.Module) -> tuple:
    """``(data_ptr(), _version)`` of every parameter and buffer, in module
    order: a replaced tensor, an in-place write (``load_state_dict``) or a
    buffer added or dropped (``freeze_int8``) changes it. A tensor made
    under inference mode has no version counter: its pointer stands alone."""
    return tuple((t.data_ptr(), None if t.is_inference() else t._version)
                 for t in itertools.chain(model.parameters(), model.buffers()))


def _settings(diffusion) -> tuple:
    """What a capture bakes in besides the weights: the sampler's settings
    (host floats become kernel arguments), the model's mode and identity,
    and the TF32 flags (cuBLAS's and cuDNN's choice of algorithm)."""
    d = diffusion
    return (d.sampler, d.guidance, d.strength, d.ddim_eta, d.clip_x, d.dynamic_threshold,
            d.prediction_type, d.sampling_var_type, id(d.model), d.model.training,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _spec(t):
    """The key of a static input: shape, type and device of a tensor, the
    value of anything else."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), t.dtype, t.device
    return t


@contextlib.contextmanager
def _model_kwargs(diffusion, kwargs: dict):
    """The model calls of the body read ``kwargs`` (the static buffers)."""
    saved = diffusion.model_kwargs
    diffusion.model_kwargs = kwargs
    try:
        yield
    finally:
        diffusion.model_kwargs = saved


class _Buffers:
    """The static inputs and outputs of one shape's graphs, allocated
    outside the graphs' pool."""

    def __init__(self, x, y, kwargs, dpmpp: bool):
        self.x = torch.empty_like(x, dtype=torch.float32)
        self.t = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
        self.y = None if y is None else torch.empty_like(y)
        self.noise = None if dpmpp else torch.empty_like(self.x)
        self.x0_prev = torch.zeros_like(self.x) if dpmpp else None
        self.kwargs = {k: torch.empty_like(v) if isinstance(v, torch.Tensor) else v
                       for k, v in kwargs.items()}
        # the encoder cache's features by ``guided``: (bottom feature, skips)
        self.cache: dict = {}

    def load(self, x, y, kwargs):
        """A chain's start: its x, labels and model kwargs."""
        self.x.copy_(x)
        if y is not None:
            self.y.copy_(y)
        for k, v in kwargs.items():
            if isinstance(v, torch.Tensor):
                self.kwargs[k].copy_(v)
        if self.x0_prev is not None:
            self.x0_prev.zero_()


class ChainGraphs:
    """A Diffusion's captured step graphs (``Diffusion._graphs``): one
    ``StepGraph`` a key, one memory pool for all, the static buffers they
    read and write. ``capture=False`` keeps the body run eagerly in place of
    each graph, so the graphed path's buffers, plan and counts run on the
    CPU."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        # one chain at a time: the graphs share their static buffers and pool
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        """Free every graph, the pool and the static buffers."""
        with self._lock:
            self.signature = None
            self.graphs: dict = {}
            self.buffers: dict = {}
            self.pool = None

    def _record(self, body):
        if not self.capture:  # a replay runs the body eagerly
            return types.SimpleNamespace(replay=body)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the daemon captures on its worker thread while other
        # threads may touch the card
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            body()
        return graph

    def _step(self, key, body) -> None:
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        body()  # the key's first step: eagerly, on the static buffers
        self.graphs[key] = StepGraph(body, self._record)

    def run(self, diffusion, plan, x, y, generator, row_shard) -> torch.Tensor:
        """The chain of ``plan`` (``Diffusion._chain_plan``) from ``x``: a
        replay a step (the key's first step eager, then captured). Returns
        the final x as a new tensor."""
        with self._lock:
            return self._run(diffusion, plan, x, y, generator, row_shard)

    def _run(self, diffusion, plan, x, y, generator, row_shard) -> torch.Tensor:
        signature = (weight_signature(diffusion.model), _settings(diffusion))
        if signature != self.signature:
            self.reset()
            self.signature = signature
        kwargs = diffusion.model_kwargs
        dpmpp = diffusion.sampler == "dpm++"
        shapes = (_spec(x), _spec(y), tuple(sorted((k, _spec(v)) for k, v in kwargs.items())))
        buf = self.buffers.get(shapes)
        if buf is None:
            buf = self.buffers[shapes] = _Buffers(x, y, kwargs, dpmpp)
        buf.load(x, y, kwargs)
        for i, (ts, guided, cache_mode) in enumerate(plan):
            first = dpmpp and i == 0
            buf.t.fill_(ts)
            if not dpmpp:
                buf.noise.copy_(diffusion._noise(buf.x, generator, row_shard))
            self._step((shapes, guided, cache_mode, first),
                       functools.partial(self._body, diffusion, buf, guided, cache_mode, first))
        return buf.x.clone()

    @staticmethod
    def _body(diffusion, buf, guided, cache_mode, first) -> None:
        """What a graph captures: one ``Diffusion._chain_step`` from the
        static buffers into them."""
        cache = buf.cache.get(guided) if cache_mode == "reuse" else None
        with _model_kwargs(diffusion, buf.kwargs):
            x, x0_prev, cache = diffusion._chain_step(
                buf.x, buf.x0_prev, buf.t, buf.y, buf.noise, guided, cache_mode, cache, first)
        if cache_mode == "refresh":
            h, xs = cache
            if guided not in buf.cache:  # at the key's eager first step: outside the pool
                buf.cache[guided] = (torch.empty_like(h), [torch.empty_like(s) for s in xs])
            kept_h, kept_xs = buf.cache[guided]
            kept_h.copy_(h)
            for kept, s in zip(kept_xs, xs):
                kept.copy_(s)
        buf.x.copy_(x)
        if x0_prev is not None:
            buf.x0_prev.copy_(x0_prev)
