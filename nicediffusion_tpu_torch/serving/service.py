"""Batched sampling service: the sampler as a long-lived daemon (torch).

Counterpart of nicediffusion_tpu/serving/service.py. One reverse chain at a
fixed serving batch, into which concurrent requests are packed:

  * One shape. `ServingConfig.serve_batch` fixes the batch dimension;
    requests are packed into it and short batches are padded with zero rows
    (label 0), computed and discarded, so every chain runs the kernels at the
    same shapes.
  * Micro-batching with a linger window. The worker thread collects queued
    requests until the batch is full or `linger_ms` has passed since the
    first queued request, then runs one chain. FIFO: a request that does not
    fit the space left waits for the next batch. Occupancy is in `stats()`.
  * Per-request determinism. Each request's x_T comes from a CPU
    `torch.Generator` seeded with the request's seed (`_draw_x`), moved to
    the device with the rest of the batch in one copy, so a given (seed,
    label) starts from the same x_T on the CPU and on the card, whichever
    batch and row it lands in. With a deterministic sampler (DDIM eta=0,
    dpm++) its output does not depend on the row it lands in or on its
    batch mates at the serve batch, bit for bit, in float32 and in bfloat16
    (where every conv runs the bf16 conv kernel, whose sums for a row do not
    depend on the rest of the batch; ops/kernels/conv.py). Step noise
    (DDPM) comes from a device generator seeded from (rng_seed, k) for the
    k-th served batch, the counterpart of ``jax.random.fold_in(rng, k)``.
  * Serving modes are fixed at construction: the model's dtype (and a frozen
    int8 model), encoder_cache, guidance_interval.

Threading: `submit()` is thread-safe and returns a
`concurrent.futures.Future`; all device work, `warmup()` included, runs on
the single worker thread. Grad mode, inference mode and the current stream
are per thread in torch, and the first chain builds the kernels (nvcc), so
that work too stays on the worker.

Data parallelism (``distributed=True``, the counterpart of the JAX
``SamplerService(mesh=)``): one process per GPU in a torch.distributed group
(parallel/multihost.py), every rank holding the same weights (the serving
entry point loads one checkpoint on each). One process per card, not one
thread driving several: the served batch at 8 is already bound by the host.
  * Rank 0 keeps the queue, the batcher, the worker thread and the HTTP front
    end. For every chain, warmup included, its worker broadcasts a header
    (kind, k, rows) and the global x_T and labels as CPU tensors (gloo).
  * Every rank denoises its rows of the batch (``Diffusion.denoise``'s row
    shard): step noise comes from the (rng_seed, k) generator, drawn at the
    global shape, so the rows come out as a single process computes them.
    `gather_rows` brings them to rank 0, which resolves the futures.
  * A chain that raises on any rank fails that batch alone, as one process
    fails it: before the gather the ranks agree on a status (one small
    all-reduce), so every rank skips the gather together and rank 0 fails
    the batch's futures; the ranks then take the next header. Only an error
    of the collectives themselves (a rank gone) ends the group.
  * The other ranks call `follow()`, which blocks until rank 0's `close()`
    sends a stop header. While no request comes, rank 0 sends an idle header
    every ``KEEPALIVE_S`` seconds, well inside the group's timeout: a
    follower fails by that timeout only when rank 0 is gone.
  * ``serve_batch`` must be a multiple of the world size; `stats()` is rank
    0's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import gather_rows, shard_rows
from ..utils.device import resolve_device

__all__ = ["ServingConfig", "SamplerService", "KEEPALIVE_S"]

# the header rank 0 broadcasts before each chain: (kind, k, rows)
_STOP, _WARMUP, _BATCH, _IDLE = range(4)
# longest a data-parallel follower waits for a header while rank 0 is idle
KEEPALIVE_S = 30.0


class _BatchFailed(RuntimeError):
    """A data-parallel chain raised on some rank; every rank skipped the gather."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Frozen serving-time configuration for one `SamplerService`."""

    serve_batch: int = 32
    linger_ms: float = 5.0
    encoder_cache: int | None = None
    guidance_interval: tuple[float, float] | None = None
    rng_seed: int = 0


@dataclasses.dataclass
class _Request:
    labels: np.ndarray | None  # [n] int, or None (unconditional model)
    n: int
    seed: int
    future: Future
    enqueued_at: float
    warmup: bool = False  # warmup()'s chain: its own generator, not counted


class SamplerService:
    """Micro-batching sampler over one reverse chain at a fixed batch.

    Parameters
    ----------
    diffusion:
        A configured `Diffusion` whose model holds its weights (sampler,
        steps, guidance: the chain the service serves). A quantized model
        is frozen (`freeze_int8`) before it is served.
    config:
        `ServingConfig`. ``serve_batch`` is the batch every chain runs at.
    device:
        Where the chain runs; ``None`` means the CUDA card (and raises where
        there is none). It must be the diffusion's device.
    distributed:
        Serve data-parallel over the default process group (module
        docstring): rank 0 takes requests, the other ranks `follow()`.
    """

    def __init__(self, diffusion, config: ServingConfig | None = None, device=None,
                 distributed: bool = False):
        self.diffusion = diffusion
        self.config = config or ServingConfig()
        if self.config.serve_batch < 1:
            raise ValueError("serve_batch must be >= 1")
        self._rank, self._world = 0, 1
        if distributed:
            if not dist.is_initialized():
                raise RuntimeError("distributed=True needs a process group: call "
                                   "parallel.maybe_initialize_distributed() first")
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            if self.config.serve_batch % self._world:
                raise ValueError(
                    f"serve_batch={self.config.serve_batch} must be a multiple of the "
                    f"'data' axis size {self._world} (the process count)"
                )
        device = resolve_device(device)
        if diffusion.device.type != device.type or device.index not in (
                None, diffusion.device.index):
            raise ValueError(f"the diffusion lives on {diffusion.device}, the service on {device}")
        self.device = diffusion.device

        model = diffusion.model
        self._sample_shape = (model.resolution, model.resolution, model.in_channels)
        self._conditional = bool(model.conditional)
        self._num_classes = getattr(model, "num_classes", None)

        self._batch_counter = 0
        self._queue: list[_Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self._warm = False
        self._stats = {
            "requests": 0, "samples": 0, "batches": 0, "padded_rows": 0,
            "sample_seconds": 0.0,
        }

        self._worker = None
        if self._rank == 0:
            self._worker = threading.Thread(target=self._run, name="sampler-service",
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def warmup(self):
        """Run the chain once at ``serve_batch`` on the worker thread and
        block until it is done.

        The first chain builds the kernels (nvcc) and cuDNN's plans for the
        serve shape; call this at startup so the first request does not pay
        for them. It draws from a generator of its own and is not counted
        in `stats()`. On a following rank it does nothing: that rank runs
        rank 0's warmup chain inside `follow()`.
        """
        if self._rank:
            return self
        cap = self.config.serve_batch
        req = _Request(
            labels=np.zeros((cap,), np.int64) if self._conditional else None,
            n=cap, seed=0, future=Future(), enqueued_at=time.monotonic(), warmup=True,
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.insert(0, req)
            self._cond.notify_all()
        req.future.result()
        return self

    def submit(self, labels=None, n: int | None = None, seed: int | None = None) -> Future:
        """Enqueue a sampling request; returns a Future of [n, H, W, C]
        float32 numpy images in [-1, 1].

        ``labels``: per-sample class labels (conditional models only).
        ``n``: sample count (defaults to len(labels) or 1).
        ``seed``: per-request x_T seed: the same (seed, labels) starts from
        the same noise whatever the batching.
        """
        if self._rank:
            raise RuntimeError(f"rank {self._rank} follows rank 0: submit on rank 0")
        if self._conditional:
            if labels is None:
                raise ValueError("model is class-conditional: pass labels")
            labels = np.asarray(labels, dtype=np.int64).reshape(-1)
            if self._num_classes is not None and (
                (labels < 0).any() or (labels >= self._num_classes).any()
            ):
                raise ValueError(f"labels must be in [0, {self._num_classes})")
            n = len(labels) if n is None else int(n)
            if n != len(labels):
                raise ValueError("n != len(labels)")
        else:
            if labels is not None:
                raise ValueError("model is unconditional: labels not allowed")
            n = 1 if n is None else int(n)
        if not 1 <= n <= self.config.serve_batch:
            raise ValueError(
                f"request size {n} not in [1, serve_batch={self.config.serve_batch}]"
            )

        fut: Future = Future()
        req = _Request(
            labels=labels, n=n,
            seed=int(seed) if seed is not None else
            np.random.SeedSequence().entropy % (2 ** 31),
            future=fut, enqueued_at=time.monotonic(),
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.append(req)
            self._stats["requests"] += 1
            self._cond.notify_all()
        return fut

    def sample(self, labels=None, n: int | None = None, seed: int | None = None,
               timeout: float | None = None):
        """Blocking convenience wrapper around `submit()`."""
        return self.submit(labels, n, seed).result(timeout=timeout)

    def stats(self) -> dict:
        """Counts and rates as plain Python numbers (``/stats`` dumps them
        as JSON)."""
        with self._cond:
            s = dict(self._stats)
            s["warm"] = self._warm
            s["queue_depth"] = len(self._queue)
        s["serve_batch"] = self.config.serve_batch
        if s["batches"]:
            served = s["samples"] + s["padded_rows"]
            s["occupancy"] = s["samples"] / served if served else 0.0
            if s["sample_seconds"] > 0:
                s["samples_per_sec"] = s["samples"] / s["sample_seconds"]
        return s

    def close(self):
        """Stop the worker; outstanding requests are failed. Data-parallel,
        rank 0's worker then sends the stop header that ends `follow()` on
        the other ranks."""
        with self._cond:
            self._closed = True
            pending, self._queue = self._queue, []
            self._cond.notify_all()
        for req in pending:
            req.future.set_exception(RuntimeError("service closed"))
        if self._worker is not None:
            self._worker.join(timeout=30)

    def follow(self):
        """On a rank > 0 of a data-parallel service: take part in every chain
        rank 0 runs (denoise this rank's rows, send them to rank 0) until
        rank 0 sends the stop header; then return. Blocks the calling thread,
        which does the device work."""
        if self._rank == 0:
            raise RuntimeError("rank 0 serves; follow() is for the other ranks")
        cap = self.config.serve_batch
        while True:
            header = torch.empty(3, dtype=torch.long)
            dist.broadcast(header, src=0)
            kind, k, _ = header.tolist()
            if kind == _STOP:
                with self._cond:
                    self._closed = True
                return
            if kind == _IDLE:
                continue
            x = torch.empty((cap, *self._sample_shape), dtype=torch.float32)
            dist.broadcast(x, src=0)
            y = None
            if self._conditional:
                y = torch.empty((cap,), dtype=torch.long)
                dist.broadcast(y, src=0)
            try:
                self._denoise(x, y, None if kind == _WARMUP else k)
            except _BatchFailed:  # rank 0 fails the batch; take the next header
                traceback.print_exc()
                continue
            with self._cond:
                self._warm = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # Worker
    # ------------------------------------------------------------------

    def _draw_x(self, seed: int, n: int) -> torch.Tensor:
        """A request's start noise: N(0, I) from a CPU generator seeded with
        ``seed``, so the draw is the same whatever the device."""
        g = torch.Generator().manual_seed(seed)
        return torch.randn((n, *self._sample_shape), generator=g, dtype=torch.float32)

    def _step_generator(self, k: int | None) -> torch.Generator:
        """The device generator of the k-th served batch's step noise, seeded
        from (rng_seed, k) alone; ``None``: warmup's own."""
        seed = 0 if k is None else int(
            np.random.SeedSequence([self.config.rng_seed, k]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _collect(self) -> list[_Request] | None:
        """Block until there is work, apply the linger window, and pack
        head-of-queue requests into <= serve_batch rows (FIFO: a request
        that does not fit the remaining space waits for the next batch).
        Returns None once closed; data-parallel, an empty list after
        KEEPALIVE_S with nothing queued."""
        cap = self.config.serve_batch
        idle_s = KEEPALIVE_S if self._world > 1 else None
        with self._cond:
            while not self._queue and not self._closed:
                if not self._cond.wait(timeout=idle_s):
                    return []
            if self._closed:
                return None  # close() failed what was queued
            deadline = self._queue[0].enqueued_at + self.config.linger_ms / 1e3
            while not self._closed:
                rows = 0
                for r in self._queue:
                    if rows + r.n > cap:
                        rows = cap
                        break
                    rows += r.n
                remaining = deadline - time.monotonic()
                if rows >= cap or remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            if self._closed:
                return None  # close() raced the linger wait and failed the queue
            batch, rows = [], 0
            while self._queue and rows + self._queue[0].n <= cap:
                req = self._queue.pop(0)
                batch.append(req)
                rows += req.n
            return batch

    def _send_header(self, kind: int, k: int = 0, rows: int = 0):
        if self._world > 1:
            dist.broadcast(torch.tensor([kind, k, rows], dtype=torch.long), src=0)

    def _run(self):
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    self._send_header(_STOP)
                    return
                if not batch:  # idle: keep the followers inside the group's timeout
                    self._send_header(_IDLE)
                    continue
                try:
                    self._serve_batch(batch)
                except Exception as e:  # a CUDA, kernel or collective error fails this batch
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(e)
        except Exception as e:  # a header that could not be sent: the group is gone
            traceback.print_exc()
            with self._cond:
                self._closed = True
                pending, self._queue = self._queue, []
            for req in pending:
                req.future.set_exception(e)

    def _denoise(self, x: torch.Tensor, y: torch.Tensor | None, k: int | None):
        """The chain over a whole served batch (CPU x_T and labels) with the
        k-th batch's step generator (``None``: warmup's); data-parallel, this
        rank's rows of it. Returns the batch's f32 images as a CPU tensor on
        rank 0 (gathered), None on the other ranks. Data-parallel, a chain
        that raised on any rank raises `_BatchFailed` on every rank, and no
        rank enters the gather."""
        if self._world == 1:
            return self._chain(x, y, k, None)
        try:
            out, failed = self._chain(x, y, k, (self._rank, self._world)), None
        except Exception as e:  # told to every rank, then raised below
            out, failed = None, e
        status = torch.tensor([failed is not None], dtype=torch.long)
        dist.all_reduce(status)  # the ranks whose chain raised
        if status.item():
            raise _BatchFailed(f"the chain raised on {status.item()} of {self._world} "
                               f"ranks" + (f": {failed!r}" if failed else "")) from failed
        return gather_rows(out)

    def _chain(self, x, y, k, row_shard):
        """``_denoise``'s chain on this rank's rows, to a CPU f32 tensor: the
        batch's one host sync, so a device error raises here."""
        cfg = self.config
        if row_shard:
            x = shard_rows(x, *row_shard)
            y = None if y is None else shard_rows(y, *row_shard)
        x = x.to(self.device)
        y = y.to(self.device) if y is not None else None
        out = self.diffusion.denoise(
            self._step_generator(k), x=x, y=y, batch_size=cfg.serve_batch,
            encoder_cache=cfg.encoder_cache, guidance_interval=cfg.guidance_interval,
            row_shard=row_shard,
        )
        return out.float().cpu()

    def _serve_batch(self, batch: list[_Request]):
        cap = self.config.serve_batch
        rows = sum(r.n for r in batch)
        pad = cap - rows
        warmup = batch[0].warmup

        xs = [self._draw_x(r.seed, r.n) for r in batch]
        if pad:
            xs.append(torch.zeros((pad, *self._sample_shape), dtype=torch.float32))
        x = torch.cat(xs) if len(xs) > 1 else xs[0]
        y = None
        if self._conditional:
            ys = np.zeros((cap,), np.int64)
            off = 0
            for r in batch:
                ys[off:off + r.n] = r.labels
                off += r.n
            y = torch.from_numpy(ys)

        k = None
        if not warmup:
            k = self._batch_counter
            self._batch_counter += 1

        t0 = time.monotonic()
        self._send_header(_WARMUP if warmup else _BATCH, -1 if warmup else k, rows)
        if self._world > 1:
            dist.broadcast(x, src=0)
            if y is not None:
                dist.broadcast(y, src=0)
        out = self._denoise(x, y, k).numpy()
        elapsed = time.monotonic() - t0

        with self._cond:
            if not warmup:
                self._stats["batches"] += 1
                self._stats["samples"] += rows
                self._stats["padded_rows"] += pad
                self._stats["sample_seconds"] += elapsed
            self._warm = True

        off = 0
        for r in batch:
            r.future.set_result(out[off:off + r.n])
            off += r.n
