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
    dpm++) in float32 its output does not depend on its batch, bit for bit;
    in bfloat16 cuDNN's convs can move a row by an ulp with its batch mates,
    and a chain carries that on (ROADMAP, "bf16 serving is not
    batch-position independent"). Step noise (DDPM) comes
    from a device generator seeded from (rng_seed, k) for the k-th served
    batch, the counterpart of ``jax.random.fold_in(rng, k)``.
  * Serving modes are fixed at construction: the model's dtype (and a frozen
    int8 model), encoder_cache, guidance_interval.

Threading: `submit()` is thread-safe and returns a
`concurrent.futures.Future`; all device work, `warmup()` included, runs on
the single worker thread. Grad mode, inference mode and the current stream
are per thread in torch, and the first chain builds the kernels (nvcc), so
that work too stays on the worker.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["ServingConfig", "SamplerService"]


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
    """

    def __init__(self, diffusion, config: ServingConfig | None = None, device=None):
        self.diffusion = diffusion
        self.config = config or ServingConfig()
        if self.config.serve_batch < 1:
            raise ValueError("serve_batch must be >= 1")
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

        self._worker = threading.Thread(target=self._run, name="sampler-service", daemon=True)
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
        in `stats()`.
        """
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
        """Stop the worker; outstanding requests are failed."""
        with self._cond:
            self._closed = True
            pending, self._queue = self._queue, []
            self._cond.notify_all()
        for req in pending:
            req.future.set_exception(RuntimeError("service closed"))
        self._worker.join(timeout=30)

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
        that does not fit the remaining space waits for the next batch)."""
        cap = self.config.serve_batch
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained
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
            batch, rows = [], 0
            while self._queue and rows + self._queue[0].n <= cap:
                req = self._queue.pop(0)
                batch.append(req)
                rows += req.n
            return batch

    def _run(self):
        while True:
            batch = self._collect()
            if not batch:
                # None: closed and drained. Empty list: close() raced the
                # linger wait and failed the queued requests; do not run a
                # chain of pure padding, just exit.
                return
            try:
                self._serve_batch(batch)
            except Exception as e:  # a CUDA or kernel error fails this batch's callers
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

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

        if warmup:
            generator = self._step_generator(None)
        else:
            generator = self._step_generator(self._batch_counter)
            self._batch_counter += 1

        cfg = self.config
        t0 = time.monotonic()
        x = x.to(self.device)
        y = y.to(self.device) if y is not None else None
        out = self.diffusion.denoise(
            generator, x=x, y=y, batch_size=cap, encoder_cache=cfg.encoder_cache,
            guidance_interval=cfg.guidance_interval,
        )
        out = out.float().cpu().numpy()  # the batch's one host sync
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
