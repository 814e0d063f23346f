"""Rank functions of the data-parallel CPU tests (torch and the port only).

Each runs inside a process that ``nicediffusion_tpu_torch.parallel.dryrun.
spawn_ranks`` started and joined to a gloo group; it reads the weights and
draws the test wrote into ``work`` and writes what the test holds there
(``.pt`` files), returning small JSON values. No JAX here: the tests hold
these results against JAX and optax in their own process.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from nicediffusion_tpu_torch import Diffusion, DiffusionModel, Trainer
from nicediffusion_tpu_torch.parallel import gather_rows, rank, shard_rows, world

TINY_MODEL = dict(
    resolution=8, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
    num_heads=2, num_classes=4, dropout=0.0, resblock_updown=True,
    use_adaptive_gn=True, split_qkv_first=True,
)
DIFF_ARGS = dict(
    original_num_steps=100, rescaled_num_steps=100,
    sampling_var_type="learned_interpolation", loss_type="hybrid",
    beta_schedule="cosine", guidance_method="classifier_free", guidance_strength=0.8,
)
LR, WD, EMA = 2e-3, 1e-2, 0.9
# (sampler, encoder_cache) of the sharded-sampling cases, tests/test_distributed.py's
SAMPLING_CASES = (("ddim", None), ("ddpm", None), ("dpm++", None), ("ddpm", 2), ("dpm++", 3))


def draws(seed, b=8):
    """A global batch and its injected draws, from numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        batch=rng.uniform(-1, 1, size=(b, 8, 8, 1)).astype(np.float32),
        labels=rng.integers(1, 4, size=(b,)),
        t=rng.integers(0, 100, size=(b,)),
        noise=rng.normal(size=(b, 8, 8, 1)).astype(np.float32),
        drop=rng.random(b) < 0.25,
    )


def local(d, r, n):
    """Rank r's rows of every draw."""
    return {k: shard_rows(torch.from_numpy(np.asarray(v)), r, n) for k, v in d.items()}


def model_from(path):
    model = DiffusionModel(**TINY_MODEL, device="cpu")
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    return model


def make_trainer(path, distributed, **kw):
    return Trainer(model_from(path), dict(DIFF_ARGS), iter(()), iterations=0, batch_size=8,
                   lr=LR, weight_decay=WD, ema_rate=EMA, seed=0, device="cpu",
                   distributed=distributed, **kw)


def state_of(trainer):
    """{name: tensor} of the model, the EMA and AdamW's state (copies)."""
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in trainer.ema_model.state_dict().items()})
    for i, st in trainer.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return {k: v.clone() for k, v in out.items()}


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode() + tensors[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def recording(trainer):
    """Make ``trainer`` keep each micro-step's gradients as its update sees
    them (after the reduce over the ranks), by parameter name."""
    names = [n for n, _ in trainer.model.named_parameters()]
    trainer.grads = []
    reduce = trainer._reduce

    def record(grads, loss):
        grads, loss = reduce(grads, loss)
        trainer.grads.append({n: g.detach().clone() for n, g in zip(names, grads)})
        return grads, loss

    trainer._reduce = record
    return trainer


def training(work, weights):
    """Two micro-steps on draws split by rank, with k = 1 (two updates) and
    k = 2 (one update, of the mean of both), and on rank 0 the same on one
    process over the global batch: each step's metrics and gradients, the
    state after the first update and at the end; and the gathered rows of a
    known tensor."""
    r, n = rank(), world()
    out = {"gathered": gather_rows(torch.arange(8.0).reshape(8, 1)[r * 4:(r + 1) * 4])}
    for k in (1, 2):
        runs = {"dp": recording(make_trainer(weights, True, grad_accumulation=k))}
        if r == 0:
            runs["one"] = recording(make_trainer(weights, False, grad_accumulation=k))
        for i, seed in enumerate((1, 2)):
            d = draws(seed)
            for name, trainer in runs.items():
                m = trainer.train_step(**(local(d, r, n) if name == "dp" else d))
                out[f"k{k}.{name}.{i}"] = {key: v.item() for key, v in m.items()}
                if i == k - 1:
                    out[f"k{k}.{name}.first_update"] = state_of(trainer)
        for name, trainer in runs.items():
            out[f"k{k}.{name}.state"] = state_of(trainer)
            out[f"k{k}.{name}.grads"] = trainer.grads
    # in-training sampling from fresh trainers: sharded, gathered to rank 0
    runs = {"dp": make_trainer(weights, True)}
    if r == 0:
        runs["one"] = make_trainer(weights, False)
    for name, trainer in runs.items():
        images = trainer.sample(4)
        out[f"sample.{name}"] = (images, trainer.generator.get_state())
    torch.save(out, os.path.join(work, f"training{r}.pt"))
    return r


def sampling_inputs():
    """The sampling cases' global x_T and labels."""
    rng = np.random.default_rng(2)
    return torch.from_numpy(rng.normal(size=(8, 8, 8, 1)).astype(np.float32)), torch.arange(8) % 4


def sampling(work, weights):
    """Every SAMPLING_CASES chain with the batch's rows over the ranks,
    gathered, and on rank 0 unsharded."""
    r, n = rank(), world()
    model = model_from(weights).eval()
    x, y = sampling_inputs()
    out = {}
    for sampler, enc in SAMPLING_CASES:
        diff = Diffusion(model=model, **dict(DIFF_ARGS, rescaled_num_steps=8), sampler=sampler)
        sharded = diff.denoise(torch.Generator().manual_seed(1), x=shard_rows(x, r, n),
                               y=shard_rows(y, r, n), encoder_cache=enc, row_shard=(r, n))
        # and from noise the chain draws itself (batch_size is the global batch)
        drawn = diff.denoise(torch.Generator().manual_seed(3), y=shard_rows(y, r, n),
                             batch_size=8, encoder_cache=enc, row_shard=(r, n))
        sharded, drawn = gather_rows(sharded), gather_rows(drawn)
        if r == 0:
            out[f"{sampler}.{enc}"] = (
                sharded, diff.denoise(torch.Generator().manual_seed(1), x=x, y=y,
                                      encoder_cache=enc),
                drawn, diff.denoise(torch.Generator().manual_seed(3), y=y, batch_size=8,
                                    encoder_cache=enc))
    if r == 0:
        torch.save(out, os.path.join(work, "sampling.pt"))
    return r


def sample_cli(argv):
    """The sampling entry point with --data_parallel on every rank."""
    from nicediffusion_tpu_torch.scripts.sample import main

    return len(main(argv))


def train_cli(argv):
    """The train entry point on every rank: the digest of the state it ends
    with, its step and the rows its loader yields."""
    from nicediffusion_tpu_torch.scripts.train import main

    trainer = main(argv)
    return {"digest": digest(state_of(trainer)), "step": trainer.step,
            "rows": int(next(trainer.loader)[0].shape[0]), "distributed": trainer.distributed}


def checkpoint_round_trip(work, weights):
    """Two DP steps, ``save(2)``, then a fresh Trainer resuming "auto": the
    state's digest before and after, and the torch.save calls of each rank."""
    r, n = rank(), world()
    saves = []
    real_save = torch.save

    def counting_save(*args, **kw):
        saves.append(args[1])
        return real_save(*args, **kw)

    ckpt = os.path.join(work, "ckpt")
    trainer = make_trainer(weights, True, checkpoint_dir=ckpt)
    for seed in (1, 2):
        trainer.train_step(**local(draws(seed), r, n))
    before = digest(state_of(trainer))
    torch.save = counting_save
    try:
        trainer.save(2)
    finally:
        torch.save = real_save
    resumed = make_trainer(weights, True, checkpoint_dir=ckpt, resume_step="auto")
    after, step = digest(state_of(resumed)), resumed.step
    m = resumed.train_step(**local(draws(3), r, n))  # and the restored state trains on
    return {"before": before, "after": after, "step": step, "saves": len(saves),
            "loss": m["loss"].item()}


def serving(work, weights, serve_batch=8, keepalive_s=None, int8_argv=None):
    """A data-parallel service over the tiny DDIM-4 chain (or, with
    ``int8_argv``, the serving entry point's): rank 0 serves a request of
    serve_batch labels after an idle wait, then closes; the other ranks
    follow() until the stop header. Rank 0 saves the images."""
    from nicediffusion_tpu_torch.serving import service as service_mod

    if keepalive_s is not None:
        service_mod.KEEPALIVE_S = keepalive_s
    if int8_argv is not None:
        from nicediffusion_tpu_torch.scripts.serve import build_service

        svc, _ = build_service(int8_argv)
    else:
        svc = tiny_service(weights, serve_batch)
    if rank():
        svc.follow()
        return {"followed": True, "closed": svc._closed}
    if keepalive_s is not None:
        import time

        time.sleep(5 * keepalive_s)  # the followers see idle headers meanwhile
    cap = svc.config.serve_batch
    labels = SERVE_LABELS[:cap] if svc._conditional else None
    with svc:
        images = svc.sample(labels=labels, n=cap, seed=11, timeout=120)
        stats = svc.stats()
    torch.save(torch.from_numpy(images), os.path.join(work, "served.pt"))
    return {"padded_rows": stats["padded_rows"], "batches": stats["batches"]}


def tiny_service(weights, serve_batch=8):
    """A data-parallel service over the tiny DDIM-4 chain."""
    from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig

    model = DiffusionModel(**SERVE_MODEL, device="cpu").eval()
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return SamplerService(Diffusion(model=model, **SERVE_DIFF),
                          ServingConfig(serve_batch=serve_batch, linger_ms=100.0),
                          device="cpu", distributed=True)


def serving_with_a_failure(work, weights, fail_rank):
    """The tiny data-parallel service whose chain raises once, on rank
    ``fail_rank``, in the first served batch: rank 0 serves that request
    (which must fail) and then a second one (which must be served), then
    closes. Rank 0 saves the second request's images and returns the first
    one's error and the batches served; the others what follow() saw."""
    svc = tiny_service(weights)
    if rank() == fail_rank:
        denoise, calls = svc.diffusion.denoise, []

        def failing_once(*args, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError(f"injected on rank {rank()}")
            return denoise(*args, **kw)

        svc.diffusion.denoise = failing_once
    if rank():
        svc.follow()
        return {"followed": True, "closed": svc._closed, "warm": svc._warm}
    with svc:
        try:
            svc.sample(labels=SERVE_LABELS, seed=5, timeout=120)
            error = None
        except RuntimeError as e:
            error = str(e)
        images = svc.sample(labels=SERVE_LABELS, seed=11, timeout=120)
        stats = svc.stats()
    torch.save(torch.from_numpy(images), os.path.join(work, "served.pt"))
    return {"error": error, "batches": stats["batches"]}


# tests/test_serving.py's mesh case: 8x8, no attention, DDIM eta 0, 4 steps
SERVE_MODEL = dict(
    resolution=8, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
    num_heads=2, num_classes=5, dropout=0.0,
    resblock_updown=False, use_adaptive_gn=False, split_qkv_first=True,
)
SERVE_DIFF = dict(
    original_num_steps=40, rescaled_num_steps=4, sampling_var_type="learned_interpolation",
    loss_type="hybrid", beta_schedule="linear", sampler="ddim", ddim_eta=0.0, use_ddim=True,
)
SERVE_LABELS = list(range(5)) + [0, 1, 2]  # fills serve_batch=8 exactly
