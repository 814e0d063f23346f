"""Multi-process dry run over several CPU processes, and the launcher it uses.

:func:`dryrun_multigpu` is the port's counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``: it starts ``n`` processes on the
CPU, joined by gloo through a ``file://`` rendezvous, and prints the lines
that dry run prints: one data-parallel training step, the data-parallel
sampling chain and the sharded serving daemon, each held to the same work
done by one process; then, for an even ``n`` of at least 4 (as in the JAX
dry run), on a mesh of dp = n/2 x tp = 2 (tensor parallelism over a model
axis of two), a forward held to one process and one training step with
the sharding of the ``in_conv`` weight, its EMA and its AdamW moments
asserted.

:func:`spawn_ranks` starts the processes: each runs
``python -m nicediffusion_tpu_torch.parallel.dryrun``, which joins the group
through ``maybe_initialize_distributed`` (torchrun's environment variables,
set here) and calls ``module:function(**kwargs)``. The launcher waits under
one timeout, kills every process when one fails or the time is up, and
raises with their output; a hung collective fails the run, it does not hang
the caller.

    python -c "from nicediffusion_tpu_torch.parallel.dryrun import dryrun_multigpu; dryrun_multigpu(2)"
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

__all__ = ["spawn_ranks", "dryrun_multigpu"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_RESULT = "RANK_RESULT "


def spawn_ranks(target: str, world: int, kwargs: dict | None = None, *,
                timeout_s: float = 120.0, one_device: bool = False,
                pythonpath: tuple[str, ...] = (), env: dict | None = None) -> list:
    """Run ``target`` (``"module:function"``) in ``world`` new processes,
    each a rank of one gloo group (rendezvous through a file in a temporary
    directory), with ``kwargs`` (JSON). ``one_device`` gives every
    rank ``LOCAL_RANK=0``: several ranks on one card (gloo only). Returns
    each rank's return value (JSON), in rank order. Raises RuntimeError,
    with every rank's output, when a rank exits non-zero or when the
    ranks have not all ended after ``timeout_s``; every process is ended
    either way."""
    with tempfile.TemporaryDirectory() as tmp:
        base = dict(os.environ if env is None else env)
        base["PYTHONPATH"] = os.pathsep.join(
            [_REPO, *pythonpath, *filter(None, [base.get("PYTHONPATH")])])
        base["WORLD_SIZE"] = str(world)
        base.setdefault("OMP_NUM_THREADS", "2")  # ranks share the host's cores
        procs, logs, timed_out = [], [], False
        try:
            for r in range(world):
                child = dict(base, RANK=str(r), LOCAL_RANK="0" if one_device else str(r))
                logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nicediffusion_tpu_torch.parallel.dryrun",
                     "--target", target, "--kwargs", json.dumps(kwargs or {}),
                     "--init", f"file://{tmp}/rendezvous"],
                    env=child, cwd=_REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                timed_out = time.monotonic() > deadline
                if timed_out or any(p.returncode for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        why = f"timed out after {timeout_s} s" if timed_out else "failed"
        raise RuntimeError(
            f"{target} on {world} ranks {why}, exit codes {rcs}:\n"
            + "\n".join(f"--- rank {r} ---\n{out[-4000:]}" for r, out in enumerate(outs)))
    results = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(_RESULT)]
        if not lines:
            raise RuntimeError(f"rank {r} of {target} returned nothing:\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len(_RESULT):]))
    return results


# ---------------------------------------------------------------------------
# the dry run: the JAX dry run's tiny UNet and schedule
# ---------------------------------------------------------------------------

TINY_MODEL = dict(
    resolution=8, in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2, num_classes=4,
    dropout=0.0, resblock_updown=True, use_adaptive_gn=True, split_qkv_first=True,
)
DIFF_ARGS = dict(
    original_num_steps=50, rescaled_num_steps=50, sampling_var_type="learned_interpolation",
    loss_type="hybrid", beta_schedule="cosine", guidance_method="classifier_free",
    guidance_strength=0.8,
)


def _tiny_model():
    import torch

    from ..models.unet import DiffusionModel

    torch.manual_seed(0)  # the module initialisers draw from the global RNG
    return DiffusionModel(**TINY_MODEL, device="cpu")


def _randomized(model, seed: int):
    """``model`` with every parameter drawn from a generator seeded by
    ``seed`` (fan-in scaled; the zero-initialised output convs too, so a
    forward has something to compare)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            fan = p[0].numel() if p.ndim > 1 else 25
            p.copy_(torch.randn(p.shape, generator=g) / fan ** 0.5)
    return model


def _max_diff(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _dryrun_rank() -> list[str]:
    """One rank of :func:`dryrun_multigpu`; rank 0 returns the lines."""
    import numpy as np
    import torch

    from ..diffusion.process import Diffusion
    from ..serving import SamplerService, ServingConfig
    from ..training.trainer import Trainer
    from .mesh import gather_rows, rank, shard_rows, world

    r, n = rank(), world()
    lines = []

    # one data-parallel training step against one process on the global batch
    batch = 2 * n
    g = np.random.default_rng(7)
    draws = dict(batch=g.uniform(-1, 1, (batch, 8, 8, 1)).astype(np.float32),
                 labels=g.integers(1, 4, batch), t=g.integers(0, 50, batch),
                 noise=g.normal(size=(batch, 8, 8, 1)).astype(np.float32),
                 drop=np.zeros(batch, bool))

    def trainer(distributed):
        return Trainer(_tiny_model(), DIFF_ARGS, iter(()), iterations=0, batch_size=batch,
                       lr=1e-3, weight_decay=1e-4, device="cpu", distributed=distributed)

    dp = trainer(True)
    m = dp.train_step(**{k: shard_rows(torch.from_numpy(np.asarray(v)), r, n)
                         for k, v in draws.items()})
    if r == 0:
        one = trainer(False)
        m1 = one.train_step(**draws)
        dloss = abs(m["loss"].item() - m1["loss"].item())
        dparam = _max_diff(dp.model.parameters(), one.model.parameters())
        if not (np.isfinite(m["loss"].item()) and dloss <= 1e-5 * abs(m1["loss"].item())
                and dparam <= 1e-5):
            raise AssertionError(f"DP step: loss {dloss}, parameters {dparam} off one process")
        lines.append(f"dryrun_multigpu({n}): one DP train step OK, loss={m['loss'].item():.4f} "
                     f"(one process: {m1['loss'].item():.4f}; parameters within {dparam:.1e})")

    # the DDPM chain with the batch's rows over the ranks
    diffusion = Diffusion(model=dp.ema_model, **dict(DIFF_ARGS, rescaled_num_steps=4))
    y = torch.arange(batch) % 4
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(batch, 8, 8, 1))
                         .astype(np.float32))
    out = diffusion.denoise(torch.Generator().manual_seed(12), x=shard_rows(x, r, n),
                            y=shard_rows(y, r, n), row_shard=(r, n))
    out = gather_rows(out)
    if r == 0:
        ref = diffusion.denoise(torch.Generator().manual_seed(12), x=x, y=y)
        err = (out - ref).abs().max().item()
        if out.shape != (batch, 8, 8, 1) or not torch.isfinite(out).all() or err > 1e-5:
            raise AssertionError(f"DP sampling: {tuple(out.shape)}, max abs {err} off one process")
        lines.append(f"dryrun_multigpu({n}): DP sampling chain OK (batch {batch} sharded over "
                     f"{n} processes, DDPM-4 within {err:.1e} of one process)")

    # the sharded serving daemon against a one-process service
    serve_diff = Diffusion(model=dp.ema_model, **dict(
        DIFF_ARGS, rescaled_num_steps=3, use_ddim=True, ddim_eta=0.0))
    cfg = ServingConfig(serve_batch=n, linger_ms=20.0)
    svc = SamplerService(serve_diff, cfg, device="cpu", distributed=True)
    if r:
        svc.follow()
    else:
        labels = [i % 4 for i in range(n)]
        with svc:
            images = svc.sample(labels=labels, seed=0, timeout=600)
        with SamplerService(serve_diff, cfg, device="cpu") as alone:
            ref = alone.sample(labels=labels, seed=0, timeout=600)
        err = float(abs(images - ref).max())
        if images.shape != (n, 8, 8, 1) or not np.isfinite(images).all() or err > 1e-5:
            raise AssertionError(f"sharded daemon: {images.shape}, max abs {err} off one process")
        lines.append(f"dryrun_multigpu({n}): sharded serving daemon OK (serve batch {n} over "
                     f"{n} processes, within {err:.1e} of one process)")
    if n >= 4 and n % 2 == 0:  # as the JAX dry run
        lines += _tensor_parallel_lines(r, n, draws, trainer)
    return lines


def _tensor_parallel_lines(r, n, draws, one_process) -> list[str]:
    """The dp = n/2 x tp = 2 forward and training step of the dry run."""
    import numpy as np
    import torch

    from ..training.trainer import Trainer
    from .mesh import make_mesh, shard_rows

    mesh = make_mesh(n // 2, 2)
    d, nd = mesh.data_rank, mesh.num_data
    lines = []
    model = _randomized(_tiny_model(), 3).eval()
    whole = _randomized(_tiny_model(), 3).eval()
    model.shard_(mesh)
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.normal(size=(n, 8, 8, 1)).astype(np.float32))
    t, y = torch.arange(n) * 7 % 50, torch.arange(n) % 4
    rows = [shard_rows(v, d, nd) for v in (x, t, y)]
    with torch.no_grad():
        out, ref = model(*rows), whole(*rows)
    err = (out - ref).abs().max().item()
    if not (torch.isfinite(out).all() and err <= 1e-5):
        raise AssertionError(f"dp x tp forward: max abs {err} off one process")
    if r == 0:
        lines.append(f"dryrun_multigpu({n}): dp={nd} x tp=2 forward OK (within {err:.1e} of "
                     f"one process)")

    tp = Trainer(_tiny_model(), DIFF_ARGS, iter(()), iterations=0, batch_size=len(draws["t"]),
                 lr=1e-3, weight_decay=1e-4, device="cpu", mesh=mesh)
    m = tp.train_step(**{k: shard_rows(torch.from_numpy(np.asarray(v)), d, nd)
                         for k, v in draws.items()})
    name = "downsampling.1.0.in_conv.weight"
    full = dict(whole.named_parameters())[name].shape
    shard = (full[0] // 2, *full[1:])
    ema = dict(tp.ema_model.named_parameters())[name]
    param = dict(tp.model.named_parameters())[name]
    moments = tp.optimizer.state[param]
    got = [tuple(t.shape) for t in (param, ema, moments["exp_avg"], moments["exp_avg_sq"])]
    if got != [shard] * 4:
        raise AssertionError(f"dp x tp step: {name} of shapes {got}, its shard is {shard}")
    if r == 0:
        m1 = one_process(False).train_step(**draws)
        dloss = abs(m["loss"].item() - m1["loss"].item())
        if not (np.isfinite(m["loss"].item()) and dloss <= 1e-5 * abs(m1["loss"].item())):
            raise AssertionError(f"dp x tp step: loss {dloss} off one process")
        lines.append(f"dryrun_multigpu({n}): dp={nd} x tp=2 TRAIN step OK, "
                     f"loss={m['loss'].item():.4f} ({name}, its EMA and AdamW moments sharded "
                     f"{tuple(full)} -> {shard})")
    return lines


def dryrun_multigpu(n: int = 2, timeout_s: float = 300.0) -> list[str]:
    """Run the dry run on ``n`` CPU processes and print its lines, three
    data-parallel ones and, for an even ``n`` of at least 4, two
    tensor-parallel ones (see the module docstring); returns them. Raises
    if a rank fails, disagrees with one process or outlasts ``timeout_s``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # the CPU, whatever the machine has
    lines = spawn_ranks(f"{__name__}:_dryrun_rank", n, timeout_s=timeout_s, env=env)[0]
    for line in lines:
        print(line)
    return lines


def _child(argv: list[str] | None = None) -> None:
    """A rank started by :func:`spawn_ranks`."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--target", required=True)
    parser.add_argument("--kwargs", default="{}")
    parser.add_argument("--init", required=True)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from .multihost import maybe_initialize_distributed

    if not maybe_initialize_distributed("gloo", init_method=args.init):
        raise RuntimeError("no WORLD_SIZE in the environment: start ranks with spawn_ranks")
    module, name = args.target.split(":")
    try:
        result = getattr(importlib.import_module(module), name)(**json.loads(args.kwargs))
    finally:
        dist.destroy_process_group()
    print(_RESULT + json.dumps(result), flush=True)


if __name__ == "__main__":
    _child()
