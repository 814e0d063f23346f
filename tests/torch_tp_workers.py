"""Rank functions of the tensor-parallel CPU tests (torch and the port only).

Each runs inside a process that ``nicediffusion_tpu_torch.parallel.dryrun.
spawn_ranks`` started and joined to a gloo group; it reads the weights the
test wrote into ``work`` and writes what the test holds there (``.pt``
files), returning small JSON values. No JAX here: the tests hold these
results against JAX in their own process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nicediffusion_tpu_torch import Trainer
from nicediffusion_tpu_torch.models.unet import AttentionBlock, ResidualBlock, shard_module_
from nicediffusion_tpu_torch.parallel import gather_rows, rank, shard_rows
from nicediffusion_tpu_torch.parallel.mesh import make_mesh
from nicediffusion_tpu_torch.parallel.sharding import gather_params, gather_tensor
from nicediffusion_tpu_torch.parallel.tensor import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
    stats,
)
from torch_dp_workers import DIFF_ARGS, EMA, LR, TINY_MODEL, WD, digest, draws, local, model_from


def inputs(batch=4, seed=1):
    """The forward's x, t, y, from numpy (the test makes the same)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 1)).astype(np.float32)
    t = rng.integers(0, 1000, size=(batch,))
    y = rng.integers(0, TINY_MODEL["num_classes"], size=(batch,))
    return torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long()


def _counts():
    return {f"{kind}.{phase}": n for (kind, phase), n in stats.counts.items()}


def collectives(mesh):
    """The four helpers' values and gradients on small tensors, and the
    collectives a paired ResidualBlock and an AttentionBlock issue in a
    forward and in a backward."""
    g = torch.Generator().manual_seed(4)
    out = {}
    x = torch.randn(3, 4, generator=g).requires_grad_(True)  # the same on every rank
    w = torch.randn(3, 4, generator=g)
    y = gather_from_model(scatter_to_model(x, mesh), mesh)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    out["scatter_gather"] = (y.detach(), gx)  # x and w: no factor of the group's size
    # a column-parallel then row-parallel product: x @ A @ B with A on its
    # columns, B on its rows, one all-reduce
    a, b = torch.randn(4, 6, generator=g), torch.randn(6, 5, generator=g)
    n = 6 // mesh.num_model
    cols = slice(mesh.model_rank * n, (mesh.model_rank + 1) * n)
    a_l = a[:, cols].clone().requires_grad_(True)
    b_l = b[cols].clone().requires_grad_(True)
    z = reduce_from_model(copy_to_model(x, mesh) @ a_l @ b_l, mesh)
    gx, ga, gb = torch.autograd.grad((z * z).sum(), (x, a_l, b_l))
    out["pair"] = (z.detach(), gx, gather_tensor(ga, 1, mesh), gather_tensor(gb, 0, mesh))

    torch.manual_seed(5)
    blocks = {"residual": ResidualBlock(64, 64, 32, use_adaptive_gn=True, device="cpu"),
              "attention": AttentionBlock(64, num_heads=2, device="cpu")}
    xb = torch.randn(2, 4, 4, 64, generator=g)
    emb = torch.randn(2, 32, generator=g)
    for name, block in blocks.items():
        for p in block.parameters():  # non-zero everywhere, the same on every rank
            p.data = torch.randn(p.shape, generator=g) * 0.2
        whole = {k: v.clone() for k, v in block.state_dict().items()}
        shard_module_(block, mesh)
        args = (xb, emb) if name == "residual" else (xb,)
        stats.reset()
        h = block(*args)
        out[f"{name}.forward"] = _counts()
        stats.reset()
        grads = torch.autograd.grad(h.square().sum(), list(block.parameters()))
        out[f"{name}.backward"] = _counts()
        out[f"{name}.out"] = h.detach()
        out[f"{name}.whole"] = whole
        out[f"{name}.grads"] = gather_params(
            {k: gr for (k, _), gr in zip(block.named_parameters(), grads)}, mesh, block.tp_dims)
    return out


def tp2(work, weights):
    """On a mesh of 1 x 2: the collectives' checks, the tiny UNet's forward
    (sharded weights, the whole batch on both ranks) and the gathered
    gradients of mean(out^2); rank 0 writes them, each rank the digest of
    its replicated gradients."""
    mesh = make_mesh(1, 2)
    out = {"collectives": collectives(mesh)}
    model = shard_module_(model_from(weights).eval(), mesh)
    x, t, y = inputs()
    with torch.no_grad():
        out["forward"] = model(x, t, y)
    params = dict(model.named_parameters())
    loss = model(x, t, y).square().mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    out["grads"] = gather_params(grads, mesh, model.tp_dims)
    out["dims"] = model.tp_dims
    # the trainer's reduce: rank-dependent gradients, the replicated ones averaged
    tr = Trainer(model_from(weights), dict(DIFF_ARGS), iter(()), iterations=0, batch_size=8,
                 lr=LR, weight_decay=WD, device="cpu", mesh=mesh)
    fake = [torch.full(p.shape, float(rank() + 1)) for p in tr._params]
    reduced, _ = tr._reduce(fake, torch.zeros(()))
    out["reduce"] = {n: (tr._dims[n], g.unique().tolist()) for n, g in zip(tr._names, reduced)}
    torch.save(out, os.path.join(work, f"tp2.{rank()}.pt"))
    return digest({k: g for k, g in grads.items() if model.tp_dims[k] is None})


def _gathered(trainer):
    """The whole model, EMA and AdamW state of a trainer, by name."""
    full = trainer._state()
    if trainer.tp is not None:
        full = trainer._each_tensor(full, lambda t, d: gather_tensor(t, d, trainer.tp))
    names = trainer._names
    out = {f"model.{k}": v for k, v in full["model"].items()}
    out.update({f"ema.{k}": v for k, v in full["ema"].items()})
    for i, st in full["optimizer"]["state"].items():
        out.update({f"opt.{names[i]}.{k}": v for k, v in st.items() if k != "step"})
    return {k: v.detach().clone() for k, v in out.items()}  # not the live state


def _local_shapes(trainer):
    shapes = {f"model.{k}": tuple(v.shape) for k, v in trainer.model.named_parameters()}
    shapes.update({f"ema.{k}": tuple(v.shape) for k, v in trainer.ema_model.named_parameters()})
    for i, st in trainer.optimizer.state_dict()["state"].items():
        shapes.update({f"opt.{trainer._names[i]}.{k}": tuple(v.shape) for k, v in st.items()
                       if k != "step"})
    return shapes


def _replicated(trainer):
    """Digest of every replicated tensor of the state (model, EMA, moments)."""
    dims = trainer._dims
    rep = {f"model.{k}": v.detach() for k, v in trainer.model.named_parameters()
           if dims[k] is None}
    rep.update({f"ema.{k}": v for k, v in trainer.ema_model.named_parameters() if dims[k] is None})
    for i, st in trainer.optimizer.state_dict()["state"].items():
        if dims[trainer._names[i]] is None:
            rep.update({f"opt.{i}.{k}": v for k, v in st.items() if k != "step"})
    return digest({k: v.detach().clone() for k, v in rep.items()})


def recording(trainer):
    """Keep each micro-step's gradients as the update sees them (after the
    data-group reduce), gathered whole, by name."""
    reduce, trainer.grads = trainer._reduce, []

    def record(grads, loss):
        grads, loss = reduce(grads, loss)
        trainer.grads.append({n: gather_tensor(gr.detach().clone(), trainer._dims.get(n),
                                               trainer.tp) if trainer.tp else gr.detach().clone()
                              for n, gr in zip(trainer._names, grads)})
        return grads, loss

    trainer._reduce = record
    return trainer


def dp2tp2(work, weights):
    """On four ranks: the tiny UNet's forward on a mesh of 2 x 2 (rows by the
    data coordinate, gathered to rank 0); one Trainer step on that mesh and
    the same step on the four-rank data-parallel mesh (4 x 1), each on the
    global batch's rows of its data coordinate; then the TP trainer's
    checkpoint: saved whole, restored into a fresh TP trainer, and a whole
    one-process checkpoint restored into TP shards."""
    r = rank()
    mesh = make_mesh(2, 2)
    d, nd = mesh.data_rank, mesh.num_data
    out = {}
    model = shard_module_(model_from(weights).eval(), mesh)
    x, t, y = inputs()
    with torch.no_grad():
        h = model(*(shard_rows(v, d, nd) for v in (x, t, y)))
    if mesh.model_rank == 0:
        h = gather_rows(h, group=mesh.data_group)
    out["forward"] = h

    def trainer(**kw):
        return Trainer(model_from(weights), dict(DIFF_ARGS), iter(()), iterations=0,
                       batch_size=8, lr=LR, weight_decay=WD, ema_rate=EMA, seed=0,
                       device="cpu", checkpoint_dir=os.path.join(work, "ckpt"), **kw)

    tp = recording(trainer(mesh=mesh))
    dp = recording(trainer(distributed=True))
    batch = draws(1)
    m_tp = tp.train_step(**local(batch, d, nd))
    m_dp = dp.train_step(**local(batch, r, 4))
    out["tp.metrics"] = {k: v.item() for k, v in m_tp.items()}
    out["dp.metrics"] = {k: v.item() for k, v in m_dp.items()}
    out["tp.state"], out["dp.state"] = _gathered(tp), _gathered(dp)
    out["tp.grads"], out["dp.grads"] = tp.grads[0], dp.grads[0]
    out["tp.shapes"], out["dims"] = _local_shapes(tp), tp._dims
    out["tp.replicated"] = _replicated(tp)

    # the checkpoint: TP -> a whole file -> a fresh TP trainer
    before = digest({k: v.detach().clone() for k, v in
                     {**{f"m.{k}": v for k, v in tp.model.state_dict().items()},
                      **{f"e.{k}": v for k, v in tp.ema_model.state_dict().items()}}.items()})
    tp.save(1)
    resumed = trainer(mesh=mesh, resume_step=1)
    after = digest({k: v.detach().clone() for k, v in
                    {**{f"m.{k}": v for k, v in resumed.model.state_dict().items()},
                     **{f"e.{k}": v for k, v in resumed.ema_model.state_dict().items()}}.items()})
    out["ckpt.round_trip"] = (before == after, resumed.step)
    m_next = [tr.train_step(**local(draws(2), d, nd))["loss"].item() for tr in (tp, resumed)]
    out["ckpt.next_losses"] = m_next
    # a one-process checkpoint (the DP trainer's, every rank the same) into TP shards
    dp.checkpoint_dir = os.path.join(work, "ckpt_dp")
    dp.save(1)
    from_one = trainer(mesh=mesh)
    from_one.checkpoint_dir = dp.checkpoint_dir
    from_one.restore(1)
    out["ckpt.from_one"] = {k: torch.equal(a, b) for k, (a, b) in
                            _zip(_gathered(from_one), _gathered(dp)).items()}
    torch.save(out, os.path.join(work, f"dp2tp2.{r}.pt"))
    return {"model_rank": mesh.model_rank, "data_rank": d, "replicated": out["tp.replicated"],
            "loss": out["tp.metrics"]["loss"]}


def _zip(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    return {k: (a[k], b[k]) for k in a}


def sample_tp(work, weights):
    """``Trainer.sample`` on a mesh of 1 x 2 against a one-process trainer."""
    mesh = make_mesh(1, 2)
    tr = Trainer(model_from(weights), dict(DIFF_ARGS, rescaled_num_steps=4), iter(()),
                 iterations=0, batch_size=4, lr=LR, weight_decay=WD, device="cpu", mesh=mesh)
    images = tr.sample(2)
    if rank() == 0:
        one = Trainer(model_from(weights), dict(DIFF_ARGS, rescaled_num_steps=4), iter(()),
                      iterations=0, batch_size=4, lr=LR, weight_decay=WD, device="cpu")
        torch.save({"tp": images, "one": one.sample(2)}, os.path.join(work, "sample.pt"))
    return images is None

