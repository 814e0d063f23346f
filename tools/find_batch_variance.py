"""Which operation of a bf16 forward moves a row with its batch, on one NVIDIA card.

    python tools/find_batch_variance.py [--seed 0] [--preset openai_64] [--json out.json]

Builds a bf16 ``DiffusionModel(**MODEL_PRESETS[preset])`` (with CFG's null
class) from seeded random weights on the card and hooks every leaf module
(each Conv2d and Linear, the GroupNormOps (K3), the class embedding and the
SiLU) and the attention (K1: the model's ``qkv_attention``). One forward of
a target row (x, t, y) runs four times, under inference mode as sampling
runs it:

  * (a) row 0 of a batch of 16 whose other rows are zeros with label 0, as
    the serving daemon pads a request served alone;
  * (b) row 7, then row 15, of a batch of 16 real rows;
  * (c) row 3 of a batch of 8 real rows: the per-rank shape of a
    data-parallel rank at serve batch 16.

For each call whose target output row is not bit-equal across the runs, in
the order of the forward, it prints which runs moved it and whether its
input row had moved already, and names the first call that moves, with its
op, shapes and max abs. Then every call is replayed alone: each other run's
call again, its batch mates as they were, the target's rows of its
arguments replaced by run (a)'s. A call whose target output row then differs
from (a)'s is an operation at fault, whatever moved upstream; the tool
prints their count and ops. A second pass runs the same weights with
``kernels=False`` (the plain versions: cuDNN and cuBLAS for every product),
which separates the port's kernels from the libraries. The card's name and
power limit are printed first. Exit code 0 whatever it finds.

Imports torch and the port; needs a card.
"""

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import model_config, randomize  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.models import unet as unet_module  # noqa: E402

BATCH = 16
RUNS = (("a", BATCH, 0, True), ("b7", BATCH, 7, False), ("b15", BATCH, 15, False),
        ("c", BATCH // 2, 3, False))  # (name, batch, target row, mates are padding)


def make_batch(gen, dev, cfg, batch, row, padded, target):
    """x (B, H, W, C) bf16, t (B,), y (B,) with the target at ``row``; the
    other rows zeros with label 0 (``padded``) or random requests."""
    x_t, t_t, y_t = target
    shape = (batch, cfg["resolution"], cfg["resolution"], cfg["in_channels"])
    if padded:
        x = torch.zeros(shape, device=dev)
        y = torch.zeros(batch, dtype=torch.long, device=dev)
    else:
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.randint(0, cfg["num_classes"], (batch,), generator=gen, device=dev)
    x[row], y[row] = x_t, y_t
    t = torch.full((batch,), int(t_t), dtype=torch.long, device=dev)
    return x.to(torch.bfloat16), t, y


def record_forward(model, x, t, y, row, full):
    """One forward; for every leaf-module call and every attention call, in
    order: a dict of name, op, shapes, the call to replay it (``fn``), its
    positional arguments (``args``: whole with ``full``, else the target's
    rows of the batched ones) and the target's input and output rows."""
    calls = []

    def keep(name, op, fn, args, out):
        inp = args[0]
        calls.append({
            "name": name, "op": op, "fn": fn, "in": tuple(inp.shape), "out": tuple(out.shape),
            "args": tuple(a.detach().clone() if full or not _batched(a, inp) else a[row].clone()
                          if isinstance(a, torch.Tensor) else a for a in args),
            "in_row": inp[row].detach().clone(), "out_row": out[row].detach().clone()})

    handles = []
    for name, mod in model.named_modules():
        if next(mod.children(), None) is None:
            handles.append(mod.register_forward_hook(
                lambda m, args, out, name=name: keep(name, type(m).__name__, m, args, out)))
    attention = unet_module.qkv_attention

    def recorded_attention(qkv, *args, **kw):
        out = attention(qkv, *args, **kw)
        keep("qkv_attention", "K1", functools.partial(_attend, attention, args, kw), (qkv,), out)
        return out

    unet_module.qkv_attention = recorded_attention
    try:
        with torch.inference_mode():
            model(x, t, y)
    finally:
        unet_module.qkv_attention = attention
        for h in handles:
            h.remove()
    return calls


def _attend(attention, args, kw, qkv):
    return attention(qkv, *args, **kw)


def _batched(a, inp):
    """Whether argument ``a`` of a call has the batch axis of its input."""
    return isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == inp.shape[0]


def replay(call, ref, row):
    """The call of another run again, with the target's rows of every
    batched argument replaced by run (a)'s: the target's output row of the
    op alone, its input held equal. Returns that row."""
    args = []
    for a, r in zip(call["args"], ref["args"]):
        if _batched(a, call["args"][0]):
            a = a.clone()
            a[row] = r
        args.append(a)
    with torch.inference_mode():
        return call["fn"](*args)[row]


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def compare(runs):
    """Per call of run (a): (name, op, shapes, {run: output row bit-equal to
    (a)'s}, {run: max abs}, {run: input row bit-equal to (a)'s}, {run: the
    op alone, replayed on (a)'s input row among that run's batch mates,
    bit-equal to (a)'s output row})."""
    ref = runs["a"][1]
    rows = []
    for i, call in enumerate(ref):
        eq, err, in_eq, alone = {}, {}, {}, {}
        for tag, (row, calls) in runs.items():
            if tag == "a":
                continue
            other = calls[i]
            if other["name"] != call["name"]:
                raise AssertionError(f"call {i}: {call['name']} in (a), {other['name']} in ({tag})")
            eq[tag] = torch.equal(call["out_row"], other["out_row"])
            err[tag] = 0.0 if eq[tag] else max_abs(call["out_row"], other["out_row"])
            in_eq[tag] = torch.equal(call["in_row"], other["in_row"])
            alone[tag] = torch.equal(call["out_row"], replay(other, call, row))
        rows.append((call["name"], call["op"], call["in"], call["out"], eq, err, in_eq, alone))
    return rows


def report(rows, kernels):
    tags = list(rows[0][4])
    label = "kernels=True" if kernels else "kernels=False (plain versions)"
    for i, (name, op, in_shape, out_shape, eq, err, in_eq, alone) in enumerate(rows):
        if all(eq.values()) and all(alone.values()):
            continue
        marks = " ".join(f"a={t}:{'=' if eq[t] else f'MOVES {err[t]:.6g}'}"
                         f"{'' if in_eq[t] else ' (input moved)'}" for t in tags)
        fault = [t for t in tags if not alone[t]]
        print(f"[{label}] {i:4d} {name} ({op}) in {list(in_shape)} out {list(out_shape)}: "
              f"{marks}{f'  <- AT FAULT alone against {fault}' if fault else ''}")
    summary = {"kernels": kernels, "calls": len(rows)}
    for t in tags:
        moved = [r for r in rows if not r[4][t]]
        at_fault = [r for r in rows if not r[7][t]]
        first = moved[0] if moved else None
        summary[t] = {
            "moved": len(moved),
            "at_fault": len(at_fault),
            "at_fault_ops": sorted({r[1] for r in at_fault}),
            "at_fault_calls": [f"{r[0]} {list(r[2])} -> {list(r[3])}" for r in at_fault],
            "first_moved": None if first is None else {
                "name": first[0], "op": first[1], "in": list(first[2]), "out": list(first[3]),
                "max_abs": first[5][t]},
        }
        where = ("none" if first is None else
                 f"{first[0]} ({first[1]}) in {list(first[2])} out {list(first[3])}, "
                 f"max abs {first[5][t]:.6g}")
        print(f"[{label}] (a) against ({t}): {len(moved)} of {len(rows)} calls move; first: "
              f"{where}; at fault (the op alone moves the row): {len(at_fault)}, ops "
              f"{summary[t]['at_fault_ops']}")
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--preset", default="openai_64")
    parser.add_argument("--timestep", type=int, default=500)
    parser.add_argument("--json", help="write both passes' summaries here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    cfg = model_config(args.preset)
    summaries = []
    state = None
    for kernels in (True, False):
        model = DiffusionModel(**cfg, dtype=torch.bfloat16, kernels=kernels, device=dev).eval()
        if state is None:
            randomize(model, args.seed)
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        shape = (cfg["resolution"], cfg["resolution"], cfg["in_channels"])
        target = (torch.randn(shape, generator=gen, device=dev), args.timestep, 417)
        runs = {}
        for tag, batch, row, padded in RUNS:
            x, t, y = make_batch(torch.Generator(device=dev).manual_seed(args.seed + 2), dev,
                                 cfg, batch, row, padded, target)
            runs[tag] = (row, record_forward(model, x, t, y, row, full=tag != "a"))
        summaries.append(report(compare(runs), kernels))
        del model, runs
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "preset": args.preset, "seed": args.seed,
                       "passes": summaries}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
