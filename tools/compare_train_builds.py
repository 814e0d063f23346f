"""Eager training steps/s of two checkouts' Trainers on one NVIDIA card.

    python tools/compare_train_builds.py --against <dir> [--steps 20]

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
Three variants, each in its own process (both packages have one name), in
turns (other, this, this-plain, this-plain, this, other):

- ``other``: the other tree's ``Trainer.train_step``;
- ``this``: this tree's with ``cuda_graph=False`` (the eager step, AdamW
  capturable as ``training/graphs.py::make_adamw`` builds it on the card);
- ``this-plain``: the same with ``torch.optim.AdamW(capturable=False)`` in
  place of ``make_adamw``, which tells the capturable math's cost from the
  rest of the step.

Each turn builds the tree's kernels, a bf16 ``openai_64`` model with CFG's
null class (remat, the preset's dropout 0.05, seeded random weights from the
tree's ``chip_smoke.py``), a Trainer at batch 8 (HYBRID loss, synthetic
data, lr 1e-4, weight decay 1e-3, EMA 0.99, seed 0), takes 3 steps to warm
up, then times ``--steps`` steps back to back: the wall a step, the host's
CPU time a step (``time.process_time``, every thread of the process), and
the device's busy time and kernel launches a step from ``torch.profiler``
over 2 more steps. It prints each turn, the mean of each variant's two
turns, and each variant's first 3 losses. The card's name and power limit
are printed first.

Imports torch and the port; needs a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this-plain", "this-plain", "this", "other")
BATCH = 8


def worker(root, variant, steps):
    """One turn in this process, on the tree at ``root``."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import model_config, randomize
    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.ops.kernels import _build
    from nicediffusion_tpu_torch.training.data import synthetic_batches
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    _build.build_all()
    dev = torch.device("cuda")
    kw = {}
    if variant != "other":
        kw["cuda_graph"] = False
    if variant == "this-plain":
        from nicediffusion_tpu_torch.training import trainer as trainer_module

        def plain_adamw(params, lr, weight_decay, tensor_lr=False):
            return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
        trainer_module.make_adamw = plain_adamw
    cfg = model_config()
    model = DiffusionModel(**cfg, dtype=torch.bfloat16, use_remat=True, device=dev)
    randomize(model, 0)
    loader = synthetic_batches(BATCH, cfg["resolution"], cfg["in_channels"], cfg["num_classes"],
                               seed=0)
    trainer = Trainer(model, dict(DIFFUSION_PRESETS["openai_64"],
                                  guidance_method="classifier_free"),
                      loader, iterations=1, batch_size=BATCH, lr=1e-4, weight_decay=1e-3,
                      ema_rate=0.99, seed=0, checkpoint_dir="unused", **kw)

    def step():
        return trainer.train_step(*next(loader))

    losses = [step()["loss"].item() for _ in range(3)]
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    busy = launches = 0.0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            busy += e.self_device_time_total / 1e3 / 2
            launches += e.count / 2
    return {"steps_per_s": steps / wall, "wall_ms": wall * 1e3 / steps,
            "host_cpu_ms": cpu * 1e3 / steps, "busy_ms": busy or None,
            "launches": launches, "losses": losses,
            "optimizer": type(trainer.optimizer).__name__,
            "capturable": bool(trainer.optimizer.defaults.get("capturable"))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of the other checkout")
    parser.add_argument("--steps", type=int, default=20, help="timed steps a turn")
    parser.add_argument("--worker", nargs=3, metavar=("ROOT", "VARIANT", "STEPS"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        root, variant, steps = args.worker
        print(json.dumps(worker(root, variant, int(steps))))
        return 0
    if not args.against:
        parser.error("--against is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    roots = {"other": os.path.abspath(args.against), "this": HERE, "this-plain": HERE}
    turns = {v: [] for v in roots}
    for i, variant in enumerate(TURNS):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", roots[variant], variant,
             str(args.steps)], capture_output=True, text=True, cwd=roots[variant])
        if proc.returncode:
            raise SystemExit(f"{variant} failed:\n{proc.stderr[-4000:]}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turns[variant].append(turn)
        print(f"[train] {variant} ({roots[variant]}), turn {i + 1}: {json.dumps(turn)}")
    for variant, got in turns.items():
        mean = {k: statistics.mean(t[k] for t in got)
                for k in ("steps_per_s", "wall_ms", "host_cpu_ms", "busy_ms", "launches")
                if all(t[k] is not None for t in got)}
        print(f"[train] {variant} ({smi}): the mean of two turns, openai_64 bf16 remat dropout "
              f"0.05 batch {BATCH}, {args.steps} eager steps a turn: {json.dumps(mean)}; "
              f"first losses {got[0]['losses']}; {got[0]['optimizer']} capturable "
              f"{got[0]['capturable']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
