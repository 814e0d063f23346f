"""Distillation CLI: guided (stage 1) and/or progressive step-halving (torch).

Counterpart of scripts/distill.py of the JAX package, with its flags one for
one. ``--distill_guidance [W]`` first bakes classifier-free guidance into a
single-forward student; each of ``--rounds`` halving rounds then trains a
student, initialised from the teacher, to match two teacher DDIM steps in
one (training/distill.py). The model computes in bfloat16 on the CUDA card,
or in float32 on the CPU with ``--cpu``; without ``--cpu`` and without a card
it raises.

Weights load through utils/checkpoint.py (a torch ``.pt`` state dict or the
JAX package's ``.npz``); an orbax directory is refused with the way round
it (the JAX package's scripts/export.py writes a ``.pt``). The student is
saved as the JAX package's flat ``.npz``, so either package can load it,
with the same ``.distill.json`` sidecar beside it and the same printed
sampling hint, which the port's sampling entry point takes as it is.

One divergence: ``--var_weight 0`` means off (training/distill.py), so it
neither computes a zero-weight term nor prints the "variance head trained"
hint.

Usage:
  python -m nicediffusion_tpu_torch.scripts.distill --model_path 64x64_diffusion.pt \\
      [--distill_guidance [W]] [--rounds 2] [--iterations 2000] \\
      [--lr 1e-4] [--batch_size 32] [--data images.npz] \\
      [--save_path distilled.npz] [--cpu] [-w]

Data: an .npz with 'images' (+ 'labels' for conditional models), or
synthetic smooth images as a smoke fallback, drawn from ``--seed`` with
numpy exactly as the JAX script draws them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nicediffusion_tpu_torch.scripts.distill")
    p.add_argument("--model_path", required=True)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--steps", type=int, default=None,
                   help="teacher step count to start from (must be halvable "
                        "--rounds times; overrides the preset's, which may be odd)")
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", default="warmup_cosine",
                   choices=("constant", "warmup_cosine"))
    p.add_argument("--grad_clip", type=float, default=1.0,
                   help="global-norm gradient clip (0 disables)")
    p.add_argument("--loss_space", default=None, choices=("eps", "x0_snr"),
                   help="loss conditioning; default: eps-MSE in stage 1 for eps "
                        "students, the truncated-SNR x0 loss in the halving rounds "
                        "and for v students (training/distill.py)")
    p.add_argument("--student_pred", default=None, choices=("eps", "v"),
                   help="student output convention; 'v' with --distill_guidance "
                        "reparameterises the checkpoint to v-prediction in stage 1, "
                        "and the halving rounds then run in v-space")
    p.add_argument("--var_weight", type=float, default=None,
                   help="train the student's learned-variance head too (stage 1: "
                        "match the guided teacher's variance; halving rounds: VLB on "
                        "the student grid) so distilled students can sample "
                        "stochastic DDPM. Try 1.0; default (and 0) off")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--data", default=None)
    p.add_argument("--save_path", default="distilled.npz")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--prediction_type", type=str, default="eps", choices=("eps", "v"),
                   help="model output convention of the teacher checkpoint")
    p.add_argument("--distill_guidance", type=float, nargs="?", const=-1.0,
                   default=None, metavar="W",
                   help="stage-1 guided distillation: first bake classifier-free "
                        "guidance at strength W into a single-forward student, then "
                        "run the halving rounds on it. Bare flag uses the preset's "
                        "guidance_strength; needs a classifier-free checkpoint (null "
                        "class 0). With --rounds 0, runs stage 1 alone.")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the preset's class count (a classifier-free "
                        "checkpoint has the null class besides, as in the sampling CLI)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-w", "--wordy", action="store_true")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), distill, write the
    student and its sidecar; returns the sidecar's contents."""
    args = make_parser().parse_args(argv)

    import torch

    from ..models.unet import DiffusionModel
    from ..training.distill import GuidedDistiller, ProgressiveDistiller
    from ..utils.checkpoint import load_state_dict, save_params_npz
    from ..utils.config import preset_for_path
    from ..utils.convert import convert_torch_state_dict

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError(
            "distillation runs on the CUDA card and torch.cuda.is_available() is "
            "False; pass --cpu to run on the CPU"
        )
    if os.path.isdir(args.model_path):
        raise ValueError(
            f"{args.model_path} is a directory (an orbax checkpoint?): the port does not "
            "read orbax; turn it into a .pt with the JAX package's scripts/export.py"
        )

    model_args, diff_args = preset_for_path(args.model_path)
    if args.num_classes is not None:
        model_args["num_classes"] = args.num_classes
    dtype = torch.float32 if args.cpu else torch.bfloat16
    model = DiffusionModel(**model_args, dtype=dtype, device=device)
    params = load_state_dict(args.model_path, device)

    res, ch = model_args["resolution"], model_args["in_channels"]
    n_cls = model_args["num_classes"]
    rng = np.random.default_rng(args.seed)

    if args.data:
        blob = np.load(args.data)
        images = np.asarray(blob["images"], dtype=np.float32)
        if images.max() > 1.5:
            images = images / 127.5 - 1.0
        labels = np.asarray(blob["labels"]) if "labels" in blob else None
        if n_cls is not None and labels is None:
            sys.exit("error: conditional model needs 'labels' in --data")
    else:
        yy, xx = np.mgrid[0:res, 0:res] / res
        n = max(args.batch_size * 8, 256)
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1, ch))
        freq = rng.uniform(1, 3, size=(n, 1, 1, ch))
        images = (np.sin(2 * np.pi * freq * (yy + xx)[None, :, :, None] + phase)
                  * 0.8).astype(np.float32)
        labels = rng.integers(0, n_cls, size=(n,)) if n_cls is not None else None

    def loader():
        while True:
            idx = rng.integers(0, len(images), size=(args.batch_size,))
            yield images[idx], (labels[idx] if labels is not None else None)

    if args.rounds < 1 and args.distill_guidance is None:
        sys.exit("error: --rounds must be >= 1 (0 only with "
                 "--distill_guidance for a stage-1-only run)")
    var_weight = args.var_weight or None
    steps = args.steps or diff_args["rescaled_num_steps"]
    student = None
    guided_w = None  # set when stage-1 guided distillation runs
    cur_pred = args.prediction_type  # the current weights' convention
    # round r's teacher grid: the preset's (or --steps') even respacing for
    # round 1, then the previous student's exact nested grid (grids of two
    # even respacings do not nest)
    teacher_args = dict(diff_args, rescaled_num_steps=steps,
                        prediction_type=args.prediction_type)
    log_every = max(args.iterations // 10, 1) if args.wordy else None

    if args.distill_guidance is not None:
        # stage 1: bake CFG into a single conditional forward; the null
        # class (label 0) must exist, i.e. a classifier-free checkpoint
        if n_cls is None:
            sys.exit("error: --distill_guidance needs a conditional model")
        if args.distill_guidance >= 0:
            w = args.distill_guidance
        elif diff_args.get("guidance_strength") is not None:
            w = diff_args["guidance_strength"]
        else:
            sys.exit("error: preset has no guidance_strength; pass an "
                     "explicit --distill_guidance W")
        if diff_args.get("guidance_method") != "classifier_free":
            print("warning: preset is not classifier_free — label 0 will be "
                  "treated as the CFG null class during stage 1")
        if args.wordy:
            print(f"Stage 1: guided distillation at w={w} "
                  f"({args.iterations} iterations, {steps} steps)")
        gd = GuidedDistiller(
            model=model, teacher_params=params, diffusion_args=teacher_args,
            dataloader=loader(), iterations=args.iterations, guidance_strength=w,
            lr=args.lr, lr_schedule=args.lr_schedule, grad_clip=args.grad_clip or None,
            loss_space=args.loss_space, student_prediction_type=args.student_pred,
            var_weight=var_weight, seed=args.seed + 10_000,
        )
        params, student = gd.run(log_every=log_every)
        del gd
        guided_w = w
        cur_pred = args.student_pred or cur_pred
        teacher_args = dict(teacher_args, prediction_type=cur_pred)
    for r in range(args.rounds):
        if steps % 2:
            sys.exit(f"error: cannot halve odd step count {steps}")
        if args.wordy:
            print(f"Round {r + 1}/{args.rounds}: distilling {steps} -> "
                  f"{steps // 2} steps ({args.iterations} iterations)")
        distiller = ProgressiveDistiller(
            model=model, teacher_params=params, diffusion_args=teacher_args,
            dataloader=loader(), iterations=args.iterations, lr=args.lr,
            lr_schedule=args.lr_schedule, grad_clip=args.grad_clip or None,
            loss_space=args.loss_space,
            # cross-parameterise only if stage 1 did not already convert
            student_prediction_type=(
                args.student_pred
                if args.student_pred and args.student_pred != cur_pred else None
            ),
            var_weight=var_weight, seed=args.seed + r,
        )
        params, student = distiller.run(log_every=log_every)
        del distiller
        steps = student.rescaled_num_steps
        cur_pred = args.student_pred or cur_pred
        teacher_args = dict(
            diff_args, rescaled_num_steps=steps,
            timestep_indices=student.timestep_map.cpu().numpy(),
            prediction_type=cur_pred,
        )

    save_params_npz(convert_torch_state_dict(params), args.save_path)
    # the student's grid is the nested odd-index subset, which an even
    # --rescaled_num_steps respacing does not reproduce: record the exact
    # original-chain indices; guided=true means CFG is in the weights, so
    # sampling must not apply it again (the '--guidance_method none' hint)
    grid = [int(i) for i in student.timestep_map.cpu().numpy()]
    sidecar = {"steps": steps, "timestep_indices": grid, "guided": guided_w is not None,
               "guidance_strength": guided_w, "prediction_type": cur_pred}
    with open(args.save_path + ".distill.json", "w") as f:
        json.dump(sidecar, f)
    indices = "/".join(str(i) for i in grid)
    pred_hint = " --prediction_type v" if cur_pred == "v" else ""
    if args.rounds == 0:
        # stage 1 alone keeps the teacher's grid and its variance head
        hint = (f"  --guidance_method none{pred_hint}"
                f"  # CFG (w={guided_w}) baked into the weights; any "
                "sampler works (stage 1 keeps the teacher's grid)")
    else:
        hint = f"  --sampler ddim --timestep_indices {indices}{pred_hint}"
        if guided_w is not None:
            hint += (" --guidance_method none"
                     f"  # CFG (w={guided_w}) is baked into the weights")
        if var_weight is not None:
            hint += ("\n  (variance head trained: stochastic --sampler "
                     "ddpm on the same indices also works)")
    print(f"Distilled to {steps} steps -> {args.save_path}. Sample with:\n" + hint)
    return sidecar


if __name__ == "__main__":
    main()
