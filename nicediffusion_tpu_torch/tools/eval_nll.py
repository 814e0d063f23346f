"""Full-chain NLL (bits/dim) evaluation of a diffusion checkpoint (torch).

Counterpart of the JAX package's tools/eval_nll.py, with its flags and its
one-line JSON: the IDDPM variational bound, total and prior bits-per-dim
and the mean eps-MSE over the chain, over a batch of real or synthetic
images, through ``Diffusion.bpd`` (a loop over every rescaled timestep).
The likelihood is the plain unguided model's.

Usage:
  python -m nicediffusion_tpu_torch.tools.eval_nll --model_path EMNIST_model.pt \\
      [--data images.npz] [--batch_size 16] [--num_batches 4] [--cpu] [--seed 0]

The checkpoint is a ``.pt`` (raw OpenAI or converted names) or the JAX
package's ``.npz``; its preset comes from its path (``64x64``, ``128x128``,
``256x256``, ``EMNIST``). ``--data`` is an ``.npz`` with an array under
'images' (NHWC, uint8 [0, 255] or float [-1, 1]) and, for class-conditional
models, 'labels'; without it, smooth synthetic images with random labels
are drawn from ``np.random.default_rng(--seed)`` in the JAX tool's order, so
both tools see the same images. It runs on the CUDA card in bfloat16, or in
float32 on the CPU with ``--cpu``; without ``--cpu`` and without a card it
raises. The chain's noise comes from one ``torch.Generator`` on the device
seeded from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nicediffusion_tpu_torch.tools.eval_nll",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True)
    p.add_argument("--data", default=None, help=".npz with 'images' (+ 'labels')")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_batches", type=int, default=1)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def synthetic_images(rng: np.random.Generator, n: int, res: int, ch: int,
                     num_classes: int | None):
    """``n`` smooth sinusoids in [-1, 1] (NHWC f32) and random labels (None
    for an unconditional model), drawn from ``rng`` in the JAX tool's order:
    phases, frequencies, labels."""
    yy, xx = np.mgrid[0:res, 0:res] / res
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1, ch))
    freq = rng.uniform(1, 3, size=(n, 1, 1, ch))
    images = np.sin(
        2 * np.pi * freq * (yy + xx)[None, :, :, None] + phase
    ).astype(np.float32) * 0.8
    labels = rng.integers(0, num_classes, size=(n,)) if num_classes is not None else None
    return images, labels


def evaluate(diffusion, images, labels, batch_size: int, num_batches: int,
             generator=None, noises=None) -> dict:
    """``Diffusion.bpd`` over ``num_batches`` consecutive batches of
    ``images`` (and ``labels``) on the diffusion's device; every batch draws
    from ``generator``, or takes ``noises[i]`` ((T, B, H, W, C), an array
    or a tensor, row t used at step t). Returns the tool's numbers:
    total_bpd, prior_bpd (means over the images) and eps_mse_mean (over
    batches and steps)."""
    import torch

    dev = diffusion.device
    totals, priors, mses = [], [], []
    for i in range(num_batches):
        lo, hi = i * batch_size, (i + 1) * batch_size
        x0 = torch.as_tensor(images[lo:hi], dtype=torch.float32, device=dev)
        y = (torch.as_tensor(labels[lo:hi], dtype=torch.long, device=dev)
             if labels is not None else None)
        noise = (torch.as_tensor(noises[i], dtype=torch.float32, device=dev)
                 if noises is not None else None)
        out = diffusion.bpd(x0, generator, y=y, noise=noise)
        totals.append(out["total_bpd"].float().cpu().numpy())
        priors.append(out["prior_bpd"].float().cpu().numpy())
        mses.append(out["mse_terms"].float().cpu().numpy().mean(axis=1))
    return {
        "total_bpd": float(np.concatenate(totals).mean()),
        "prior_bpd": float(np.concatenate(priors).mean()),
        "eps_mse_mean": float(np.stack(mses).mean()),
    }


def main(argv: list[str] | None = None) -> int:
    """Parse ``argv`` (default: the command line), evaluate, print the JSON
    line; returns the exit code (1 with a message for unusable ``--data``)."""
    args = make_parser().parse_args(argv)

    import torch

    from ..diffusion.process import Diffusion
    from ..models.unet import DiffusionModel
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import preset_for_path
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None, ask="pass --cpu")
    model_args, diff_args = preset_for_path(args.model_path)
    dtype = torch.float32 if args.cpu else torch.bfloat16
    model = DiffusionModel(**model_args, dtype=dtype, device=device).eval()
    model.load_state_dict(load_state_dict(args.model_path, device), strict=True)
    # bpd evaluates the plain (unguided) model likelihood
    diff_args = dict(diff_args, guidance_method=None, guidance_strength=None)
    diffusion = Diffusion(model=model, **diff_args)

    res, ch = model_args["resolution"], model_args["in_channels"]
    n_cls = model_args["num_classes"]
    rng = np.random.default_rng(args.seed)
    need = args.batch_size * args.num_batches
    if args.data:
        blob = np.load(args.data)
        images = np.asarray(blob["images"], dtype=np.float32)
        if images.max() > 1.5:  # uint8 range
            images = images / 127.5 - 1.0
        labels = np.asarray(blob["labels"]) if "labels" in blob else None
        if n_cls is not None and labels is None:
            print(f"error: {args.model_path} is class-conditional "
                  f"({n_cls} classes) — the conditional likelihood needs the "
                  f"true labels; add a 'labels' array to {args.data}", file=sys.stderr)
            return 1
        if len(images) < need:
            print(f"error: --data has {len(images)} images but "
                  f"batch_size*num_batches = {need}; lower them", file=sys.stderr)
            return 1
    else:
        images, labels = synthetic_images(rng, need, res, ch, n_cls)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    numbers = evaluate(diffusion, images, labels, args.batch_size, args.num_batches,
                       generator=generator)
    print(json.dumps({
        "model_path": args.model_path,
        "num_images": int(need),
        "chain_steps": int(diffusion.rescaled_num_steps),
        **numbers,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
