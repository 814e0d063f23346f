"""Checkpoint export and conversion (torch, on the CPU).

Counterpart of scripts/export.py of the JAX package, with its flags: converts
between a torch ``.pt`` state dict (the original reference's names, which
the port's models load with ``strict=True``), the JAX package's flat
``.npz`` and the port's own train state, in either direction.

  * ``.pt`` -> ``.npz``: read with utils/checkpoint.py's ``load_state_dict``
    (raw OpenAI names are renamed), converted to the flax tree, saved as the
    JAX package's ``.npz``;
  * ``.npz`` -> ``.pt``: the flax tree converted to torch names and layouts;
  * a directory: the port Trainer's ``step_{N}`` checkpoint
    (``step_{N}/state.pt``); ``--part params`` takes its model weights,
    ``--part ema_params`` its EMA. An orbax directory of the JAX Trainer has
    no ``state.pt`` and is refused: the JAX package's scripts/export.py
    turns it into a ``.pt``.

Usage:
  python -m nicediffusion_tpu_torch.scripts.export --input checkpoints/step_1500 \\
      --output model.pt [--part ema_params]
  python -m nicediffusion_tpu_torch.scripts.export --input 64x64_diffusion.pt --output model.npz
  python -m nicediffusion_tpu_torch.scripts.export --input model.npz --output model.pt
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(prog="nicediffusion_tpu_torch.scripts.export",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True,
                        help=".pt / .npz / the port Trainer's step_{N} directory")
    parser.add_argument("--output", required=True, help=".pt or .npz path")
    parser.add_argument(
        "--part", default="params", choices=["params", "ema_params"],
        help="which weights to take from a train-state checkpoint directory",
    )
    args = parser.parse_args(argv)
    if not args.output.endswith((".npz", ".pt", ".pth")):
        raise ValueError("output must end in .npz or .pt/.pth")

    import numpy as np
    import torch

    from ..utils.checkpoint import load_npz_tree, load_state_dict, save_params_npz
    from ..utils.convert import convert_torch_state_dict, flax_params_to_torch_state_dict

    if os.path.isdir(args.input):
        state_path = os.path.join(args.input, "state.pt")
        if not os.path.isfile(state_path):
            raise FileNotFoundError(
                f"{args.input} holds no state.pt, so it is no train state of this "
                "package; an orbax checkpoint of the JAX Trainer is converted by the "
                "JAX package's scripts/export.py (python scripts/export.py --input "
                f"{args.input} --output model.pt)"
            )
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        sd = state["model" if args.part == "params" else "ema"]
    elif args.input.endswith(".npz"):
        sd = flax_params_to_torch_state_dict(load_npz_tree(args.input))
    else:
        sd = load_state_dict(args.input, "cpu")

    if args.output.endswith(".npz"):
        save_params_npz(convert_torch_state_dict(sd), args.output)
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                    else v for k, v in sd.items()}, args.output)
    n = sum(int(np.prod(v.shape)) for v in sd.values())
    print(f"Exported {n} parameters from {args.input} to {args.output}")


if __name__ == "__main__":
    main()
