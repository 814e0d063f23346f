"""bf16 served samples/s of two checkouts' serving daemons on one NVIDIA card.

    python tools/compare_serving_builds.py --against <dir> [--batches 8 64] [--chains 3]

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
For each serve batch, each tree runs in its own process (both packages have
one name), in turns (other, this, this, other): the tree's kernels built
side by side, a ``SamplerService`` over a bf16 ``openai_64`` model (CFG's
null class added, seeded random weights from the tree's ``chip_smoke.py``),
CFG 0.8, the preset's DDIM-25, warmed up, then ``--chains`` full batches of
one-label requests served back to back. A turn reads served samples/s (the
batches' samples over their wall) and saves its first batch, and the tool
prints each turn, the better of each tree's two turns, and the largest
difference between the two trees' images. The card's name and power limit
are printed first.

Imports torch and the port; needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root, batch, chains, out):
    """One turn in this process, on the tree at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from chip_smoke import model_config, randomize
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.ops.kernels import _build
    from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    _build.build_all()
    dev = torch.device("cuda")
    model = DiffusionModel(**model_config(), dtype=torch.bfloat16, device=dev).eval()
    randomize(model, 0)
    diffusion = Diffusion(model=model, **dict(DIFFUSION_PRESETS["openai_64"],
                                              guidance_method="classifier_free",
                                              guidance_strength=0.8))
    labels = [int(j * 97 % 1000 + 1) for j in range(batch)]
    with SamplerService(diffusion, ServingConfig(serve_batch=batch, linger_ms=50.0),
                        device=dev) as svc:
        svc.warmup()
        first = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(chains):
            got = svc.sample(labels=labels, seed=100 + i, timeout=600)
            first = got if first is None else first
        wall = time.perf_counter() - t0
        stats = svc.stats()
    if stats["batches"] != chains or stats["padded_rows"]:
        raise AssertionError(f"served {stats}")
    np.save(out, first)
    return {"samples_per_s": batch * chains / wall, "wall_s": wall,
            "steps": diffusion.rescaled_num_steps}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of the other checkout")
    parser.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    parser.add_argument("--chains", type=int, default=3, help="full batches a turn")
    parser.add_argument("--worker", nargs=4, metavar=("ROOT", "BATCH", "CHAINS", "OUT"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        root, batch, chains, out = args.worker
        print(json.dumps(worker(root, int(batch), int(chains), out)))
        return 0
    if not args.against:
        parser.error("--against is required")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    roots = {"other": os.path.abspath(args.against), "this": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        for batch in args.batches:
            turns = {"other": [], "this": []}
            for i, tag in enumerate(("other", "this", "this", "other")):
                out = os.path.join(tmp, f"{tag}_{batch}_{i}.npy")
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--worker", roots[tag],
                     str(batch), str(args.chains), out],
                    capture_output=True, text=True, cwd=roots[tag])
                if proc.returncode:
                    raise SystemExit(f"{tag} at serve batch {batch} failed:\n{proc.stderr[-4000:]}")
                turn = json.loads(proc.stdout.strip().splitlines()[-1])
                turns[tag].append((turn, out))
                print(f"[serve] serve batch {batch}, {tag} ({roots[tag]}), turn {i + 1}: "
                      f"{turn['samples_per_s']:.4f} samples/s ({args.chains} full batches of "
                      f"DDIM-{turn['steps']} under CFG in {turn['wall_s']:.3f} s)")
            best = {tag: max(t["samples_per_s"] for t, _ in turns[tag]) for tag in turns}
            diff = float(np.abs(np.load(turns["this"][0][1]) - np.load(turns["other"][0][1])).max())
            print(f"[serve] serve batch {batch} ({smi}): best of two turns, this "
                  f"{best['this']:.4f} samples/s against the other {best['other']:.4f} "
                  f"({best['this'] / best['other']:.4f}x); first batch's images, this against "
                  f"the other: max abs {diff:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
