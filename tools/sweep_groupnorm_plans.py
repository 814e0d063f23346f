"""Every split K3 and its backward can take, timed at the UNets' shapes.

    python tools/sweep_groupnorm_plans.py [--out FILE]

K3 (``csrc/groupnorm.cu``) cuts each call into channel slices and clusters of
blocks (its plan: ``group_norm_plan``), chosen by a cost model. This tool
forces each split the card can run, in turn, at every GroupNorm shape of one
``openai_64`` forward at model batch 16 and one ``openai_128`` forward at
batch 4 (the forward kernel), and of one ``openai_64`` training step at batch
8 and one guidance gradient of the ``openai_128`` classifier at batch 4 (the
backward kernel), all bf16, and times each by a CUDA graph of 10 calls
replayed (chip_smoke.py's ``graph_ms``). It prints each shape's splits
beside the model's own pick, and the sums over each forward or step of the
model's picks and of the fastest split of each shape. With ``--out`` it also
writes one JSON line per (shape, split). The model's own pick is restored
after each shape.

Imports torch and the port; needs a card.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import (  # noqa: E402
    GUIDED_BATCH, TRAIN_BATCH, classifier_config, graph_ms, main_path_calls, model_config)
from nicediffusion_tpu_torch import DiffusionModel, EncoderUNet  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402


def splits(c, itemsize, groups=32, vec_bytes=16):
    """The (slices, cluster size) pairs a call can take: slices of whole
    groups whose rows are whole vectors and at least 128 bytes (or one
    slice), clusters of 1 to 16."""
    vec = vec_bytes // itemsize
    for s in range(1, groups + 1):
        cs = c // s
        if groups % s or cs % vec or cs // vec > 512 or (s > 1 and cs * itemsize < 128):
            continue
        for cl in (1, 2, 4, 8, 16):
            yield s, cl


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="a JSON line per (shape, split) to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    meta = torch.device("meta")
    models = {
        "openai_64": DiffusionModel(**model_config(), kernels=False, device=meta),
        "openai_128": DiffusionModel(**model_config("openai_128"), kernels=False, device=meta),
        "classifier": EncoderUNet(**classifier_config(), kernels=False, device=meta),
    }
    runs = [("openai_64", 16, False), ("openai_128", GUIDED_BATCH, False),
            ("openai_64", TRAIN_BATCH, True), ("classifier", GUIDED_BATCH, True)]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = open(args.out, "w") if args.out else None
    for preset, b, backward in runs:
        calls = main_path_calls(models[preset].eval(), meta)
        keys = sorted((k, n) for k, n in calls.items() if k[0] == "groupnorm")
        what = "backward" if backward else "forward"
        total_pick = total_best = 0.0
        for (_, (h, w, c), mode), per in keys:
            x = (2 * torch.randn(b, h, w, c, generator=gen, device=dev) + 0.5).bfloat16()
            sc, bi = torch.randn(c, generator=gen, device=dev), torch.randn(c, generator=gen,
                                                                           device=dev)
            emb = (0.1 * torch.randn(b, 2 * c, generator=gen, device=dev)).bfloat16()
            rows = tuple(emb.chunk(2, dim=-1)) if mode == "ada" else (None, None)
            cot = torch.randn(b, h, w, c, generator=gen, device=dev).bfloat16()
            silu = mode != "plain"
            _, mean, rstd = k3.group_norm_fused_with_stats(x, sc, bi, *rows, silu=silu)
            if backward:
                def fn():
                    return k3.group_norm_fused_bwd(x, sc, bi, *rows, cot, mean, rstd, silu=silu)
            else:
                def fn():
                    return k3.group_norm_fused(x, sc, bi, *rows, silu=silu)
            shape = (b, h, w, c)
            pick = k3.group_norm_plan(shape, torch.bfloat16, backward=backward)
            times = {}
            for s, cl in splits(c, 2):
                try:
                    plan = k3.group_norm_plan(shape, torch.bfloat16, backward=backward,
                                              force=(s, cl))
                except RuntimeError:
                    continue  # a cluster the card cannot schedule, or no rows to cut
                if (plan["slices"], plan["cluster"]) in times:
                    continue
                ms = graph_ms(fn, iters=10)
                times[plan["slices"], plan["cluster"]] = ms
                if out:
                    out.write(json.dumps({"preset": preset, "kernel": what, "shape": shape,
                                          "mode": mode, "per": per, "ms": ms, **plan}) + "\n")
            chosen = (pick["slices"], pick["cluster"])
            k3.group_norm_plan(shape, torch.bfloat16, backward=backward, force=chosen)
            best = min(times, key=times.get)
            total_pick += per * times[chosen]
            total_best += per * times[best]
            print(f"{what} {preset} {mode} {shape}, {per} per call: model's pick "
                  f"{chosen} {times[chosen]:.4f} ms ({pick['route']}), fastest {best} "
                  f"{times[best]:.4f} ms; all: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(times.items())), flush=True)
        print(f"{what} {preset} at batch {b}, summed over the calls: the model's picks "
              f"{total_pick:.4f} ms, the fastest split of each shape {total_best:.4f} ms",
              flush=True)
    if out:
        out.close()


if __name__ == "__main__":
    main()
