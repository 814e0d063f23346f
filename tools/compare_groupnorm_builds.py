"""K3 (fused GroupNorm) and its backward of two trees on one NVIDIA card.

    python tools/compare_groupnorm_builds.py --against <dir> [--batches 16 128 8 4]

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
A tree whose K3 is the Triton kernel (with a backward that recomputes the
plain version under autograd) has its
``nicediffusion_tpu_torch/ops/kernels/groupnorm.py`` loaded as a module of
its own. For a tree whose K3 is CUDA C++, its ``csrc/groupnorm.cu`` is
built with the package's nvcc flags and this tree's wrapper is loaded a
second time, bound to that library (the C interface is the same).

At every GroupNorm shape of one ``openai_64`` forward at each model batch of
``--batches`` (default 16; bf16, the inputs of chip_smoke.py's
``[kernels]``) it times both forwards;
at every GroupNorm shape of one ``openai_64`` training step at batch 8 (bf16)
both backwards, each through its tree's autograd Function
(``torch.autograd.grad`` of the forward's output), and this tree's backward
kernel also called directly. Times are taken in turns (other, this, this,
other), the smaller of the two turns kept: forwards by a CUDA graph of 10
calls replayed and by torch.profiler (the kernels' own device time), the
autograd backwards by torch.profiler (a graph cannot hold them), the direct
backward both ways. The two trees' results are held to each other within
K3's bf16 gates (per element and relative). Prints each shape and the sums
over the forward and over the step, with the ratios.

Imports torch and the port; needs a card.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import types

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import (  # noqa: E402
    BF16_TOL, K3_BF16_REL, PATHS, TRAIN_BATCH, graph_ms, k3_rel_err, main_path_calls,
    model_config, profiled_ms, within)
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3  # noqa: E402

MODULE = os.path.join("nicediffusion_tpu_torch", "ops", "kernels", "groupnorm.py")
SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "groupnorm.cu")


def load_other(root, build_dir):
    """The other tree's K3 module, under a name of its own: its own module
    for a Triton K3; for a CUDA C++ K3, this tree's wrapper bound to the
    other tree's library, built into ``build_dir``."""
    path = os.path.join(root, MODULE)
    with open(path) as f:
        standalone = "from . import" not in f.read()
    if standalone:
        spec = importlib.util.spec_from_file_location("other_groupnorm", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(build_dir, "libgroupnorm_other.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           os.path.join(root, SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {root}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    spec = importlib.util.spec_from_file_location(
        "nicediffusion_tpu_torch.ops.kernels._other_groupnorm", k3.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(
        bind=lambda name, signatures: _build.set_signatures(lib, signatures),
        launch_error=_build.launch_error)
    return mod


def inputs(gen, dev, b, h, w, c, mode, grad=False):
    """chip_smoke.py's K3 inputs: x, scale, bias and, for AdaGN, modulation
    rows as the halves of one (B, 2C) tensor; with ``grad`` each a leaf of its
    own that wants a gradient, and a cotangent."""
    x = (2 * torch.randn(b, h, w, c, generator=gen, device=dev) + 0.5).bfloat16()
    sc = torch.randn(c, generator=gen, device=dev)
    bi = torch.randn(c, generator=gen, device=dev)
    emb = (0.1 * torch.randn(b, 2 * c, generator=gen, device=dev)).bfloat16()
    args = [x, sc, bi] + (list(emb.chunk(2, dim=-1)) if mode == "ada" else [])
    if grad:
        args = [t.detach().clone().requires_grad_(True) for t in args]
    cot = torch.randn(b, h, w, c, generator=gen, device=dev).bfloat16()
    return args, cot


def in_turns(fns, timers):
    """{(tag, timer name): the smaller of two turns}, turns other, this,
    this, other."""
    best = {}
    for tag in ("other", "this", "this", "other"):
        for how, timer in timers.items():
            best[tag, how] = min(best.get((tag, how), float("inf")), timer(fns[tag]))
    return best


def hold(name, got, ref):
    """The two trees' results within K3's bf16 gates; returns the relative error."""
    if not within(got, ref, BF16_TOL["groupnorm"]):
        raise SystemExit(f"{name}: the two trees differ by "
                         f"{(got.float() - ref.float()).abs().max().item():.3g}")
    rel = k3_rel_err(got, ref)
    if rel > K3_BF16_REL:
        raise SystemExit(f"{name}: the two trees differ by {rel:.3g} relative")
    return rel


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True, help="root of the other checkout")
    parser.add_argument("--batches", type=int, nargs="+", default=[PATHS["forward"][0]],
                        help="model batches of the forwards")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "compare"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    other = load_other(args.against, args.build_dir)
    trees = {"other": other, "this": k3}
    dev = torch.device("cuda")
    model = DiffusionModel(**model_config(), kernels=False, device="meta").eval()
    keys = sorted((k, n) for k, n in main_path_calls(model, torch.device("meta")).items()
                  if k[0] == "groupnorm")
    gen = torch.Generator(device=dev).manual_seed(0)
    graph = lambda fn: graph_ms(fn, iters=10)  # noqa: E731
    prof = lambda fn: profiled_ms(fn, iters=10)  # noqa: E731

    for b in args.batches:
        compare_forwards(trees, keys, gen, dev, b, graph, prof)
    compare_backwards(trees, keys, gen, dev, graph, prof)


def compare_forwards(trees, keys, gen, dev, b, graph, prof):
    """Both trees' forwards at every GroupNorm shape of one openai_64
    forward at model batch ``b``, and their sums."""
    sums, worst = {}, 0.0
    for (_, (h, w, c), mode), per in keys:
        x, *rest = inputs(gen, dev, b, h, w, c, mode)[0]
        kw = dict(silu=mode != "plain")
        outs = {tag: tree.group_norm_fused(x, *rest, **kw) for tag, tree in trees.items()}
        worst = max(worst, hold(f"forward {mode} {(b, h, w, c)}", outs["this"], outs["other"]))
        fns = {tag: (lambda tree=tree: tree.group_norm_fused(x, *rest, **kw))
               for tag, tree in trees.items()}
        best = in_turns(fns, {"graph": graph, "profiler": prof})
        for key, ms in best.items():
            sums["forward", *key] = sums.get(("forward", *key), 0.0) + per * ms
        print(f"K3 forward {mode} ({b}, {h}, {w}, {c}), {per} per forward: " + "; ".join(
            f"{tag} {best[tag, 'graph']:.4f} ms by graph, {best[tag, 'profiler']:.4f} by "
            f"torch.profiler" for tag in trees), flush=True)
    print(f"K3 forward, sum over the {sum(n for _, n in keys)} calls of one openai_64 forward at "
          f"model batch {b}, bf16: " + "; ".join(
              f"{tag} {sums['forward', tag, 'graph']:.4f} ms by graph, "
              f"{sums['forward', tag, 'profiler']:.4f} by torch.profiler" for tag in trees)
          + f"; this / other {sums['forward', 'this', 'profiler'] / sums['forward', 'other', 'profiler']:.4f}"
          f" by torch.profiler, {sums['forward', 'this', 'graph'] / sums['forward', 'other', 'graph']:.4f}"
          f" by graph; the two within {worst:.3g} relative", flush=True)


def compare_backwards(trees, keys, gen, dev, graph, prof):
    """Both trees' backwards through autograd, and this tree's kernel called
    directly, at every GroupNorm shape of one openai_64 training step."""
    b = TRAIN_BATCH
    sums, worst = {}, 0.0
    for (_, (h, w, c), mode), per in keys:
        leaves, cot = inputs(gen, dev, b, h, w, c, mode, grad=True)
        kw = dict(silu=mode != "plain")
        outs = {tag: tree.group_norm_fused(*leaves, **kw) for tag, tree in trees.items()}
        grads = {tag: torch.autograd.grad(out, leaves, cot, retain_graph=True)
                 for tag, out in outs.items()}
        for i, (a, r) in enumerate(zip(grads["this"], grads["other"])):
            worst = max(worst, hold(f"backward {mode} {(b, h, w, c)} input {i}", a, r))
        fns = {tag: (lambda out=out: torch.autograd.grad(out, leaves, cot, retain_graph=True))
               for tag, out in outs.items()}
        best = in_turns(fns, {"profiler": prof})
        # this tree's kernel called directly, on the forward's statistics
        plain = [t.detach() for t in leaves] + [None] * (5 - len(leaves))
        _, mean, rstd = k3.group_norm_fused_with_stats(*plain, **kw)
        direct = lambda: k3.group_norm_fused_bwd(*plain, cot, mean, rstd, **kw)  # noqa: E731
        best["direct", "graph"], best["direct", "profiler"] = graph(direct), prof(direct)
        for key, ms in best.items():
            sums["backward", *key] = sums.get(("backward", *key), 0.0) + per * ms
        print(f"K3 backward {mode} ({b}, {h}, {w}, {c}), {per} per step, through autograd by "
              f"torch.profiler: other {best['other', 'profiler']:.4f} ms, this "
              f"{best['this', 'profiler']:.4f}; this tree's kernel called directly "
              f"{best['direct', 'graph']:.4f} ms by graph, {best['direct', 'profiler']:.4f} by "
              f"torch.profiler", flush=True)
    print(f"K3 backward, sum over the GroupNorm calls of one openai_64 training step at batch "
          f"{b}, bf16, through autograd by torch.profiler: other "
          f"{sums['backward', 'other', 'profiler']:.4f} ms, this "
          f"{sums['backward', 'this', 'profiler']:.4f} (this / other "
          f"{sums['backward', 'this', 'profiler'] / sums['backward', 'other', 'profiler']:.4f}); "
          f"this tree's kernel called directly {sums['backward', 'direct', 'graph']:.4f} ms by "
          f"graph, {sums['backward', 'direct', 'profiler']:.4f} by torch.profiler; the two "
          f"within {worst:.3g} relative", flush=True)


if __name__ == "__main__":
    main()
