"""bf16 K4 of two builds of the residual-block kernel on one NVIDIA card.

    python tools/compare_resblock_builds.py --against <dir>

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/resblock.cu`` of both trees
with the package's nvcc flags (side by side) and calls each through its own
C interface (a build with the bf16 tensor-core kernel takes an extra (A, B)
scratch; an earlier one does not) at every (H, C, F, ada) of the residual-
block halves of one ``openai_64`` forward at model batch 16, the inputs of
chip_smoke.py's ``[k4]``. Times are taken in turns (other, this, this,
other), the smaller of the two turns kept, each two ways with chip_smoke.py's
timers: CUDA events around 5 back-to-back calls (host-timed) and a CUDA graph
of 5 calls replayed (device time). The two results are held to each other
within K4's bf16 gates (per element and relative). Prints each shape with
its TFLOP/s and the sums over the forward's halves.

Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from _builds import in_turns, nvcc  # noqa: E402
from chip_smoke import (  # noqa: E402
    K4_BF16_REL, K4_BF16_TOL, PATHS, graph_ms, k4_rel_err, model_config, resblock_halves,
    resblock_inputs, time_ms, within)
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import resblock as k4  # noqa: E402

SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "resblock.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(root, out_dir, tag):
    """The tree's K4 library and whether its interface takes the (A, B) scratch."""
    src = os.path.join(root, SOURCE)
    lib, _ = nvcc(src, os.path.join(out_dir, f"libresblock_{tag}.so"))
    with open(src) as f:
        with_ab = "void* rstd, void* ab" in f.read()
    lib.nd_gn_silu_conv3x3.argtypes = [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P, _P, _P,
                                       _P, _P, *([_P] if with_ab else []), *[_I] * 6,
                                       ctypes.c_float, _I, _I, _P]
    lib.nd_gn_silu_conv3x3.restype = _I
    return lib, with_ab


def k4_call(lib, with_ab, args, packed, out, scratch):
    """bf16 K4 through one build's C interface: scratch holds the statistics
    and, for a build that takes it, the (A, B) pairs."""
    x, gamma, beta, _, bias, *emb = args
    b, h, w, c = x.shape
    stats, ab = scratch
    es, eb = emb if emb else (None, None)
    err = lib.nd_gn_silu_conv3x3(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        es.data_ptr() if emb else None, eb.data_ptr() if emb else None,
        es.stride(0) if emb else 0, 0, packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), *([ab.data_ptr()] if with_ab else []),
        b, h, w, c, out.shape[-1], 32, 1e-5, int(bool(emb)), 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: {err}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its residual-block kernel is built)")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "compare"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    roots = {"other": args.against, "this": os.path.dirname(_build.CSRC.parent)}
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:
        libs = dict(zip(roots, pool.map(lambda tag: build(roots[tag], args.build_dir, tag),
                                        roots)))
    dev = torch.device("cuda")
    model = DiffusionModel(**model_config(), kernels=False, device="meta").eval()
    halves = resblock_halves(model, torch.device("meta"))
    b = PATHS["forward"][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {}
    for (h, c, f, ada), per in sorted(halves.items()):
        inputs = resblock_inputs(gen, dev, torch.bfloat16, b, h, h, c, f, ada)
        packed = k4.pack_conv3x3_weight(inputs[3], torch.bfloat16)
        outs = {tag: torch.empty(b, h, h, f, dtype=torch.bfloat16, device=dev) for tag in roots}
        scratch = {tag: (torch.empty(2, b, 32, device=dev),
                         torch.empty(b, -(-c // 64) * 64, 2, device=dev)) for tag in roots}
        calls = {tag: (lambda tag=tag: k4_call(*libs[tag], inputs, packed, outs[tag],
                                               scratch[tag])) for tag in roots}
        best = in_turns(calls, {"events": lambda fn: time_ms(fn, iters=5, rounds=3),
                                "graph": lambda fn: graph_ms(fn, iters=5)})
        torch.cuda.synchronize()
        gap = (outs["this"].float() - outs["other"].float()).abs().max().item()
        rel = k4_rel_err(outs["this"], outs["other"])
        if not within(outs["this"], outs["other"], K4_BF16_TOL) or rel > K4_BF16_REL:
            raise SystemExit(f"K4 of the two trees differ by {gap:.3g} (relative {rel:.3g}) at "
                             f"{(b, h, h, c)} -> {f}")
        flop = 2 * 9 * c * f * b * h * h
        for key, ms in best.items():
            sums[key] = sums.get(key, 0.0) + per * ms
        print(f"K4 x ({b}, {h}, {h}, {c}) -> {f}, {'ada' if ada else 'plain'}, {per} per "
              f"forward: " + "; ".join(
                  f"{tag} {best[tag, 'events']:.4f} ms (graph {best[tag, 'graph']:.4f}, "
                  f"{flop / best[tag, 'graph'] / 1e9:.2f} TFLOP/s)" for tag in roots)
              + f"; the two differ by at most {gap:.3g}, relative {rel:.3g}", flush=True)
    total = sum(n * 2 * 9 * c * f * b * h * h for (h, c, f, _), n in halves.items())
    print(f"K4 sum over the {sum(halves.values())} residual-block halves of one openai_64 forward "
          f"at model batch {b}: " + "; ".join(
              f"{tag} {sums[tag, 'events']:.4f} ms (graph {sums[tag, 'graph']:.4f}, "
              f"{total / sums[tag, 'graph'] / 1e9:.2f} TFLOP/s)" for tag in roots)
          + f"; this / other in device time {sums['this', 'graph'] / sums['other', 'graph']:.4f}",
          flush=True)


if __name__ == "__main__":
    main()
