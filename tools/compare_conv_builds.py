"""The bf16 conv of two builds on one NVIDIA card: bits and times.

    python tools/compare_conv_builds.py --against <dir> [--batches 16 128]

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/bf16conv.cu`` of both trees
with the package's nvcc flags (side by side) and calls each through its own
C interface, on the same bf16 x, weights laid out (F, k, k, C) and bias: a
build whose ``nd_bf16_conv`` takes a grid cap and a loading way (this
design) on the plan of this tree's ``conv_nhwc_plan``, an older one on the
filter tile its own plan took (the widest of 192, 128 and 64 dividing F,
else 64). The calls are the 93 convs of one ``openai_64`` bf16 forward
(every (H, W, C, F, k, stride) with its count, found by hooks on the meta
device) at model batch 16 and 128, each with and without the bias. Every
output must be equal bit for bit between the two builds: the line "bits: N
results differ" counts those that are not, and the tool exits 1 if N > 0.
Times are taken in turns (other, this, this, other), the smaller of each
build's two turns kept, each three ways with chip_smoke.py's timers: a CUDA
graph of 10 calls replayed (median of 3) and torch.profiler's device time
over 10 calls (device time), and CUDA events around 10 back-to-back calls
(median of 3; host-timed, the launch cost included). Prints each shape
with its plan and TFLOP/s, then the sums over the forward's calls beside
the bound (bytes once over 3.35 TB/s or operations over 989 TFLOP/s, the
larger).

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
    bf16_conv_bound_ms, conv_calls, conv_inputs, graph_ms, model_config, profiled_ms, time_ms)
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import conv as kc  # noqa: E402

SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "bf16conv.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(root, out_dir, tag):
    """The tree's bf16 conv library and whether its interface takes a grid
    cap and a loading way (this design)."""
    src = os.path.join(root, SOURCE)
    lib, _ = nvcc(src, os.path.join(out_dir, f"libbf16conv_{tag}.so"))
    with open(src) as f:
        persistent = "int max_blocks, int staging" in f.read()
    lib.nd_bf16_conv.argtypes = [_P, _P, _P, _P, *[_I] * (11 if persistent else 9), _P]
    lib.nd_bf16_conv.restype = _I
    return lib, persistent


def older_tile(f):
    """The filter tile of the plan before this design: the widest of 192,
    128 and 64 that divides F, else 64."""
    return next((t for t in kc.FILTER_TILES if f % t == 0), 64)


def conv_call(lib, persistent, x, wt, bias, out, stride):
    """The bf16 conv through one build's C interface."""
    b, h, w, c = x.shape
    f, k = wt.shape[0], wt.shape[1]
    route, tile = kc.conv_nhwc_plan(h, w, k, stride, f)
    head = (x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, h, w, c, f, k, stride, kc.ROUTES.index(route))
    stream = torch.cuda.current_stream().cuda_stream
    err = (lib.nd_bf16_conv(*head, tile, 0, 0, stream) if persistent
           else lib.nd_bf16_conv(*head, older_tile(f), stream))
    if err:
        raise RuntimeError(f"bf16 conv launch failed: {err} at {(b, h, w, c)} -> {f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its bf16 conv is built)")
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 128],
                        help="model batches (16: the timed forward; 128: serve batch 64 "
                             "under CFG)")
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
    meta = torch.device("meta")
    calls = conv_calls(DiffusionModel(**model_config(), kernels=False, device=meta).eval(), meta)
    print(f"{torch.cuda.get_device_name(0)}; other: {roots['other']} "
          f"({'persistent' if libs['other'][1] else 'older'} interface)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    differ = results = 0
    for b in args.batches:
        sums, bound, ops_total = {}, 0.0, 0
        for (h, w, c, f, k, stride), per in sorted(calls.items()):
            x, weight, bias32 = conv_inputs(gen, dev, b, h, w, c, f, k)
            wt = weight.permute(0, 2, 3, 1).contiguous().bfloat16()
            bias = bias32.bfloat16()
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            same = True
            for with_bias in (bias, None):
                outs = {}
                for tag in roots:
                    outs[tag] = torch.full((b, ho, wo, f), float("nan"), dtype=torch.bfloat16,
                                           device=dev)
                    conv_call(*libs[tag], x, wt, with_bias, outs[tag], stride)
                torch.cuda.synchronize()
                results += 1
                if not torch.equal(outs["this"].view(torch.int16),
                                   outs["other"].view(torch.int16)):
                    differ += 1
                    same = False
            out = torch.empty((b, ho, wo, f), dtype=torch.bfloat16, device=dev)
            fns = {tag: (lambda tag=tag: conv_call(*libs[tag], x, wt, bias, out, stride))
                   for tag in roots}
            best = in_turns(fns, {"graph": graph_ms, "profiler": profiled_ms,
                                  "host": lambda fn: time_ms(fn, iters=10, rounds=3)})
            ops = 2 * b * ho * wo * f * k * k * c
            ops_total += per * ops
            bound += per * max(bf16_conv_bound_ms(b, h, w, c, f, k, stride))
            for key, ms in best.items():
                sums[key] = sums.get(key, 0.0) + per * ms
            route, tile = kc.conv_nhwc_plan(h, w, k, stride, f)
            print(f"bf16 conv ({b}, {h}, {w}, {c}) -> {f}, {k}x{k}, stride {stride}, {per} per "
                  f"forward, plan {route} route, {tile} filters a unit "
                  f"({kc.conv_nhwc_units(b, h, w, k, stride, f, tile)} units; other "
                  f"{older_tile(f) if not libs['other'][1] else tile}): " + "; ".join(
                      f"{tag} {best[tag, 'graph']:.4f} ms by graph "
                      f"({ops / best[tag, 'graph'] / 1e9:.1f} TFLOP/s), "
                      f"{best[tag, 'profiler']:.4f} by profiler, {best[tag, 'host']:.4f} host-timed"
                      for tag in roots)
                  + f"; bits {'equal' if same else 'DIFFER'} with and without the bias",
                  flush=True)
            del x, out
        print(f"bf16 conv sum over the {sum(calls.values())} convs of one openai_64 forward at "
              f"model batch {b}: " + "; ".join(
                  f"{tag} {sums[tag, 'graph']:.4f} ms by graph "
                  f"({ops_total / sums[tag, 'graph'] / 1e9:.1f} TFLOP/s), "
                  f"{sums[tag, 'profiler']:.4f} by profiler, {sums[tag, 'host']:.4f} host-timed"
                  for tag in roots)
              + f"; bound {bound:.4f} ms; this at {bound / sums['this', 'graph']:.3f} of the "
              f"bound by graph; this / other {sums['this', 'graph'] / sums['other', 'graph']:.4f} "
              f"by graph, {sums['this', 'profiler'] / sums['other', 'profiler']:.4f} by profiler",
              flush=True)
    print(f"bits: {differ} results differ (of {results}: {len(calls)} shapes x "
          f"{len(args.batches)} batches x with and without the bias)", flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
