"""The int8 conv of two builds on one NVIDIA card.

    python tools/compare_int8conv_builds.py --against <dir>

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/int8conv.cu`` of both trees
with the package's nvcc flags (side by side) and calls each through its own
C interface: a build whose ``nd_int8_conv`` takes an int8 scratch for x
(one launch quantizes x into it, a second convolves) is given one; this
tree's takes the route and tiles of ``int8_conv_plan``. The calls are the 91
int8 convs of one ``openai_64`` int8 forward (every (H, W, C, F, k, stride)
with its count, found by hooks on the meta device), bf16 x and out, at model
batch 16 and 128 (``--batches``), on chip_smoke.py's ``[int8]`` inputs.
Times are taken in turns (other, this, this, other), the smaller of the two
turns kept, each two ways with chip_smoke.py's timers: CUDA events around 5
back-to-back calls (host-timed) and a CUDA graph of 5 calls replayed (device
time; the older build's quantize launch inside it). The two builds' s32 sums
must be equal at every shape. Prints each shape with its TOPS and the sums
over the forward's calls beside the bound.

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
    graph_ms, int8_bound_ms, int8_conv_calls, int8_inputs, model_config, time_ms)
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import int8conv as k8  # noqa: E402

SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "int8conv.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(root, out_dir, tag):
    """The tree's int8 conv library and whether its interface takes the route
    and tiles (else it takes an int8 scratch for x)."""
    src = os.path.join(root, SOURCE)
    lib, _ = nvcc(src, os.path.join(out_dir, f"libint8conv_{tag}.so"))
    with open(src) as f:
        planned = "int route, int filter_tile" in f.read()
    lib.nd_int8_conv.argtypes = ([_P, _I, _P, _P, _P, _P, _P, _I, _P, *[_I] * 10, _P] if planned
                                 else [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, *[_I] * 7, _P])
    lib.nd_int8_conv.restype = _I
    return lib, planned


def conv_call(lib, planned, args, stride, out, sums, xq):
    """The bf16 int8 conv through one build's C interface, raw sums beside."""
    x, kq, inv_act, deq, bias = args
    b, h, w, c = x.shape
    f, k = kq.shape[0], kq.shape[1]
    common = (deq.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, sums.data_ptr(), b, h, w, c, f,
              k, stride)
    stream = torch.cuda.current_stream().cuda_stream
    if planned:
        route, tile, step = k8.int8_conv_plan(b, h, w, c, f, k, stride, x.dtype)
        err = lib.nd_int8_conv(x.data_ptr(), 1, inv_act.data_ptr(), kq.data_ptr(), *common,
                               k8.ROUTES.index(route), tile, step, stream)
    else:
        err = lib.nd_int8_conv(x.data_ptr(), 1, inv_act.data_ptr(), xq.data_ptr(),
                               kq.data_ptr(), *common, stream)
    if err:
        raise RuntimeError(f"int8 conv launch failed: {err}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its int8 conv is built)")
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
    calls = int8_conv_calls(DiffusionModel(**model_config(), kernels=False, device=meta).eval(),
                            model_config(), meta)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in args.batches:
        sums, bound, ops_total = {}, 0.0, 0
        for (h, w, c, f, k, stride), per in sorted(calls.items()):
            inputs = int8_inputs(gen, dev, b, h, w, c, f, k, torch.bfloat16)
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            outs = {tag: torch.empty(b, ho, wo, f, dtype=torch.bfloat16, device=dev)
                    for tag in roots}
            raws = {tag: torch.empty(b, ho, wo, f, dtype=torch.int32, device=dev)
                    for tag in roots}
            xq = torch.empty(inputs[0].shape, dtype=torch.int8, device=dev)
            fns = {tag: (lambda tag=tag: conv_call(*libs[tag], inputs, stride, outs[tag],
                                                   raws[tag], xq)) for tag in roots}
            best = in_turns(fns, {"events": lambda fn: time_ms(fn, iters=5, rounds=3),
                                  "graph": lambda fn: graph_ms(fn, iters=5)})
            torch.cuda.synchronize()
            if not torch.equal(raws["this"], raws["other"]):
                bad = (raws["this"] != raws["other"]).sum().item()
                raise SystemExit(f"the two builds' s32 sums differ at {bad} elements of "
                                 f"{(b, h, w, c)} -> {f}, {k}x{k}, stride {stride}")
            ops = 2 * b * ho * wo * f * k * k * c
            ops_total += per * ops
            bound += per * max(int8_bound_ms(b, h, w, c, f, k, stride))
            for key, ms in best.items():
                sums[key] = sums.get(key, 0.0) + per * ms
            plan = k8.int8_conv_plan(b, h, w, c, f, k, stride, torch.bfloat16)
            print(f"int8 conv ({b}, {h}, {w}, {c}) -> {f}, {k}x{k}, stride {stride}, {per} per "
                  f"forward, {plan[0]} route, {plan[1]} filters a block: " + "; ".join(
                      f"{tag} {best[tag, 'events']:.4f} ms (graph {best[tag, 'graph']:.4f}, "
                      f"{ops / best[tag, 'graph'] / 1e9:.1f} TOPS)" for tag in roots)
                  + "; s32 sums equal", flush=True)
        print(f"int8 conv sum over the {sum(calls.values())} int8 convs of one openai_64 forward "
              f"at model batch {b}: " + "; ".join(
                  f"{tag} {sums[tag, 'events']:.4f} ms (graph {sums[tag, 'graph']:.4f}, "
                  f"{ops_total / sums[tag, 'graph'] / 1e9:.1f} TOPS)" for tag in roots)
              + f"; bound {bound:.4f} ms; this / other in device time "
              f"{sums['this', 'graph'] / sums['other', 'graph']:.4f}", flush=True)


if __name__ == "__main__":
    main()
