"""The Winograd conv of two builds on one NVIDIA card: bits and times.

    python tools/compare_winograd_builds.py --against <dir> [--batches 16 128] [--repeat N]

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/winograd.cu`` of both trees
with the package's nvcc flags (side by side) and calls each through its C
interface (``nd_winograd_conv``, the same in every build) on the same bf16 x,
U and f32 bias (chip_smoke.py's ``winograd_inputs``). The calls are the
Winograd convs of one ``openai_64`` forward (every (H, W, C, F) with its
count, found by hooks on the meta device) at each model batch, and the EMNIST
model's at the first, each with and without the bias. The other build runs
once a case; this build ``--repeat`` times, each output against the other's
bit for bit (a new barrier or producer can pass one call and fail the next):
the line "bits: N results differ" counts the outputs that are not equal, and
the tool exits 1 if N > 0. Times (openai_64's convs only) are taken in turns
(other, this, this, other), the smaller of each build's two turns kept, each
three ways with chip_smoke.py's timers: a CUDA graph of 10 calls replayed
(median of 3), torch.profiler's device time over 10 calls, and CUDA events
around 10 back-to-back calls (median of 3; host-timed, the launch cost
included). Prints each shape with this build's plan and TFLOP/s, then the
sums over the forward's calls beside the bound (bytes once over 3.35 TB/s or
operations over 989 TFLOP/s, the larger) and the card's name and power limit.

Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from _builds import card, in_turns, nvcc, ptxas_lines  # noqa: E402
from chip_smoke import (  # noqa: E402
    graph_ms, model_config, profiled_ms, time_ms, winograd_bound_ms, winograd_calls,
    winograd_inputs)
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import winograd as kw  # noqa: E402

SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "winograd.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(root, out_dir, tag):
    """The tree's Winograd conv library and ptxas's register and spill
    lines for its kernels."""
    lib, log = nvcc(os.path.join(root, SOURCE), os.path.join(out_dir, f"libwinograd_{tag}.so"))
    lib.nd_winograd_conv.argtypes = [_P, _P, _P, _P, *[_I] * 5, _P]
    lib.nd_winograd_conv.restype = _I
    return lib, ptxas_lines(log)


def call(lib, x, u, bias, out):
    """The Winograd conv through one build's C interface, on the current
    stream (a CUDA graph captures on its own)."""
    b, h, w, c = x.shape
    f = u.shape[1]
    err = lib.nd_winograd_conv(x.data_ptr(), u.data_ptr(),
                               None if bias is None else bias.data_ptr(), out.data_ptr(), b, h, w,
                               c, f, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"Winograd conv launch failed: {err} at {(b, h, w, c)} -> {f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its Winograd conv is built)")
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 128],
                        help="model batches (16: a sampling forward; 128: serve batch 64 "
                             "under CFG)")
    parser.add_argument("--repeat", type=int, default=1,
                        help="calls of this build a case, each held to the other's bits")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "compare"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    roots = {"other": args.against, "this": os.path.dirname(_build.CSRC.parent)}
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:
        libs = dict(zip(roots, pool.map(lambda tag: build(roots[tag], args.build_dir, tag),
                                        roots)))
    for tag, (_, ptxas) in libs.items():
        print(f"{tag} ptxas: {' | '.join(ptxas)}", flush=True)
    dev = torch.device("cuda")
    meta = torch.device("meta")
    calls = winograd_calls(DiffusionModel(**model_config(), winograd=True, kernels=False,
                                          device=meta).eval(), meta)
    emnist = winograd_calls(DiffusionModel(**model_config("EMNIST"), winograd=True,
                                           kernels=False, device=meta).eval(), meta)
    print(f"{card()}; other: {roots['other']}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    differ = results = 0
    cases = [(b, shape, n, True) for b in args.batches for shape, n in sorted(calls.items())]
    cases += [(args.batches[0], shape, n, False) for shape, n in sorted(emnist.items())]
    sums, bound, ops_total = {}, {}, {}
    for b, (h, w, c, f), per, timed in cases:
        x, _, u, bias = winograd_inputs(gen, dev, b, h, w, c, f)
        outs = {tag: torch.empty((b, h, w, f), dtype=torch.bfloat16, device=dev) for tag in roots}
        bad = 0
        for with_bias in (bias, None):
            outs["other"].fill_(float("nan"))
            call(libs["other"][0], x, u, with_bias, outs["other"])
            for _ in range(args.repeat):
                outs["this"].fill_(float("nan"))
                call(libs["this"][0], x, u, with_bias, outs["this"])
                same = torch.equal(outs["this"].view(torch.int16), outs["other"].view(torch.int16))
                results += 1
                differ += not same
                bad += not same
        plan = kw.winograd_conv_plan(h, w, c, f)
        line = (f"Winograd conv ({b}, {h}, {w}, {c}) -> {f}, {per} per forward, plan: "
                f"{plan['filters']} filters x {plan['tiles']} tiles a unit, cluster of "
                f"{plan['cluster']}, {kw.winograd_conv_units(b, h, w, c, f)} blocks; bits: "
                f"{bad} of {2 * args.repeat} differ")
        if timed:
            out = outs["this"]
            fns = {tag: (lambda tag=tag: call(libs[tag][0], x, u, bias, out)) for tag in roots}
            best = in_turns(fns, {"graph": graph_ms, "profiler": profiled_ms,
                                  "host": lambda fn: time_ms(fn, iters=10, rounds=3)})
            ops = 2 * 16 * b * -(-h // 2) * -(-w // 2) * c * f
            ops_total[b] = ops_total.get(b, 0) + per * ops
            bound[b] = bound.get(b, 0.0) + per * max(winograd_bound_ms(b, h, w, c, f))
            for (tag, how), ms in best.items():
                sums[b, tag, how] = sums.get((b, tag, how), 0.0) + per * ms
            line += "; " + "; ".join(
                f"{tag} {best[tag, 'graph']:.4f} ms by graph "
                f"({ops / best[tag, 'graph'] / 1e9:.1f} TFLOP/s), {best[tag, 'profiler']:.4f} by "
                f"profiler, {best[tag, 'host']:.4f} host-timed" for tag in roots)
        print(line, flush=True)
        del x, u, outs
    for b in bound:
        print(f"Winograd conv sum over the {sum(calls.values())} Winograd convs of one openai_64 "
              f"forward at model batch {b}: " + "; ".join(
                  f"{tag} {sums[b, tag, 'graph']:.4f} ms by graph "
                  f"({ops_total[b] / sums[b, tag, 'graph'] / 1e9:.1f} TFLOP/s), "
                  f"{sums[b, tag, 'profiler']:.4f} by profiler, {sums[b, tag, 'host']:.4f} "
                  "host-timed" for tag in roots)
              + f"; bound {bound[b]:.4f} ms; this at {bound[b] / sums[b, 'this', 'graph']:.3f} of "
              f"the bound by graph; this / other "
              f"{sums[b, 'this', 'graph'] / sums[b, 'other', 'graph']:.4f} by graph, "
              f"{sums[b, 'this', 'profiler'] / sums[b, 'other', 'profiler']:.4f} by profiler",
              flush=True)
    print(f"bits: {differ} results differ (of {results}: {len(cases)} (shape, batch) cases x "
          f"with and without the bias x {args.repeat} calls of this build)",
          flush=True)
    print(card(), flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
