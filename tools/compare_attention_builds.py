"""bf16 K1 and K5 of two builds of csrc/attention.cu on one NVIDIA card.

    python tools/compare_attention_builds.py --against <dir>

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/attention.cu`` of both trees
with the package's nvcc flags (one nvcc each, side by side), loads both
libraries through their C interface (which both builds share), and at every
bf16 attention shape of the port's main paths (the openai_64 and openai_128
UNets and the openai_128 classifier) times K1 on the fused projection and
K5 on its strided views, in turns (other, this, this, other). Each time is
taken two ways, the smaller of the two turns kept: CUDA events around 20
back-to-back calls (as chip_smoke.py times), and a CUDA graph of 20 calls
replayed (device time, free of the host's launch cost). Then the sums over
one forward of each path. Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import attention as k1  # noqa: E402

SOURCE = os.path.join("nicediffusion_tpu_torch", "csrc", "attention.cu")
# (batch, N, C, heads, calls per forward, path): the bf16 attention calls of
# one forward of each main path (chip_smoke.py finds the same by hooks)
SHAPES = (
    (16, 1024, 384, 6, 7, "openai_64, model batch 16"),
    (16, 256, 576, 9, 7, "openai_64, model batch 16"),
    (16, 64, 768, 12, 8, "openai_64, model batch 16"),
    (8, 1024, 384, 6, 7, "openai_64, batch 8"),
    (8, 256, 576, 9, 7, "openai_64, batch 8"),
    (8, 64, 768, 12, 8, "openai_64, batch 8"),
    (4, 1024, 512, 4, 5, "openai_128, batch 4"),
    (4, 256, 768, 4, 5, "openai_128, batch 4"),
    (4, 64, 1024, 4, 6, "openai_128, batch 4"),
    (4, 1024, 256, 4, 2, "classifier, batch 4"),
    (4, 256, 384, 6, 2, "classifier, batch 4"),
    (4, 64, 512, 8, 3, "classifier, batch 4"),
    (4, 65, 512, 8, 1, "classifier, batch 4"),
)
_STRIDES = ctypes.c_longlong * 3


def build(root, out_dir, tag):
    lib = os.path.join(out_dir, f"libattention_{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(root, SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {root}:\n{proc.stderr}")
    lib = ctypes.CDLL(lib)
    lib.nd_fused_qkv_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 6, ctypes.c_float, ctypes.c_void_p]
    lib.nd_mha_attention.argtypes = [
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 4,
        *[ctypes.POINTER(ctypes.c_longlong)] * 3, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return lib


def k1_call(lib, qkv, heads, out):
    b, n, c3 = qkv.shape
    c = c3 // 3
    err = lib.nd_fused_qkv_attention(qkv.data_ptr(), out.data_ptr(), b, n, c, heads, 1, 1,
                                     (c // heads) ** -0.5,
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: {err}")


def k5_call(lib, q, k, v, out):
    b, h, n, d = q.shape
    err = lib.nd_mha_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               b, h, n, d, _STRIDES(*q.stride()[:3]), _STRIDES(*k.stride()[:3]),
                               _STRIDES(*v.stride()[:3]), 1, d ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 launch failed: {err}")


def events_ms(fn, iters=20, rounds=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters=20, rounds=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its attention.cu is built)")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "compare"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    roots = {"other": args.against, "this": os.path.dirname(_build.CSRC.parent)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(roots, pool.map(lambda tag: build(roots[tag], args.build_dir, tag),
                                        roots)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {}
    for b, n, c, heads, per, path in SHAPES:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).bfloat16()
        out = torch.empty(b, n, c, dtype=torch.bfloat16, device=dev)
        views = k1.split_qkv(qkv, heads, True)
        out5 = torch.empty(views[0].shape, dtype=torch.bfloat16, device=dev)
        best = {}
        for tag in ("other", "this", "this", "other"):
            lib = libs[tag]
            calls = {"K1": lambda: k1_call(lib, qkv, heads, out),
                     "K5": lambda: k5_call(lib, *views, out5)}
            for kernel, fn in calls.items():
                for how, timer in (("events", events_ms), ("graph", graph_ms)):
                    key = (tag, kernel, how)
                    best[key] = min(best.get(key, float("inf")), timer(fn))
        for key, ms in best.items():
            sums[(path,) + key] = sums.get((path,) + key, 0.0) + per * ms
        print(f"qkv ({b}, {n}, {3 * c}), {heads} heads of {c // heads}, {per} per forward of "
              f"{path}: " + "; ".join(
                  f"{tag} {kernel} {best[tag, kernel, 'events']:.4f} ms (graph "
                  f"{best[tag, kernel, 'graph']:.4f})"
                  for tag in ("other", "this") for kernel in ("K1", "K5")), flush=True)
    for path in dict.fromkeys(s[-1] for s in SHAPES):
        print(f"sum over one forward of {path}: " + "; ".join(
            f"{tag} {kernel} {sums[path, tag, kernel, 'events']:.4f} ms (graph "
            f"{sums[path, tag, kernel, 'graph']:.4f})"
            for tag in ("other", "this") for kernel in ("K1", "K5")), flush=True)


if __name__ == "__main__":
    main()
