"""Where the int8 conv's halo route spends its time, on one NVIDIA card.

    python tools/ablate_int8conv.py [--batch 128]

Builds ``nicediffusion_tpu_torch/csrc/int8conv.cu`` several times with the
package's nvcc flags, once as it is and once for each ``INT8CONV_SKIP_*``
macro, each of which leaves one part of the halo route's main loop out: the
raw halo staging (``RAW``), the weight slab staging (``SLABS``), the
quantize tasks (``QUANTIZE``), the block barrier (``BARRIER``), the wgmma
products (``PRODUCTS``), and the three staging parts together. A build
without a part computes wrong sums: it is a diagnostic of where the loop's
time goes, never the port's path (the package never defines the macros).
Each build is called through its C interface, bf16 x and out, at the
stride-1 3x3 shapes of an ``openai_64`` forward named below at the given
model batch, on chip_smoke.py's ``[int8]`` inputs, and timed as a CUDA graph
of 5 calls replayed (chip_smoke.py's ``graph_ms``, the smaller of two
readings). Prints each build's time, TOPS and share of the full build's
time per shape.

Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from _builds import nvcc  # noqa: E402
from chip_smoke import graph_ms, int8_inputs  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import int8conv as k8  # noqa: E402

VARIANTS = ("", "RAW", "SLABS", "QUANTIZE", "BARRIER", "PRODUCTS", "RAW,SLABS,QUANTIZE")
# (H, W, C, F) of openai_64's stride-1 3x3 int8 convs: the deepest, the most
# frequent at each map size
SHAPES = ((16, 16, 1344, 576), (64, 64, 192, 192), (32, 32, 384, 384), (8, 8, 768, 768))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(variant, out_dir):
    """The library built with the variant's macros."""
    flags = [f"-DINT8CONV_SKIP_{part}" for part in variant.split(",") if part]
    lib, _ = nvcc(_build.CSRC / "int8conv.cu",
                  os.path.join(out_dir, f"libint8conv_skip_{variant.replace(',', '_') or 'none'}.so"),
                  *flags)
    lib.nd_int8_conv.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _P, *[_I] * 10, _P]
    lib.nd_int8_conv.restype = _I
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128, help="model batch")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "ablate"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda v: build(v, args.build_dir), VARIANTS)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b = args.batch
    for h, w, c, f in SHAPES:
        x, kq, inv_act, deq, bias = int8_inputs(gen, dev, b, h, w, c, f, 3, torch.bfloat16)
        out = torch.empty(b, h, w, f, dtype=torch.bfloat16, device=dev)
        route, tile, step = k8.int8_conv_plan(b, h, w, c, f, 3, 1, torch.bfloat16)

        def call(lib):
            err = lib.nd_int8_conv(x.data_ptr(), 1, inv_act.data_ptr(), kq.data_ptr(),
                                   deq.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, None, b,
                                   h, w, c, f, 3, 1, k8.ROUTES.index(route), tile, step,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"int8 conv launch failed: {err}")

        ops = 2 * b * h * w * f * 9 * c
        ms = {v: min(graph_ms(lambda: call(libs[v]), iters=5) for _ in range(2))
              for v in VARIANTS}
        print(f"int8 conv ({b}, {h}, {w}, {c}) -> {f}, 3x3, {route} route, {tile} filters: "
              + "; ".join(f"{'without ' + v.lower().replace(',', ', ') if v else 'full'} "
                          f"{ms[v]:.4f} ms ({ops / ms[v] / 1e9:.0f} TOPS, "
                          f"{ms[v] / ms['']:.3f} of full)" for v in VARIANTS), flush=True)


if __name__ == "__main__":
    main()
