"""Where the Winograd conv spends its time, on one NVIDIA card.

    python tools/ablate_winograd.py [--batch 128]

Builds ``nicediffusion_tpu_torch/csrc/winograd.cu`` with the package's nvcc
flags once as it is and once for each variant below, each made by replacing
lines of the source with ones that leave a part out: in the producer
warpgroup the pixel rows' TMA, V (the transform and its stores), U's TMA,
or all three (the barriers kept); in the consumers the products; in the
epilogue the M trade (each block reads its own shared memory in place of
the other three blocks'), the output transform with its stores, or the
stores alone; and last all but the barriers, the M stores and the
cluster's syncs (the kernel's floor). A variant computes wrong sums: it is a diagnostic of where
the kernel's time goes, never the port's path. A replacement that no longer
matches the source fails the tool. Each build is called through its C
interface on chip_smoke.py's ``[winograd]`` inputs at the stride-1 3x3
shapes of an ``openai_64`` forward named below, at the given model batch
(and at 16 for the first), and timed as a CUDA graph of 5 calls replayed
(chip_smoke.py's ``graph_ms``). Prints each build's ptxas lines and its time
beside the full build's and the bound per shape, and the card. Builds land in
the package's git-ignored ``_build/ablate_winograd/``.

Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import re
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from _builds import card, nvcc, ptxas_lines  # noqa: E402
from chip_smoke import graph_ms, winograd_bound_ms, winograd_inputs  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402

_ROWS = ("    sm90::mbar_arrive_expect_tx(rawb + 8u * slot, (uint32_t)a.box_tx);\n"
         "    sm90::tma_load_4d(ring + (uint32_t)(Ring<FT>::kRing + slot * kRawMax + box * "
         "a.box_bytes),\n"
         "                      &a.map_x, rawb + 8u * slot, n * kStepC, -1, box_y, box_b);\n")
_ROWS_OUT = [(_ROWS, "    sm90::mbar_arrive(rawb + 8u * slot);\n")]
_V = "        store_v(st, off[i], tr);\n      }\n    } else {"
_V_OUT = "        (void)tr;\n      }\n    } else {"
_U = ("    sm90::mbar_arrive_expect_tx(bar, 2 * Ring<FT>::kUPos);\n"
      "    sm90::tma_load_3d(ring + (uint32_t)(slot * Ring<FT>::kStage + kV + wg * 2 * "
      "Ring<FT>::kUPos),\n"
      "                      &a.map_u, bar, n * kStepC, f0, kRowPos * rank + 2 * wg);\n")
_U_OUT = "    sm90::mbar_arrive(bar);\n"
_PRODUCT = ("        wgmma_ss<FT>(acc[pp], sm90::sw64_desc(vb + pp * kVPos + kk * 32),\n"
            "                     sm90::sw64_desc(ub + pp * R::kUPos + kk * 32));")
_NO_PRODUCT = "        { if (vb == 7u) acc[pp][0] += 1.f; }"
_TRADE = "                          16 * (lane % 4)),\n        warp);"
_NO_TRADE = "                          16 * (lane % 4)),\n        rank);"
_EPILOGUE = "    if (dst[it] < 0) continue;"
_NO_EPILOGUE = "    if (dst[it] < 0 || true) continue;"
_STORE = "        if (!((edge[it] >> i) & (edge[it] >> (2 + l)) & 1u)) continue;"
# variant -> (source text, its replacement) pairs
VARIANTS = {
    "full": [],
    "no pixel rows": _ROWS_OUT,
    "no V": [(_V, _V_OUT)],
    "no U": [(_U, _U_OUT)],
    "no producer": [*_ROWS_OUT, (_V, _V_OUT), (_U, _U_OUT)],  # and no loads
    "no products": [(_PRODUCT, _NO_PRODUCT)],
    "no M trade": [(_TRADE, _NO_TRADE)],
    "no output transform": [(_EPILOGUE, _NO_EPILOGUE)],
    "no stores": [(_STORE, "        if (true) continue;")],
    "no producer, products or output transform": [
        *_ROWS_OUT, (_V, _V_OUT), (_U, _U_OUT), (_PRODUCT, _NO_PRODUCT),
        (_EPILOGUE, _NO_EPILOGUE)],
}
# (H, W, C, F) of openai_64's Winograd convs: the most frequent at each map size
SHAPES = ((64, 64, 192, 192), (32, 32, 384, 384), (16, 16, 576, 576), (8, 8, 768, 768))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name, subs, out_dir):
    """The library of one variant, and ptxas's register line for it."""
    src = (_build.CSRC / "winograd.cu").read_text()
    for line, replacement in subs:
        if src.count(line) != 1:
            raise SystemExit(f"{name}: the text to replace is not in csrc/winograd.cu once:"
                             f"\n{line}")
        src = src.replace(line, replacement)
    stem = re.sub(r"\W+", "_", name)
    path = os.path.join(out_dir, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib, log = nvcc(path, os.path.join(out_dir, f"lib{stem}.so"), "-I", str(_build.CSRC))
    lib.nd_winograd_conv.argtypes = [_P, _P, _P, _P, *[_I] * 5, _P]
    lib.nd_winograd_conv.restype = _I
    return lib, " | ".join(ptxas_lines(log))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128, help="model batch")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "ablate_winograd"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/ablate_winograd.py needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv, args.build_dir),
                                            VARIANTS.items())))
    for name, (_, ptxas) in built.items():
        print(f"[ablate] {name}: {ptxas}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for b, (h, w, c, f) in [(args.batch, s) for s in SHAPES] + [(16, SHAPES[0])]:
        x, _, u, bias = winograd_inputs(g, dev, b, h, w, c, f)
        out = torch.empty(b, h, w, f, dtype=torch.bfloat16, device=dev)
        times = {}
        for name, (lib, _) in built.items():
            def call(lib=lib):  # on the current stream: graph_ms captures on its own
                err = lib.nd_winograd_conv(x.data_ptr(), u.data_ptr(), bias.data_ptr(),
                                           out.data_ptr(), b, h, w, c, f,
                                           torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: launch failed with CUDA error {err}")

            times[name] = graph_ms(call, iters=5, rounds=3)
        full = times["full"]
        bound = max(winograd_bound_ms(b, h, w, c, f))
        parts = ", ".join(f"{name} {ms:.4f} ms ({ms / full:.3f})" for name, ms in times.items())
        print(f"[ablate] {(b, h, w, c)} -> {f}: bound {bound:.4f} ms; {parts}", flush=True)
    print(f"[ablate] {card()}")


if __name__ == "__main__":
    main()
