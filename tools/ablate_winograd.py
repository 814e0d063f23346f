"""Where the Winograd conv spends its time, on one NVIDIA card.

    python tools/ablate_winograd.py [--batch 128]

Builds ``nicediffusion_tpu_torch/csrc/winograd.cu`` with the package's nvcc
flags once as it is and once for each variant below, each made by replacing
a line of the source with one that leaves a part of the main loop out (the
pixel loads, the transform, U's staging, both stagings, the products, the
epilogue's stores). A variant computes wrong sums: it is a diagnostic of
where the kernel's time goes, never the port's path. A replacement that no
longer matches the source fails the tool. Each build is called through its
C interface on chip_smoke.py's ``[winograd]`` inputs at the stride-1 3x3
shapes of an ``openai_64`` forward named below, at the given model batch
(and at 16 for the first), and timed as a CUDA graph of 5 calls replayed
(chip_smoke.py's ``graph_ms``). Prints each build's ptxas line and its time
beside the full build's and the bound per shape. Builds land in the
package's git-ignored ``_build/ablate_winograd/``.

Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import graph_ms, winograd_bound_ms, winograd_inputs  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402

_LOADS = "  if (!((t.rows >> j) & (t.cols >> k) & 1u) || c >= a.c) return zero;"
_TRANSFORM = "      transform(nx, a, tile, (s + 1) * kStepC + 8 * q, off);\n"
_U = "      stage_u(nx + kV, a, f0, s + 1, tid);\n"
_PRODUCT = ("        sm90::wgmma_ss_m64n16k16_bf16(acc[p], "
            "sm90::sw64_desc(vb + p * kVPos + kk * 32),\n"
            "                                      "
            "sm90::sw64_desc(ub + p * kUPos + kk * 32), 1);")
_STORE = "          if (yy >= a.h || xx >= a.w) continue;"
# variant -> (source line, its replacement) pairs
VARIANTS = {
    "full": [],
    "no pixel loads": [(_LOADS, "  if (true) return zero;")],
    "no transform": [(_TRANSFORM, "")],
    "no U staging": [(_U, "")],
    "no staging": [(_U, ""), (_TRANSFORM, "")],
    "no products": [(_PRODUCT, "        { if (vb == 7u) acc[p][0] += 1.f; }")],
    "no stores": [(_STORE, "          if (yy >= 0) continue;")],
}
# (H, W, C, F) of openai_64's Winograd convs: the most frequent at each map size
SHAPES = ((64, 64, 192, 192), (32, 32, 384, 384), (16, 16, 576, 576), (8, 8, 768, 768))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name, subs, out_dir):
    """The library of one variant, and ptxas's register line for it."""
    src = (_build.CSRC / "winograd.cu").read_text()
    for line, replacement in subs:
        if src.count(line) != 1:
            raise SystemExit(f"{name}: the line to replace is not in csrc/winograd.cu once:"
                             f"\n{line}")
        src = src.replace(line, replacement)
    stem = name.replace(" ", "_")
    path = os.path.join(out_dir, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{stem}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = next((line.split(":", 1)[1].strip() for line in proc.stderr.splitlines()
                 if "registers" in line), "")
    spills = next((line.strip() for line in proc.stderr.splitlines() if "spill" in line), "")
    lib = ctypes.CDLL(lib)
    lib.nd_winograd_conv.argtypes = [_P, _P, _P, _P, *[_I] * 5, _P]
    lib.nd_winograd_conv.restype = _I
    return lib, f"{regs}; {spills}"


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
    print(f"[ablate] {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
