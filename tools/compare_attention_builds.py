"""bf16 K1, K5 and K2 of two builds of the attention kernels on one NVIDIA card.

    python tools/compare_attention_builds.py --against <dir>

``<dir>`` is the root of another checkout of this repository, for instance
an earlier commit unpacked with ``git archive <commit> | tar -x -C <dir>``.
The tool builds ``nicediffusion_tpu_torch/csrc/attention.cu`` (K1 and K5)
and ``attention_bwd.cu`` (K2) of both trees with the package's nvcc flags
(one nvcc each, all side by side) and loads the libraries through their C
interfaces. Times are taken in turns (other, this, this, other), each two
ways with chip_smoke.py's timers, the smaller of the two turns kept: CUDA
events around 20 back-to-back calls (host-timed), and a CUDA graph of 20
calls replayed (device time, free of the host's launch cost).

  * K1 on the fused projection and K5 on its strided views at every bf16
    attention shape of the port's main paths (the openai_64 and openai_128
    UNets and the openai_128 classifier); for this tree also K1 writing the
    row log-sum-exp that K2 takes. Sums over one forward of each path.
  * K2 at the bf16 attention shapes of one openai_64 and one openai_128
    training step and of one guidance gradient through the classifier. A
    build whose K2 takes the log-sum-exp (``nd_fused_qkv_attention_bwd_lse``)
    is handed its own K1's, as the autograd Function does; an earlier build
    (``nd_fused_qkv_attention_bwd``) makes it itself. The two results are
    held to each other within K2's bf16 gates (per element and relative).
    Sums over one step or gradient.

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

from chip_smoke import (  # noqa: E402
    K2_BF16_REL, K2_BF16_TOL, graph_ms, k2_rel_err, time_ms, within)
from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import attention as k1  # noqa: E402

CSRC = os.path.join("nicediffusion_tpu_torch", "csrc")
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
# (batch, N, C, heads, calls per step, path): the bf16 attention backward
# calls of one training step (one per attention call of its forward) or of
# one guidance gradient
K2_SHAPES = (
    (8, 1024, 384, 6, 7, "openai_64 training step, batch 8"),
    (8, 256, 576, 9, 7, "openai_64 training step, batch 8"),
    (8, 64, 768, 12, 8, "openai_64 training step, batch 8"),
    (4, 1024, 512, 4, 5, "openai_128 training step, batch 4"),
    (4, 256, 768, 4, 5, "openai_128 training step, batch 4"),
    (4, 64, 1024, 4, 6, "openai_128 training step, batch 4"),
    (4, 1024, 256, 4, 2, "classifier guidance gradient, batch 4"),
    (4, 256, 384, 6, 2, "classifier guidance gradient, batch 4"),
    (4, 64, 512, 8, 3, "classifier guidance gradient, batch 4"),
    (4, 65, 512, 8, 1, "classifier guidance gradient, batch 4"),
)
_STRIDES = ctypes.c_longlong * 3
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(root, out_dir, tag, name):
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(root, CSRC, f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {root}:\n{proc.stderr}")
    lib = ctypes.CDLL(lib)
    if name == "attention":
        lib.nd_mha_attention.argtypes = [
            *[_P] * 4, *[_I] * 4, *[ctypes.POINTER(ctypes.c_longlong)] * 3, _I, _F, _P]
        if hasattr(lib, "nd_fused_qkv_attention_lse"):
            lib.nd_fused_qkv_attention_lse.argtypes = [_P, _P, _P, *[_I] * 6, _F, _P]
        else:
            lib.nd_fused_qkv_attention.argtypes = [_P, _P, *[_I] * 6, _F, _P]
    elif hasattr(lib, "nd_fused_qkv_attention_bwd_lse"):
        lib.nd_fused_qkv_attention_bwd_lse.argtypes = [*[_P] * 6, *[_I] * 6, _F, _P]
    else:
        lib.nd_fused_qkv_attention_bwd.argtypes = [*[_P] * 6, *[_I] * 6, _F, _P]
    return lib


def k1_call(lib, qkv, heads, out, lse=None):
    """K1 through the build's own C interface: a build that can write the
    log-sum-exp (``nd_fused_qkv_attention_lse``) writes it into ``lse``, or
    none when ``lse`` is None; an earlier build (``nd_fused_qkv_attention``)
    takes no ``lse``."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    common = (b, n, c, heads, 1, 1, (c // heads) ** -0.5, torch.cuda.current_stream().cuda_stream)
    if hasattr(lib, "nd_fused_qkv_attention_lse"):
        err = lib.nd_fused_qkv_attention_lse(qkv.data_ptr(), out.data_ptr(),
                                             None if lse is None else lse.data_ptr(), *common)
    elif lse is None:
        err = lib.nd_fused_qkv_attention(qkv.data_ptr(), out.data_ptr(), *common)
    else:
        raise ValueError("this build of K1 writes no log-sum-exp")
    if err:
        raise RuntimeError(f"K1 launch failed: {err}")


def k2_call(lib, qkv, g, o, lse, dqkv, scratch):
    """K2 through the build's own C interface: with the log-sum-exp handed
    over where it takes one, else with its own (``lse`` is then scratch)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    heads = lse.shape[1]
    common = (b, n, c, heads, 1, 1, (c // heads) ** -0.5, torch.cuda.current_stream().cuda_stream)
    if hasattr(lib, "nd_fused_qkv_attention_bwd_lse"):
        err = lib.nd_fused_qkv_attention_bwd_lse(qkv.data_ptr(), g.data_ptr(), o.data_ptr(),
                                                 lse.data_ptr(), dqkv.data_ptr(),
                                                 scratch.data_ptr(), *common)
    else:
        err = lib.nd_fused_qkv_attention_bwd(qkv.data_ptr(), g.data_ptr(), o.data_ptr(),
                                             dqkv.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                                             *common)
    if err:
        raise RuntimeError(f"K2 launch failed: {err}")


def k5_call(lib, q, k, v, out):
    b, h, n, d = q.shape
    err = lib.nd_mha_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               b, h, n, d, _STRIDES(*q.stride()[:3]), _STRIDES(*k.stride()[:3]),
                               _STRIDES(*v.stride()[:3]), 1, d ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 launch failed: {err}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="root of the other checkout (its attention kernels are built)")
    parser.add_argument("--build_dir", default=os.path.join(_build.BUILD_DIR, "compare"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.build_dir, exist_ok=True)
    roots = {"other": args.against, "this": os.path.dirname(_build.CSRC.parent)}
    jobs = [(tag, name) for tag in roots for name in ("attention", "attention_bwd")]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda job: build(roots[job[0]], args.build_dir, *job), jobs)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timers = (("events", time_ms), ("graph", lambda fn: graph_ms(fn, iters=20, rounds=5)))

    def best_of_turns(calls):
        """calls: {(tag, what): fn} -> {(tag, what, how): ms}, the smaller of
        the two turns of each tree."""
        best = {}
        for turn in ("other", "this", "this", "other"):
            for (tag, what), fn in calls.items():
                if tag != turn:
                    continue
                for how, timer in timers:
                    key = (tag, what, how)
                    best[key] = min(best.get(key, float("inf")), timer(fn))
        return best

    def fmt(best, tag, what):
        return f"{best[tag, what, 'events']:.4f} ms (graph {best[tag, what, 'graph']:.4f})"

    sums = {}
    for b, n, c, heads, per, path in SHAPES:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).bfloat16()
        out = torch.empty(b, n, c, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(b, heads, n, device=dev)
        views = k1.split_qkv(qkv, heads, True)
        out5 = torch.empty(views[0].shape, dtype=torch.bfloat16, device=dev)
        calls = {}
        for tag in roots:
            lib = libs[tag, "attention"]
            calls[tag, "K1"] = lambda lib=lib: k1_call(lib, qkv, heads, out)
            calls[tag, "K5"] = lambda lib=lib: k5_call(lib, *views, out5)
        calls["this", "K1+lse"] = lambda: k1_call(libs["this", "attention"], qkv, heads, out,
                                                  lse)
        best = best_of_turns(calls)
        for key, ms in best.items():
            sums[(path,) + key] = sums.get((path,) + key, 0.0) + per * ms
        print(f"qkv ({b}, {n}, {3 * c}), {heads} heads of {c // heads}, {per} per forward of "
              f"{path}: " + "; ".join(f"{tag} {what} {fmt(best, tag, what)}"
                                      for tag, what in calls), flush=True)
    for path in dict.fromkeys(s[-1] for s in SHAPES):
        print(f"sum over one forward of {path}: " + "; ".join(
            f"{tag} {what} {sums[path, tag, what, 'events']:.4f} ms (graph "
            f"{sums[path, tag, what, 'graph']:.4f})"
            for tag, what in (("other", "K1"), ("this", "K1"), ("this", "K1+lse"),
                              ("other", "K5"), ("this", "K5"))), flush=True)

    sums = {}
    for b, n, c, heads, per, path in K2_SHAPES:
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=dev).bfloat16()
        g = (2 * torch.rand(b, n, c, generator=gen, device=dev) - 1).bfloat16()
        o = torch.empty(b, n, c, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(b, heads, n, device=dev)
        k1_call(libs["this", "attention"], qkv, heads, o, lse)
        dqkv = {tag: torch.empty_like(qkv) for tag in roots}
        scratch = {tag: torch.empty(2, b, heads, n, device=dev) for tag in roots}
        calls = {}
        for tag in roots:
            lib = libs[tag, "attention_bwd"]
            handed = hasattr(lib, "nd_fused_qkv_attention_bwd_lse")
            calls[tag, "K2"] = lambda lib=lib, tag=tag, handed=handed: k2_call(
                lib, qkv, g, o, lse if handed else scratch[tag][1], dqkv[tag], scratch[tag][0])
        best = best_of_turns(calls)
        torch.cuda.synchronize()
        gap = (dqkv["this"].float() - dqkv["other"].float()).abs().max().item()
        rel = k2_rel_err(dqkv["this"], dqkv["other"], heads, True)
        if not within(dqkv["this"], dqkv["other"], K2_BF16_TOL) or rel > K2_BF16_REL:
            raise SystemExit(f"K2 of the two trees differ by {gap:.3g} (relative {rel:.3g}) at "
                             f"qkv {tuple(qkv.shape)}")
        for key, ms in best.items():
            sums[(path,) + key] = sums.get((path,) + key, 0.0) + per * ms
        print(f"K2 qkv ({b}, {n}, {3 * c}), {heads} heads of {c // heads}, {per} per "
              f"{path}: other {fmt(best, 'other', 'K2')}; this {fmt(best, 'this', 'K2')}; the "
              f"two differ by at most {gap:.3g}, relative {rel:.3g}", flush=True)
    for path in dict.fromkeys(s[-1] for s in K2_SHAPES):
        print(f"K2 sum over one {path}: " + "; ".join(
            f"{tag} {sums[path, tag, 'K2', 'events']:.4f} ms (graph "
            f"{sums[path, tag, 'K2', 'graph']:.4f})" for tag in ("other", "this")), flush=True)


if __name__ == "__main__":
    main()
