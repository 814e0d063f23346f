"""Repeats the P-resident route of bf16 K1 and K2 against the walk's bits.

    python tools/stress_attention_routes.py [--csrc DIR ...] [--mutate] [--reps N] [--two-streams]

A race between the route's producer and its two consumer warpgroups shows
in some calls only, so one call proves nothing. This tool builds
``attention.cu`` (K1) and ``attention_bwd.cu`` (K2) of each ``--csrc``
directory (default: this tree's ``nicediffusion_tpu_torch/csrc``; another
tree's, to hold an older build to the same runs) with the package's nvcc
flags, one nvcc each, all side by side, and then, in a process of its own for
each build (so that a build that hangs is ended by a time limit), calls K1
(writing its lse) and K2 (handed the walk's lse) ``--reps`` times at six
shapes of the resident route: N = 1024 at head dims 512 and 1024 (five ring
slots), N = 1152 (four, the route's limit) and a ragged N = 1100. Every
result is held bit for bit to the same build's walk (route 0) on the same
inputs, and K2's output, pre-filled with NaN, to having no NaN left.

``--mutate`` adds, for each directory, a build whose TMA stages are issued by
two producer threads, each owning alternate ring slots and running ahead of
the other as it may, so that fills land out of the ring's order: a ring whose
barriers are sound reads 0 there too. ``--two-streams`` spreads
the calls over two CUDA streams, so that blocks of different calls share
the card. Each build's line gives its counts per shape; the last line reads
"stress: N of M results differ from the walk or hold NaN", and the exit code
is 1 unless every build read 0. Imports torch and the port; needs a card.
"""

import argparse
import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (batch, N, C, heads, split_first): resident shapes, every one a TMA route
SHAPES = ((4, 1024, 2048, 2, False), (4, 1024, 2048, 2, True), (8, 1024, 512, 1, True),
          (2, 1024, 512, 1, True), (2, 1152, 1024, 1, False), (2, 1100, 768, 1, True))
WORK = os.path.join(ROOT, "nicediffusion_tpu_torch", "_build", "stress")


def two_issuers(src: str) -> str:
    """attention_chunked.cuh with the producer's TMA stages issued by lanes 0
    of its first two warps, the one of warp w filling the ring slots s with
    s % 2 = w (so each slot's empty barrier keeps one waiter)."""
    at = src.index("void produce(")
    lam = src.index("  auto stage = [&](", at)
    body = src.index("\n", lam) + 1
    src = (src[:body] + "    if (a.tma && (slot & 1) != (ptid >> 5)) {\n"
           "      if (++slot == a.slots) slot = 0, phase ^= 1;\n      return;\n    }\n"
           + src[body:])
    one = "if (a.tma && tid != kConsumers) return;"
    if src.count(one) != 1:
        raise SystemExit("--mutate: the producer's issuing thread is not where this tool looks")
    return src.replace(one, "if (a.tma && tid != kConsumers && tid != kConsumers + 32) return;")


def build(job):
    """Copies a csrc directory (mutated or not) under WORK and builds it."""
    name, csrc, mutate = job
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, os.path.join(d, "csrc"))
    if mutate:
        path = os.path.join(d, "csrc", "attention_chunked.cuh")
        with open(path) as f:
            src = two_issuers(f.read())
        with open(path, "w") as f:
            f.write(src)
    for lib in ("attention", "attention_bwd"):
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            os.path.join(d, f"lib{lib}.so"), os.path.join(d, "csrc", f"{lib}.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{name}: nvcc failed on {lib}.cu:\n{r.stderr[-3000:]}")
    return name


def run(name: str, reps: int, two_streams: bool) -> int:
    """Calls one build's K1 and K2; prints its counts; returns the total."""
    d = os.path.join(WORK, name)
    fwd = ctypes.CDLL(os.path.join(d, "libattention.so"))
    bwd = ctypes.CDLL(os.path.join(d, "libattention_bwd.so"))
    fwd.nd_fused_qkv_attention_routed.argtypes = [_P, _P, _P, *[_I] * 6, _F, _I, _I, _P]
    bwd.nd_fused_qkv_attention_bwd_routed.argtypes = [*[_P] * 6, *[_I] * 6, _F, _I, _I, _P]
    dev = torch.device("cuda")

    def k1(x, heads, sf, route):
        b, n, c3 = x.shape
        c = c3 // 3
        out = torch.empty(b, n, c, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(b, heads, n, device=dev)
        err = fwd.nd_fused_qkv_attention_routed(
            x.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, c, heads, int(sf), 1,
            (c // heads) ** -0.5, route, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: K1 launch failed ({err}) at {tuple(x.shape)}")
        return out, lse

    def k2(x, cot, o, lse, heads, sf, route):
        b, n, c3 = x.shape
        c = c3 // 3
        out = torch.full_like(x, float("nan"))
        delta = torch.empty(b, heads, n, device=dev)
        err = bwd.nd_fused_qkv_attention_bwd_routed(
            x.data_ptr(), cot.data_ptr(), o.data_ptr(), lse.data_ptr(), out.data_ptr(),
            delta.data_ptr(), b, n, c, heads, int(sf), 1, (c // heads) ** -0.5, route, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: K2 launch failed ({err}) at {tuple(x.shape)}")
        return out

    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for b, n, c, heads, sf in SHAPES:
        x = torch.randn(b, n, 3 * c, generator=g, device=dev).bfloat16()
        cot = (2 * torch.rand(b, n, c, generator=g, device=dev) - 1).bfloat16()
        o, lse = k1(x, heads, sf, 0)
        cases.append(((b, n, c, heads, sf), x, cot, o, lse, k2(x, cot, o, lse, heads, sf, 0)))
    torch.cuda.synchronize()
    streams = [torch.cuda.current_stream(), torch.cuda.Stream()]
    seen = {key: [] for key, *_ in cases}
    t0 = time.perf_counter()
    for rep in range(reps):
        for i, (key, x, cot, o, lse, ref) in enumerate(cases):
            with torch.cuda.stream(streams[(rep * len(cases) + i) % 2 if two_streams else 0]):
                o1, l1 = k1(x, key[3], key[4], 1)
                o2 = k2(x, cot, o, lse, key[3], key[4], 1)
                seen[key].append(torch.stack([
                    (~torch.eq(o1, o).all()).long(),
                    (~torch.eq(l1, lse).all()).long(), (~torch.eq(o2, ref).all()).long(),
                    torch.isnan(o2).any().long()]))
    torch.cuda.synchronize()
    counts = {key: torch.stack(v).sum(0).tolist() for key, v in seen.items()}
    total = [sum(c[j] for c in counts.values()) for j in range(4)]
    print(f"{name}: {reps} rounds of {len(cases)} shapes in {time.perf_counter() - t0:.1f} s: "
          f"K1 output differs {total[0]}, K1 lse differs {total[1]}, K2 differs {total[2]}, "
          f"K2 holds NaN {total[3]}; per (B, N, C, heads, split_first) [K1, lse, K2, NaN] "
          f"{counts}", flush=True)
    # a K2 with NaN also differs: count it once
    return total[0] + total[1] + total[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", nargs="+",
                    default=[os.path.join(ROOT, "nicediffusion_tpu_torch", "csrc")])
    ap.add_argument("--mutate", action="store_true")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--two-streams", action="store_true")
    ap.add_argument("--timeout", type=int, default=300, help="seconds a build's run may take")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one build's run, in its own process
    args = ap.parse_args(argv)
    if args.run:
        print(f"RESULT {run(args.run, args.reps, args.two_streams)}", flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    jobs = []
    for i, csrc in enumerate(args.csrc):
        jobs.append((f"build{i}", csrc, False))
        if args.mutate:
            jobs.append((f"build{i}_two_issuers", csrc, True))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name, csrc, mutate in jobs:
        print(f"{name}: {os.path.abspath(csrc)}{', two TMA issuers' if mutate else ''}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(build, jobs))
    print(f"built {len(jobs)} builds in {time.perf_counter() - t0:.1f} s", flush=True)
    bad = results = 0
    for name, _, _ in jobs:
        cmd = [sys.executable, os.path.abspath(__file__), "--run", name, "--reps", str(args.reps)]
        if args.two_streams:
            cmd.append("--two-streams")
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            out = r.stdout + r.stderr
        except subprocess.TimeoutExpired:
            r, out = None, f"{name}: no end within {args.timeout} s"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        print("\n".join(ln for ln in out.splitlines() if not ln.startswith("RESULT "))[-3000:],
              flush=True)
        n = int(lines[-1].split()[1]) if r is not None and r.returncode == 0 and lines else None
        if n is None:
            print(f"{name}: the run failed (counted as every result differing)")
            n = args.reps * len(SHAPES) * 3
        bad += n
        results += args.reps * len(SHAPES) * 3
    print(f"stress: {bad} of {results} results differ from the walk or hold NaN")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
