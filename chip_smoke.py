"""Smoke run of the PyTorch port (nicediffusion_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, class-conditional sampling with classifier-free
guidance, at the full width of the ``openai_64`` preset with random weights
made from a seed, and checks every hand-written kernel on the way:

  1. device: the card's name and power limit, torch/CUDA/Triton versions;
  2. build: K1 (CUDA C++, nvcc for sm_90a) from the sources in this
     checkout, and K3 (Triton);
  3. each kernel against its plain torch version at every shape one
     forward of the main path gives it (found by hooks on a plain-version
     forward) plus the ragged EMNIST shapes, f32 and bf16, with the JAX
     package's tolerances; its bf16 time per call (CUDA events around
     back-to-back calls) per shape and summed over one forward, beside the
     plain version's;
  4. the full-width f32 model with kernels on against ``kernels=False``
     on one CFG forward (max abs <= 1e-3, the repo's parity bar);
  5. the slice: bf16, CFG w=0.8, DDPM with learned-interpolation variance
     respaced to 25 steps, answering 3 requests of 8 labels; the launch
     counters must show every attention and GroupNorm call went through the
     kernels; samples/s with kernels on and off.

Prints a JSON line describing the kernels, then, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a machine without a CUDA card. Imports nothing of JAX.
"""

import collections
import json
import re
import statistics
import subprocess
import sys
import time

import torch

F32_TOL = {"attention": dict(atol=2e-5, rtol=0), "groupnorm": dict(atol=1e-5, rtol=0)}
# bf16 GN outputs reach ~10, where one bf16 ulp is 0.06: the JAX package's
# bf16 GN gate carries rtol 1e-2 (tests/test_pallas.py:206)
BF16_TOL = {"attention": dict(atol=3e-2, rtol=0), "groupnorm": dict(atol=3e-2, rtol=1e-2)}
MODEL_TOL = 1e-3
SEED = 0


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=20, rounds=5):
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, divided by ``iters``; the median of ``rounds`` such runs. A call
    shorter than its host-side launch cost is timed at the launch rate."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def check(name, out, ref, tol):
    """max |out - ref|; raises if any element is outside atol + rtol*|ref|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    bad = err > tol["atol"] + tol["rtol"] * ref.abs()
    if not torch.isfinite(out).all() or bad.any():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3g} over {tol}")
    return err.max().item()


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import triton

    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} python {sys.version.split()[0]}")
    return smi


def phase_build():
    from nicediffusion_tpu_torch.ops.kernels import _build
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3

    t0 = time.perf_counter()
    _build.load_library("attention")
    k1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k3._kernel()
    k3_s = time.perf_counter() - t0
    for name, (nvcc_log, seconds) in _build.build_logs().items():
        log(f"[build] {name}: nvcc {seconds:.2f} s")
        # ptxas -v: "Compiling entry function '<mangled>'", a spill line,
        # then "Used N registers" for each template instance
        entry = spills = ""
        for line in nvcc_log.splitlines():
            m = re.search(r"Compiling entry function '\w*?kernelI(\w+?)Li(\d+)E", line)
            if m:
                entry = f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'} hc={m.group(2)}"
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                log(f"[build]   {entry}: {line.split(':', 1)[1].strip()}; {spills}")
    log(f"[build] K1 ready in {k1_s:.2f} s, K3 (triton import) in {k3_s:.2f} s")


def main_path_calls(model, dev):
    """Every GroupNorm and attention call of one forward of ``model``, as
    a Counter of call keys -> calls per forward. ``model`` runs with
    ``kernels=False``, so this launches no kernel."""
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp

    calls = collections.Counter()

    def gn_hook(mod, args):
        calls[("groupnorm", tuple(args[0].shape[1:]), mod.mode)] += 1

    def attn_hook(mod, args):
        _, h, w, c = args[0].shape
        calls[("attention", h * w, c, mod.heads, mod.split_qkv_first)] += 1

    hooks = [m.register_forward_pre_hook(gn_hook) for m in model.modules()
             if isinstance(m, GroupNormOp)]
    hooks += [m.register_forward_pre_hook(attn_hook) for m in model.modules()
              if isinstance(m, AttentionBlock)]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        model(x, zero, zero)
    for h in hooks:
        h.remove()
    return calls


def phase_kernels(dev, calls):
    """Each kernel against its plain version at every shape the main path
    gives it (model batch 16: 8 requests doubled by CFG), in f32 and bf16,
    plus the ragged EMNIST shapes; bf16 times per shape and per forward."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3

    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {(k, dt): 0.0 for k in ("attention", "groupnorm")
            for dt in (torch.float32, torch.bfloat16)}
    per_forward = {k: [0.0, 0.0] for k in ("attention", "groupnorm")}
    # the main path's calls, then the ragged EMNIST shapes (N = 49 and 196,
    # 4 heads of 32; 7x7 GroupNorm), which it does not make
    cases = [(16, key, n) for key, n in sorted(calls.items(), key=str)]
    cases += [(4, ("attention", n, 128, 4, True), 0) for n in (49, 196)]
    cases += [(2, ("groupnorm", (7, 7, 96), mode), 0) for mode in ("plain", "silu", "ada")]
    for b, key, per_call in cases:
        kind = key[0]
        for dtype in (torch.float32, torch.bfloat16):
            tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)[kind]
            if kind == "attention":
                _, n, c, heads, split_first = key
                qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(dtype)
                layouts = (split_first, not split_first)
                runs = [((lambda sf=sf: k1.fused_qkv_attention(qkv, heads, sf)),
                         (lambda sf=sf: k1.fused_qkv_attention_plain(qkv, heads, sf)))
                        for sf in layouts]
                name = f"K1 B={b} N={n} C={c} heads={heads}"
            else:
                _, (h, w, c), mode = key
                x = (2 * torch.randn(b, h, w, c, generator=g, device=dev) + 0.5).to(dtype)
                sc = torch.randn(c, generator=g, device=dev)
                bi = torch.randn(c, generator=g, device=dev)
                emb = (0.1 * torch.randn(b, 2 * c, generator=g, device=dev)).to(dtype)
                args = (x, sc, bi) + (tuple(emb.chunk(2, dim=-1)) if mode == "ada" else ())
                kw = dict(silu=mode != "plain")
                runs = [((lambda: k3.group_norm_fused(*args, **kw)),
                         (lambda: k3.group_norm_fused_plain(*args, **kw)))]
                name = f"K3 {mode} {(b, h, w, c)}"
            for kernel_fn, plain_fn in runs:
                out = kernel_fn()
                torch.cuda.synchronize()
                err = check(f"{name} {dtype}", out, plain_fn(), tol)
                errs[kind, dtype] = max(errs[kind, dtype], err)
            if dtype == torch.bfloat16 and per_call:
                ms, plain = time_ms(runs[0][0]), time_ms(runs[0][1])
                per_forward[kind][0] += per_call * ms
                per_forward[kind][1] += per_call * plain
                log(f"[kernels] {name} bf16, {per_call} per forward: "
                    f"{ms:.4f} ms, plain {plain:.4f} ms")
    for (kind, dtype), err in errs.items():
        log(f"[kernels] {kind} {dtype}: max abs err {err:.3g} vs plain")
    for kind, (ms, plain) in per_forward.items():
        log(f"[kernels] {kind}: {ms:.4f} ms per forward (its bf16 calls at model "
            f"batch 16, each timed back to back), plain {plain:.4f} ms")
    return errs, per_forward


def randomize(model, seed):
    """Seeded fan-in-scaled weights with no leaf left at zero, so the
    zero-initialised output convs and projections take part."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g, device=p.device)
            if name.endswith("bias"):
                p.copy_(0.1 * noise)
            elif p.ndim == 1:  # GroupNorm weight
                p.copy_(1.0 + 0.1 * noise)
            elif name.startswith("class_embedding"):
                p.copy_(noise)
            else:
                p.copy_(noise / p[0].numel() ** 0.5)
            if not p.any():
                raise AssertionError(f"{name} left at zero")


def model_config():
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    cfg = dict(MODEL_PRESETS["openai_64"])
    cfg["num_classes"] += 1  # CFG's null class
    return cfg


def phase_model(dev, off):
    """Full-width f32 CFG forward, kernels on against ``off`` (kernels=False)."""
    from nicediffusion_tpu_torch import DiffusionModel

    on = DiffusionModel(**model_config(), device=dev).eval()
    on.load_state_dict(off.state_dict(), strict=True)
    nparams = sum(p.numel() for p in on.parameters())

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(2, 64, 64, 3, generator=g, device=dev)
    x2 = torch.cat([x, x])
    t2 = torch.tensor([980, 500] * 2, device=dev)
    y2 = torch.tensor([207, 933, 0, 0], device=dev)
    with torch.inference_mode():
        a = on(x2, t2, y2)
        b = off(x2, t2, y2)
    torch.cuda.synchronize()
    err = check("f32 full-width CFG forward, kernels on vs off", a, b,
                dict(atol=MODEL_TOL, rtol=0))
    log(f"[model] openai_64 f32, {nparams} parameters, CFG forward at batch 2 "
        f"(model batch 4): kernels on vs off max abs {err:.3g} "
        f"(output max abs {b.abs().max().item():.3g})")
    del on, a, b
    torch.cuda.empty_cache()


def phase_slice(dev, state):
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.ops.kernels import attention as k1
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = model_config()
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=25, use_ddim=False,
                guidance_method="classifier_free", guidance_strength=0.8)
    models = {}
    for kernels in (True, False):
        m = DiffusionModel(**cfg, dtype=torch.bfloat16, kernels=kernels, device=dev).eval()
        m.load_state_dict(state, strict=True)
        models[kernels] = (m, Diffusion(model=m, **dcfg))
    n_attn = sum(isinstance(m, AttentionBlock) for m in models[True][0].modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in models[True][0].modules())
    steps = models[True][1].rescaled_num_steps

    requests = [torch.arange(8, device=dev) * 97 % 1000 + 1 + i for i in range(3)]

    def answer(kernels, i):
        _, diff = models[kernels]
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diff.denoise(g, y=requests[i], batch_size=8)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for kernels in (True, False):  # warm-up: Triton bf16 variants, cuDNN plans
        models[kernels][1].denoise(torch.Generator(device=dev).manual_seed(7),
                                   y=requests[0], batch_size=8, steps_to_do=2)
    torch.cuda.synchronize()

    k1.fused_qkv_attention.launches = 0
    k3.group_norm_fused.launches = 0
    seconds = {True: 0.0, False: 0.0}
    diffs = []
    for i in range(len(requests)):
        out, s_on = answer(True, i)
        seconds[True] += s_on
        if out.shape != (8, 64, 64, 3) or out.dtype != torch.float32:
            raise AssertionError(f"request {i}: output {tuple(out.shape)} {out.dtype}")
        if not torch.isfinite(out).all() or out.abs().max() > 1.0:
            raise AssertionError(f"request {i}: values not finite in [-1, 1]")
        ref, s_off = answer(False, i)
        seconds[False] += s_off
        diffs.append((out - ref).abs().max().item())
        log(f"[slice] request {i}: labels {requests[i].tolist()} -> {tuple(out.shape)}, "
            f"range [{out.min().item():.3f}, {out.max().item():.3f}]; "
            f"{s_on:.4f} s with kernels, {s_off:.4f} s without")
    launches = {"attention": k1.fused_qkv_attention.launches,
                "groupnorm": k3.group_norm_fused.launches}
    calls = steps * len(requests)
    expect = {"attention": n_attn * calls, "groupnorm": n_gn * calls}
    log(f"[slice] {calls} model calls at batch 16; launches {launches}, "
        f"expected {expect} ({n_attn} attention blocks, {n_gn} GroupNorm ops per call)")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    samples = 8 * len(requests)
    rate = {k: samples / v for k, v in seconds.items()}
    log(f"[slice] samples/s: kernels on {rate[True]:.4f}, kernels off {rate[False]:.4f} "
        f"(bf16, 25 DDPM steps, CFG, 8 samples per request)")
    log(f"[slice] kernels on vs off, final samples max abs diff per request "
        f"(bf16, 25 stochastic steps): {[round(d, 4) for d in diffs]}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")
    import nicediffusion_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()

    from nicediffusion_tpu_torch import DiffusionModel

    reference = DiffusionModel(**model_config(), kernels=False, device=dev).eval()
    randomize(reference, SEED)
    errs, per_forward = phase_kernels(dev, main_path_calls(reference, dev))
    phase_model(dev, reference)
    state = reference.state_dict()
    del reference
    launches = phase_slice(dev, state)

    basis = "sum over one openai_64 forward's calls, bf16, model batch 16"
    kernels = [
        {"name": "fused_qkv_attention", "route": "cuda",
         "source": "nicediffusion_tpu_torch/csrc/attention.cu",
         "replaces": "nicediffusion_tpu/ops/pallas/attention.py:177",
         "launches": launches["attention"],
         "max_abs_err": errs["attention", torch.float32],
         "max_abs_err_bf16": errs["attention", torch.bfloat16],
         "ms": per_forward["attention"][0], "plain_ms": per_forward["attention"][1],
         "ms_basis": basis},
        {"name": "group_norm_fused", "route": "triton",
         "source": "nicediffusion_tpu_torch/ops/kernels/groupnorm.py",
         "replaces": "nicediffusion_tpu/ops/pallas/groupnorm.py:151",
         "launches": launches["groupnorm"],
         "max_abs_err": errs["groupnorm", torch.float32],
         "max_abs_err_bf16": errs["groupnorm", torch.bfloat16],
         "ms": per_forward["groupnorm"][0], "plain_ms": per_forward["groupnorm"][1],
         "ms_basis": basis},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
