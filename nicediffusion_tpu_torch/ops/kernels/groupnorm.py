"""K3: fused GroupNorm (+AdaGN scale-shift) (+SiLU) over NHWC, in Triton.

Replaces the TPU kernel nicediffusion_tpu/ops/pallas/groupnorm.py ::
group_norm_fused, with the same semantics: per-example f32 sum and sum of
squares folded into groups, biased variance E[x^2] - E[x]^2, eps inside the
rsqrt, f32 affine, optional ``(1 + s) * y + b`` modulation from (B, C) rows,
optional SiLU, stored in x's dtype. Unlike the JAX package's plain op, the
normalised value is not rounded to x's dtype before the modulation (this
matters in bf16 only).

What bounds it on the card: bytes. Each element is read twice (statistics,
then normalise; the second read mostly hits L2) and written once, against
a handful of flops. The TPU kernel held one example's (HW, C) block in VMEM
and folded channels into groups with a 0/1 matmul, since Mosaic cannot
reshape lanes. Here one program owns one (example, group) pair, so the
fold is free: its tokens are HW rows of C/G contiguous channels. C/G is
6..48 for the UNet and never a power of two, so the channel block is padded
to one and masked. The loops walk the group's rows in chunks; Triton
pipelines the loads.

Dispatch: a CPU tensor goes to :func:`group_norm_fused_plain`; a CUDA tensor
launches the kernel or raises. Under autograd the forward is the same and
the backward differentiates the plain version on the saved inputs. ``triton`` is imported inside the launching
function, so this module imports where triton is not installed.
"""

import functools

import torch

__all__ = ["group_stats", "group_norm_fused", "group_norm_fused_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK_ELEMS = 2048  # elements of one [rows, channels] chunk per program step
# triton.language, bound by _kernel() at the first launch: Triton resolves
# the names a kernel uses in its module's globals
tl = None


def group_stats(x: torch.Tensor, num_groups: int):
    """(x as f32 (B, HW, G, C/G), mean, biased variance E[x^2] - E[x]^2)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    return xg, mean, var


def group_norm_fused_plain(
    x, scale, bias, emb_scale=None, emb_shift=None, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True,
):
    """The plain torch version of K3, with the kernel's arithmetic."""
    b, h, w, c = x.shape
    xg, mean, var = group_stats(x, num_groups)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * scale.float() + bias.float()
    if emb_scale is not None:
        y = y * (1.0 + emb_scale.float()[:, None, None, :])
        y = y + emb_shift.float()[:, None, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def gn_kernel(
        x_ptr, out_ptr, scale_ptr, bias_ptr, es_ptr, esh_ptr,
        hw, c, cg, groups, emb_stride, eps,
        ADA: tl.constexpr, SILU: tl.constexpr,
        BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        pid = tl.program_id(0)
        b = pid // groups
        g = pid % groups
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < cg
        ch = g * cg + cols
        rows = tl.arange(0, BLOCK_P)
        base = b.to(tl.int64) * hw * c

        # pass 1: f32 sum and sum of squares of the group
        s1 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        s2 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        for p0 in range(0, hw, BLOCK_P):
            r = p0 + rows
            mask = (r < hw)[:, None] & cmask[None, :]
            offs = base + r[:, None] * c + ch[None, :]
            xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            s1 += xv
            s2 += xv * xv
        count = hw * cg
        mean = tl.sum(tl.sum(s1, axis=1), axis=0) / count
        var = tl.sum(tl.sum(s2, axis=1), axis=0) / count - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)

        sc = tl.load(scale_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
        bi = tl.load(bias_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
        a = rstd * sc
        if ADA:
            es = tl.load(es_ptr + b * emb_stride + ch, mask=cmask, other=0.0)
            esh = tl.load(esh_ptr + b * emb_stride + ch, mask=cmask, other=0.0)
            es = es.to(tl.float32)
            esh = esh.to(tl.float32)

        # pass 2: normalise, affine, modulate, SiLU, store in x's dtype
        for p0 in range(0, hw, BLOCK_P):
            r = p0 + rows
            mask = (r < hw)[:, None] & cmask[None, :]
            offs = base + r[:, None] * c + ch[None, :]
            xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = (xv - mean) * a[None, :] + bi[None, :]
            if ADA:
                y = y * (1.0 + es[None, :]) + esh[None, :]
            if SILU:
                y = y * tl.sigmoid(y)
            tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)

    return gn_kernel


def _next_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length()


def _check(x, scale, bias, emb_scale, emb_shift, num_groups):
    if x.dtype not in _DTYPES:
        raise TypeError(f"K3 takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"K3 takes a contiguous NHWC tensor, got {tuple(x.shape)}")
    b, _, _, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    for p in (scale, bias):
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"K3 takes contiguous ({c},) scale/bias on {x.device}")
    if emb_scale is not None:
        for e in (emb_scale, emb_shift):
            if (e.shape != (b, c) or e.stride() != emb_scale.stride()
                    or e.stride(1) != 1 or e.device != x.device):
                raise ValueError(
                    f"K3 takes (B, C) = ({b}, {c}) modulation rows with unit "
                    f"channel stride, got {tuple(e.shape)} strides {e.stride()}"
                )


def _forward(x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_fused_plain(
            x, scale, bias, emb_scale, emb_shift,
            num_groups=num_groups, eps=eps, silu=silu,
        )
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {x.device}")
    _check(x, scale, bias, emb_scale, emb_shift, num_groups)
    b, h, w, c = x.shape
    cg = c // num_groups
    block_c = _next_pow2(cg)
    ada = emb_scale is not None
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernel()[(b * num_groups,)](
            x, out, scale, bias,
            emb_scale if ada else x, emb_shift if ada else x,
            h * w, c, cg, num_groups, emb_scale.stride(0) if ada else 0,
            float(eps),
            ADA=ada, SILU=silu,
            BLOCK_P=max(1, _BLOCK_ELEMS // block_c), BLOCK_C=block_c,
            num_warps=4,
        )
    group_norm_fused.launches += 1
    return out


class _GroupNormFused(torch.autograd.Function):
    """Forward K3; backward differentiates the plain version on the saved
    inputs. The JAX package has no backward kernel either: its custom VJP
    recomputes the plain jnp op (nicediffusion_tpu/ops/groupnorm.py:100-133),
    cotangent cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias, emb_scale, emb_shift)
        ctx.config = (num_groups, eps, silu)
        return _forward(x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, silu = ctx.config
        saved = ctx.saved_tensors  # read once: a checkpointed block unpacks them once
        wanted = [need and t is not None for need, t in zip(ctx.needs_input_grad, saved)]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, wanted)]
            out = group_norm_fused_plain(
                *inputs, num_groups=num_groups, eps=eps, silu=silu
            )
            grads = iter(torch.autograd.grad(
                out, [t for t, need in zip(inputs, wanted) if need], g.to(out.dtype)
            ))
        return (*(next(grads) if need else None for need in wanted), None, None, None)


def group_norm_fused(
    x, scale, bias, emb_scale=None, emb_shift=None, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True,
):
    """Fused GroupNorm over NHWC with optional AdaGN modulation and SiLU.

    x: (B, H, W, C); scale/bias: (C,); emb_scale/emb_shift: (B, C) or None.
    CPU tensors take the plain version; CUDA tensors launch K3 on the
    current stream. ``group_norm_fused.launches`` counts the launches.
    When a gradient is wanted the call goes through an autograd Function
    whose backward recomputes the plain version (plain torch, as in the JAX
    package).
    """
    tensors = (x, scale, bias, emb_scale, emb_shift)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        return _GroupNormFused.apply(*tensors, num_groups, eps, silu)
    return _forward(*tensors, num_groups, eps, silu)


group_norm_fused.launches = 0
