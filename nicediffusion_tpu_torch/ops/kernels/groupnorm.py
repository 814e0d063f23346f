"""K3: fused GroupNorm (+AdaGN scale-shift) (+SiLU) over NHWC, and its
backward, in CUDA C++ (``csrc/groupnorm.cu``).

Replaces the TPU kernel nicediffusion_tpu/ops/pallas/groupnorm.py ::
group_norm_fused and the backward of its custom VJP
(nicediffusion_tpu/ops/groupnorm.py::_fused_gn), with the same semantics:
per-example f32 sum and sum of squares folded into groups, biased variance
E[x^2] - E[x]^2, eps inside the rsqrt, f32 affine, optional
``(1 + s) * y + b`` modulation from (B, C) rows, optional SiLU, stored in x's
dtype. Unlike the JAX package's plain op, the normalised value is not rounded
to x's dtype before the modulation (this matters in bf16 only), and the
backward differentiates this arithmetic, in closed form.

What bounds both kernels on the card: bytes (the note in the source says
what the design does about it). The forward reads x once where the
example fits its thread-block cluster's shared memory and writes the output
once; the backward reads x and the cotangent and writes dx. A forward called
for a gradient also writes the per-(example, group) f32 mean and rstd, which
the autograd Function saves and hands to the backward. The forward's split
of the work, and so the order of its sums, is chosen for a batch of 16
whatever the call's batch: an example's output is the same bits in any
batch (the serving daemon's promise).

Dispatch: a CPU tensor goes to the plain versions
(:func:`group_norm_fused_plain`, :func:`group_norm_fused_bwd_plain`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "group_stats", "group_norm_fused", "group_norm_fused_plain", "group_norm_fused_with_stats",
    "group_norm_fused_bwd", "group_norm_fused_bwd_plain", "group_norm_plan",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PLAN_FIELDS = ("vector", "slices", "cluster", "threads", "rows_per_block", "resident_rows",
               "tile_bytes", "smem_bytes")


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


def group_norm_fused_bwd_plain(
    x, scale, bias, emb_scale, emb_shift, g, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True, mean=None, rstd=None,
):
    """The plain torch version of K3's backward: the VJP of
    :func:`group_norm_fused_plain` in closed form, in f32. With
    n = (x - mean) * rstd, z = n * scale + bias, u = z * (1 + s) + t (or z),
    g_u = g * SiLU'(u) (or g), P = sum_hw g_u and Q = sum_hw g_u * n per
    (example, channel):

        d(shift) = P, d(scale_emb) = scale * Q + bias * P,
        d(bias) = sum_b (1 + s) P, d(scale) = sum_b (1 + s) Q,
        dx = rstd * (d - mean_g(d) - n * mean_g(d * n)), d = g_u (1 + s) scale.

    ``mean`` and ``rstd``, (B, G) f32, are the forward's statistics, as the
    kernel takes them; without them they are computed from x.

    Returns (dx, dscale, dbias, demb_scale, demb_shift), each in its input's
    dtype (the last two None without modulation rows)."""
    b, h, w, c = x.shape
    cg = c // num_groups
    xg, m_x, var = group_stats(x, num_groups)
    if mean is None:
        mean, rstd = m_x, torch.rsqrt(var + eps)
    else:
        mean, rstd = (t.float().reshape(b, 1, num_groups, 1) for t in (mean, rstd))
    n = ((xg - mean) * rstd).reshape(b, h, w, c)
    ga, be = scale.float(), bias.float()
    ada = emb_scale is not None
    m = 1.0 + emb_scale.float()[:, None, None, :] if ada else 1.0
    gu = g.float()
    if silu:
        u = n * ga + be
        if ada:
            u = u * m + emb_shift.float()[:, None, None, :]
        sig = torch.sigmoid(u)
        gu = gu * (sig * (1.0 + u * (1.0 - sig)))
    p = gu.sum(dim=(1, 2))
    q = (gu * n).sum(dim=(1, 2))
    d = gu * (m * ga)
    grouped = (b, h * w, num_groups, cg)
    m1 = d.reshape(grouped).mean(dim=(1, 3), keepdim=True)
    m2 = (d * n).reshape(grouped).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (d.reshape(grouped) - m1 - n.reshape(grouped) * m2)).reshape(b, h, w, c)
    mrow = 1.0 + emb_scale.float() if ada else 1.0
    dscale = (mrow * q).sum(0)
    dbias = (mrow * p).sum(0)
    des = (ga * q + be * p).to(emb_scale.dtype) if ada else None
    desh = p.to(emb_shift.dtype) if ada else None
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype), des, desh


def _library() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.bind("groupnorm", {
        "nd_group_norm_fwd": [p, p, p, p, p, p, ll, i, p, p, i, i, i, i, ctypes.c_float, i, i, i,
                              p],
        "nd_group_norm_bwd": [p, p, p, p, p, p, p, ll, i, p, p, p, i, i, i, i, i, i, i, i, p],
        "nd_group_norm_plan": [*[i] * 9, ctypes.POINTER(ctypes.c_int)],
    })


def _raise(lib, err, what, x):
    raise _build.launch_error(lib, err, what, f"x {tuple(x.shape)} {x.dtype}")


def group_norm_plan(shape, dtype, num_groups: int = 32, backward: bool = False,
                    align: int = 16, force: tuple[int, int] | None = None) -> dict:
    """The split a K3 call on (B, H, W, C) tensors of ``dtype`` takes on the
    current card (``PLAN_FIELDS``: elements a vector, channel slices, cluster
    size, threads a block, pixel rows a block and of them held in shared
    memory, tile and shared-memory bytes of a block), with ``route``:
    ``resident`` where every row stays in shared memory between the two
    passes, else ``re-read``; and ``hbm_bytes``, what the call moves to and
    from device memory if every re-read row comes from it again (the
    upper end: L2 serves part of them). The forward's split is the same at
    every batch (chosen for 16). ``force`` = (slices, cluster size)
    makes that split the plan of every later call of these shapes on this
    card (to time the splits against each other); it raises if the split is
    not one the card can run."""
    b, h, w, c = shape
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    lib = _library()
    err = lib.nd_group_norm_plan(b, h * w, c, num_groups, _DTYPE_CODES[dtype], int(backward),
                                 align, *(force or (0, 0)), out)
    if err:
        raise RuntimeError(f"K3 plan failed: {lib.nd_cuda_error_string(err).decode()}")
    plan = dict(zip(PLAN_FIELDS, out))
    rows = h * w
    held = 0
    for r0 in range(0, rows, plan["rows_per_block"]):
        held += min(plan["resident_rows"], min(rows, r0 + plan["rows_per_block"]) - r0)
    plan["route"] = "resident" if held == rows else "re-read"
    row_bytes = c * dtype.itemsize
    inputs = 2 if backward else 1
    plan["hbm_bytes"] = b * row_bytes * ((inputs + 1) * rows + inputs * (rows - held))
    return plan


def _check(x, scale, bias, emb_scale, emb_shift, num_groups, what="K3"):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"{what} takes a non-empty contiguous NHWC tensor, got "
                         f"{tuple(x.shape)}")
    b, _, _, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    for p in (scale, bias):
        if p.shape != (c,) or p.device != x.device:
            raise ValueError(f"{what} takes ({c},) scale/bias on {x.device}")
    if (emb_scale is None) != (emb_shift is None):
        raise ValueError(f"{what} takes emb_scale and emb_shift together or neither")
    if emb_scale is not None:
        for e in (emb_scale, emb_shift):
            if (e.shape != (b, c) or e.stride() != emb_scale.stride() or e.stride(1) != 1
                    or e.device != x.device or e.dtype != emb_scale.dtype
                    or e.dtype not in (torch.float32, x.dtype)):
                raise ValueError(
                    f"{what} takes (B, C) = ({b}, {c}) modulation rows of one stride with unit "
                    f"channel stride, in float32 or x's dtype, got {tuple(e.shape)} {e.dtype} "
                    f"strides {e.stride()}"
                )


def _emb_args(emb_scale, emb_shift):
    if emb_scale is None:
        return None, None, 0, 0
    return (emb_scale.data_ptr(), emb_shift.data_ptr(), emb_scale.stride(0),
            int(emb_scale.dtype == torch.float32))


def _forward(x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu, stats=False):
    """K3 on a CUDA tensor, its plain version on a CPU tensor. With
    ``stats`` returns (out, mean, rstd), the f32 (B, G) statistics."""
    if x.device.type == "cpu":
        out = group_norm_fused_plain(x, scale, bias, emb_scale, emb_shift,
                                     num_groups=num_groups, eps=eps, silu=silu)
        if not stats:
            return out
        _, mean, var = group_stats(x, num_groups)
        b = x.shape[0]
        return out, mean.reshape(b, num_groups), torch.rsqrt(var + eps).reshape(b, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {x.device}")
    _check(x, scale, bias, emb_scale, emb_shift, num_groups)
    b, h, w, c = x.shape
    scale, bias = (t.detach().float().contiguous() for t in (scale, bias))  # no-ops for f32
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty(2, b, num_groups, dtype=torch.float32, device=x.device)
    es, eb, stride, emb_f32 = _emb_args(emb_scale, emb_shift)
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_group_norm_fwd(
            x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(), es, eb, stride,
            emb_f32, None if mean is None else mean.data_ptr(),
            None if rstd is None else rstd.data_ptr(), b, h * w, c, num_groups, float(eps),
            int(emb_scale is not None), int(silu), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        _raise(lib, err, "K3", x)
    group_norm_fused.launches += 1
    return (out, mean, rstd) if stats else out


def group_norm_fused_with_stats(
    x, scale, bias, emb_scale=None, emb_shift=None, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True,
):
    """K3's forward as :func:`group_norm_fused` computes it, with the f32
    (B, G) mean and rstd it used, as the autograd Function saves them for
    :func:`group_norm_fused_bwd`. Counted on ``group_norm_fused.launches``."""
    return _forward(x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu, stats=True)


def group_norm_fused_bwd(
    x, scale, bias, emb_scale, emb_shift, g, mean=None, rstd=None, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True,
    needs=(True, True, True, True, True),
):
    """K3's backward: (dx, dscale, dbias, demb_scale, demb_shift) for the
    cotangent ``g`` (cast to x's dtype, as the JAX VJP casts it), each in its
    input's dtype, None where ``needs`` (x, scale, bias, emb_scale,
    emb_shift) says no or the input is None. A CPU tensor takes
    :func:`group_norm_fused_bwd_plain` (on ``mean`` and ``rstd`` if given). A
    CUDA tensor launches the kernel (``group_norm_fused_bwd.launches`` counts
    it) with the forward's f32 (B, G) ``mean`` and ``rstd``; dscale and dbias
    are the kernel's
    per-example rows summed over the batch in a fixed order, so the result
    is the same bit for bit from run to run."""
    g = g.to(x.dtype)
    if x.device.type == "cpu":
        grads = group_norm_fused_bwd_plain(x, scale, bias, emb_scale, emb_shift, g,
                                           num_groups=num_groups, eps=eps, silu=silu,
                                           mean=mean, rstd=rstd)
        return tuple(t if need else None for t, need in zip(grads, needs))
    if x.device.type != "cuda":
        raise ValueError(f"K3's backward runs on CUDA tensors, got {x.device}")
    _check(x, scale, bias, emb_scale, emb_shift, num_groups, "K3's backward")
    b, h, w, c = x.shape
    if g.shape != x.shape or not g.is_contiguous():
        g = g.contiguous()
        if g.shape != x.shape:
            raise ValueError(f"K3's backward takes a cotangent of x's shape {tuple(x.shape)}")
    for t in (mean, rstd):
        if (t is None or t.shape != (b, num_groups) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"K3's backward takes the forward's contiguous float32 "
                             f"({b}, {num_groups}) mean and rstd")
    param_dtype = scale.dtype
    scale, bias = (t.detach().float().contiguous() for t in (scale, bias))
    want_dx = bool(needs[0])
    dx = torch.empty_like(x) if want_dx else None
    sums = torch.empty(4, b, c, dtype=torch.float32, device=x.device)
    es, eb, stride, emb_f32 = _emb_args(emb_scale, emb_shift)
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_group_norm_bwd(
            x.data_ptr(), g.data_ptr(), None if dx is None else dx.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), es, eb, stride, emb_f32, mean.data_ptr(),
            rstd.data_ptr(), sums.data_ptr(), b, h * w, c, num_groups,
            int(emb_scale is not None), int(silu), int(want_dx), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        _raise(lib, err, "K3's backward", x)
    group_norm_fused_bwd.launches += 1
    dscale = dbias = None
    if needs[1] or needs[2]:
        dbias, dscale = sums[2:].sum(dim=1).to(param_dtype)
    ada = emb_scale is not None
    return (dx, dscale if needs[1] else None, dbias if needs[2] else None,
            sums[1].to(emb_scale.dtype) if ada and needs[3] else None,
            sums[0].to(emb_shift.dtype) if ada and needs[4] else None)


class _GroupNormFused(torch.autograd.Function):
    """Forward K3, writing its group statistics; backward K3's backward
    kernel on them (on a CPU tensor, the plain closed form)."""

    @staticmethod
    def forward(ctx, x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu):
        out, mean, rstd = _forward(x, scale, bias, emb_scale, emb_shift, num_groups, eps, silu,
                                   stats=True)
        ctx.save_for_backward(x, scale, bias, emb_scale, emb_shift, mean, rstd)
        ctx.config = (num_groups, eps, silu)
        return out

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, silu = ctx.config
        # read once: a checkpointed block unpacks its saved tensors once
        x, scale, bias, emb_scale, emb_shift, mean, rstd = ctx.saved_tensors
        grads = group_norm_fused_bwd(
            x, scale, bias, emb_scale, emb_shift, g, mean, rstd,
            num_groups=num_groups, eps=eps, silu=silu, needs=ctx.needs_input_grad[:5],
        )
        return (*grads, None, None, None)


def group_norm_fused(
    x, scale, bias, emb_scale=None, emb_shift=None, *,
    num_groups: int = 32, eps: float = 1e-5, silu: bool = True,
):
    """Fused GroupNorm over NHWC with optional AdaGN modulation and SiLU.

    x: (B, H, W, C); scale/bias: (C,); emb_scale/emb_shift: (B, C) or None.
    CPU tensors take the plain version; CUDA tensors launch K3 on the
    current stream. ``group_norm_fused.launches`` counts the launches.
    When a gradient is wanted the call goes through an autograd Function
    whose backward is K3's backward kernel (``group_norm_fused_bwd``).
    """
    tensors = (x, scale, bias, emb_scale, emb_shift)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        return _GroupNormFused.apply(*tensors, num_groups, eps, silu)
    return _forward(*tensors, num_groups, eps, silu)


group_norm_fused.launches = 0
group_norm_fused_bwd.launches = 0
