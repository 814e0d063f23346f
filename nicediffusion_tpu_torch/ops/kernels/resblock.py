"""K4: fused GroupNorm(+AdaGN)+SiLU + stride-1 3x3 SAME conv, CUDA C++.

Replaces the TPU kernel nicediffusion_tpu/ops/pallas/resblock.py ::
gn_silu_conv3x3 (``csrc/resblock.cu``; its note says what bounds the kernel
on the card and what the design does about the TPU kernel's one-example-in-
VMEM form). A bf16 tensor takes the tensor-core kernel
(``gn_silu_conv3x3_wgmma_kernel``: wgmma products, the weights in a
cp.async ring), an f32 tensor the FMA kernel (f32 products, for the 2e-5
gate); both after the same statistics launch. It is either half of a
ResidualBlock, ``in_norm -> in_conv`` or ``out_norm (AdaGN) -> out_conv``,
as one function: the normalised, activated map never goes to device memory.
Like the JAX package's, it is not wired into the model; callers reach it
directly.

Semantics (the TPU kernel's): f32 group statistics with the biased variance
E[x^2] - E[x]^2, f32 affine, optional ``(1 + es) * y + eb`` from (B, C) rows,
SiLU, the result rounded to x's dtype and zero-padded *after* the
activation, then the nine shifted products summed in f32, the bias added in
f32, and one rounding to x's dtype.

The weight is torch's (F, C, 3, 3), what the model's ``Conv2d`` holds. The
kernel reads it as (3, 3, C, F) in x's dtype: the repack is made once per
weight, dtype and version of the tensor and cached, so repeated calls with
one parameter pay for it once (an optimizer step bumps the version and the
next call repacks).

Dispatch: a CPU tensor goes to :func:`gn_silu_conv3x3_plain`; a CUDA tensor
launches the kernel or raises. Under autograd the forward is the same and
the backward differentiates the plain version on the saved inputs, as the
JAX custom VJP does (the JAX package has no backward kernel either).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from . import _build
from .groupnorm import group_norm_fused_plain

__all__ = ["gn_silu_conv3x3", "gn_silu_conv3x3_plain", "pack_conv3x3_weight"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# weight tensor -> {(dtype, version): packed}; dies with the weight
_PACKED = WeakTensorKeyDictionary()


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's f32 convolutions in full f32 inside the block (a no-op on the CPU)."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def gn_silu_conv3x3_plain(
    x, gamma, beta, weight, bias, es=None, eb=None, *,
    num_groups: int = 32, eps: float = 1e-5, conv_dtype: torch.dtype = torch.float32,
):
    """The plain torch version of K4, with the kernel's rounding points:
    the port's plain GroupNorm(+AdaGN)+SiLU (f32, E[x^2] - E[x]^2) rounded
    to x's dtype, then ``F.conv2d`` in ``conv_dtype`` (f32, no TF32) on
    those values and on the weight rounded to x's dtype, the f32 bias, one
    rounding. x (B, H, W, C), weight (F, C, 3, 3) -> (B, H, W, F) in x's
    dtype.

    A check on the card passes ``conv_dtype=torch.float64``: cuDNN's f32
    3x3 convolution is itself up to 1.9e-5 off a float64 sum at the UNet's
    8x8 and 16x16 maps (measured on an H100; the kernel is within 2e-6), so
    an f32 reference there would measure the library's choice of algorithm
    against the 2e-5 gate and not the kernel."""
    h = group_norm_fused_plain(x, gamma, beta, es, eb, num_groups=num_groups, eps=eps, silu=True)
    with _no_tf32():
        out = F.conv2d(
            h.to(conv_dtype).permute(0, 3, 1, 2), weight.to(x.dtype).to(conv_dtype),
            bias.to(conv_dtype), padding=1,
        )
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def pack_conv3x3_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch's (F, C, 3, 3) -> the kernel's contiguous (3, 3, C, F) in
    ``dtype``, cached per weight tensor, dtype and version (an inference
    tensor tracks no version and is repacked at each call)."""
    if weight.is_inference():
        return weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
    key = (dtype, weight._version)
    slot = _PACKED.setdefault(weight, {})
    if key not in slot:
        slot.clear()  # an older version's pack is of no use any more
        with torch.no_grad():
            slot[key] = weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
    return slot[key]


def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("resblock", {"nd_gn_silu_conv3x3": [
        p, p, p, p, p, ctypes.c_longlong, i, p, p, p, p, p, p, i, i, i, i, i, i,
        ctypes.c_float, i, i, p]})


def _check(x, gamma, beta, weight, bias, es, eb, num_groups):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"K4 takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"K4 takes a non-empty contiguous NHWC tensor, got {tuple(x.shape)}")
    b, _, _, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    if weight.ndim != 4 or weight.shape[1:] != (c, 3, 3):
        raise ValueError(f"K4 takes an (F, {c}, 3, 3) weight, got {tuple(weight.shape)}")
    f = weight.shape[0]
    for name, p, n in (("gamma", gamma, c), ("beta", beta, c), ("bias", bias, f)):
        if p.shape != (n,) or p.device != x.device:
            raise ValueError(f"K4 takes a ({n},) {name} on {x.device}, got {tuple(p.shape)}")
    if weight.device != x.device:
        raise ValueError(f"K4 takes a weight on {x.device}, got {weight.device}")
    if (es is None) != (eb is None):
        raise ValueError("K4 takes es and eb together or neither")
    if es is not None:
        for e in (es, eb):
            if (e.shape != (b, c) or e.stride() != es.stride() or e.stride(1) != 1
                    or e.device != x.device or e.dtype != es.dtype
                    or e.dtype not in (torch.float32, x.dtype)):
                raise ValueError(
                    f"K4 takes (B, C) = ({b}, {c}) modulation rows of one stride with unit "
                    f"channel stride, in float32 or x's dtype, got {tuple(e.shape)} "
                    f"{e.dtype} strides {e.stride()}"
                )


def _forward(x, gamma, beta, weight, bias, es, eb, num_groups, eps, out=None):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        res = gn_silu_conv3x3_plain(x, gamma, beta, weight, bias, es, eb,
                                    num_groups=num_groups, eps=eps)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors, got {x.device}")
    _check(x, gamma, beta, weight, bias, es, eb, num_groups)
    b, h, w, c = x.shape
    f = weight.shape[0]
    if out is None:
        out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    elif (out.shape != (b, h, w, f) or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError(f"K4 takes a contiguous out of shape {(b, h, w, f)} like x")
    ada = es is not None
    with torch.no_grad():
        packed = pack_conv3x3_weight(weight, x.dtype)
        # no-ops for the model's f32 parameters
        gamma, beta, bias = (t.detach().float().contiguous() for t in (gamma, beta, bias))
    # per-(example, group) mean and 1/std, written by the first launch for the
    # second; for bf16 also each (example, channel)'s n = x * A + B as (A, B),
    # the channels padded to a whole step of 64
    stats = torch.empty((2, b, num_groups), dtype=torch.float32, device=x.device)
    ab = (torch.empty((b, -(-c // 64) * 64, 2), dtype=torch.float32, device=x.device)
          if x.dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_gn_silu_conv3x3(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            es.data_ptr() if ada else None, eb.data_ptr() if ada else None,
            es.stride(0) if ada else 0, int(ada and es.dtype == torch.float32),
            packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), None if ab is None else ab.data_ptr(),
            b, h, w, c, f, num_groups, float(eps), int(ada), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise _build.launch_error(lib, err, "K4",
                                  f"x {tuple(x.shape)} {x.dtype}, weight {tuple(weight.shape)}")
    gn_silu_conv3x3.launches += 1
    return out


class _GNSiLUConv3x3(torch.autograd.Function):
    """Forward K4; backward differentiates the plain version on the saved
    inputs (nicediffusion_tpu/ops/pallas/resblock.py:194-204 recomputes the
    jnp reference the same way), the cotangent cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, es, eb, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta, weight, bias, es, eb)
        ctx.config = (num_groups, eps)
        return _forward(x, gamma, beta, weight, bias, es, eb, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps = ctx.config
        saved = ctx.saved_tensors
        wanted = [need and t is not None for need, t in zip(ctx.needs_input_grad, saved)]
        with torch.enable_grad(), _no_tf32():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, wanted)]
            out = gn_silu_conv3x3_plain(*inputs, num_groups=num_groups, eps=eps)
            grads = iter(torch.autograd.grad(
                out, [t for t, need in zip(inputs, wanted) if need], g.to(out.dtype)
            ))
        return (*(next(grads) if need else None for need in wanted), None, None)


def gn_silu_conv3x3(
    x, gamma, beta, weight, bias, es=None, eb=None, *,
    num_groups: int = 32, eps: float = 1e-5, out: torch.Tensor | None = None,
):
    """Fused GN(+AdaGN)+SiLU + stride-1 3x3 SAME conv.

    x: (B, H, W, C) NHWC; gamma/beta: (C,) GroupNorm affine; weight:
    (F, C, 3, 3); bias: (F,); es/eb: optional (B, C) AdaGN rows
    (``SiLU((1 + es) * GN(x) + eb)`` before the conv). Returns (B, H, W, F)
    in x's dtype, every sum in f32. CPU tensors take the plain version; CUDA
    tensors launch K4 (two kernels, one count) on the current stream: bf16
    on the tensor cores, f32 on the CUDA cores.
    ``gn_silu_conv3x3.launches`` counts the launches. When a gradient is
    wanted the call goes through an autograd Function whose backward
    recomputes the plain version. ``out``, a contiguous (B, H, W, F) tensor
    like x, is written in place of a fresh ``torch.empty`` (a check
    pre-fills it to see that every element is written); it cannot be
    combined with a gradient.
    """
    tensors = (x, gamma, beta, weight, bias, es, eb)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        if out is not None:
            raise ValueError("K4 writes no caller's out under autograd")
        return _GNSiLUConv3x3.apply(*tensors, num_groups, eps)
    return _forward(*tensors, num_groups, eps, out)


gn_silu_conv3x3.launches = 0
