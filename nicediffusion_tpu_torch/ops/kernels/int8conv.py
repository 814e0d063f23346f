"""The int8 convolution of static int8 serving (s8 x s8 -> s32), CUDA C++.

Replaces XLA's int8 convolution in nicediffusion_tpu/ops/quant.py ::
int8_conv_static (``:87``; ``lax.conv_general_dilated`` on int8 operands with
int32 sums: the JAX package has no Pallas kernel for it), and the products of
the dynamic path and of the dense layers. ``csrc/int8conv.cu`` runs it on the
tensor cores (wgmma, s8 in, s32 sums), one launch a call, a float x quantized
on its way into shared memory; its note says what bounds it and how.

Semantics, the JAX package's operation for operation:
``x_q = clip(round(x * inv_act), -127, 127)`` in f32 with round-half-to-even
(skipped for an int8 x, which is taken as quantized), the k x k conv with
zero padding k // 2 and stride 1 or 2 summed exactly in s32, then
``float(sums) * deq``, plus ``bias`` in f32, one rounding to the output type.

The weight is ``kernel_q`` (F, k, k, C) int8, channels innermost per filter:
8-bit wgmma reads only K-major operands. ops/quant.py freezes it in that
layout; utils/convert.py transposes the JAX package's HWIO into it.

Dispatch: a CPU tensor goes to :func:`int8_conv_plain`; a CUDA tensor
launches the kernel or raises (``NotImplementedError`` for a kernel size or
stride it does not take). :func:`int8_conv_plan` picks the kernel's route and
tiles from the call's shape and input type alone; nothing falls back to
another route. ``int8_conv_nhwc.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["int8_conv_nhwc", "int8_conv_plain", "int8_conv_plan", "quantize_static"]

_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("row", "halo")  # the kernel's route codes, in order
CHANNEL_STEP = 64  # channels a K step: one 64-byte s8 row a pixel or a filter
H100_SMS = 132


def quantize_static(x: torch.Tensor, inv_act: torch.Tensor) -> torch.Tensor:
    """``clip(round(x * inv_act), -127, 127)`` as int8: an f32 product,
    round-half-to-even (``jnp.round``'s rule), as the kernel's prologue."""
    return torch.clamp(torch.round(x.float() * inv_act.float()), -127, 127).to(torch.int8)


def _out_shape(x, kernel_q, stride):
    b, h, w, _ = x.shape
    return b, (h - 1) // stride + 1, (w - 1) // stride + 1, kernel_q.shape[0]


def int8_conv_plain(x, kernel_q, inv_act, deq, bias=None, stride: int = 1,
                    out_dtype: torch.dtype | None = None, raw: bool = False):
    """The plain torch version of the kernel: the same quantization, the
    sums exact in float64 (every partial sum is an integer below 2^53; f32
    would be exact only to 2^24), then the f32 epilogue. Returns the output,
    or with ``raw`` (output, int32 sums)."""
    out_dtype = out_dtype or x.dtype
    x_q = x if x.dtype == torch.int8 else quantize_static(x, inv_act)
    k = kernel_q.shape[1]
    sums = F.conv2d(x_q.permute(0, 3, 1, 2).double(), kernel_q.permute(0, 3, 1, 2).double(),
                    stride=stride, padding=k // 2)
    sums = sums.permute(0, 2, 3, 1).to(torch.int32)
    o = sums.float() * deq.float()
    if bias is not None:
        o = o + bias.float()
    o = o.to(out_dtype)
    return (o, sums) if raw else o


def int8_conv_plan(b: int, h: int, w: int, c: int, f: int, k: int, stride: int,
                   xdtype: torch.dtype, sms: int = H100_SMS) -> tuple[str, int, int]:
    """(route, filter tile, channel step) of the kernel for one call, from its
    shape and input type alone.

    The halo route takes stride 1, k = 3 and a bf16 or int8 x: a block is two
    warpgroups of one 8 x 8 output tile each (the tiles of all examples in
    one sequence) with the halo quantized in shared memory. Everything else
    (k = 1, stride 2, the dense view, and an f32 x, the tests' path) takes
    the row route: 128 output pixels a block in one linear sequence. The
    filter tile is 64, 128 or 192: among the widths that divide F (no zero
    products) when one does, the one whose whole waves of blocks over
    ``sms`` multiprocessors cost least, a block costing its filters plus 64
    for its A work (resblock.cu's ``pick_nb`` rule); a tie goes to the
    wider, which brings fewer bytes from L2 an operation. The channel step
    is always 64."""
    halo = k == 3 and stride == 1 and xdtype in (torch.bfloat16, torch.int8)
    if halo:
        units = -(-b * -(-h // 8) * -(-w // 8) // 2)
    else:
        units = -(-b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1) // 128)
    widths = [nb for nb in (3, 2, 1) if f % (64 * nb) == 0] or [3, 2, 1]
    best, best_cost = widths[0], None
    for nb in widths:
        cost = -(-units * -(-f // (64 * nb)) // sms) * (64 * nb + 64)
        if best_cost is None or cost < best_cost:
            best, best_cost = nb, cost
    return ROUTES[halo], 64 * best, CHANNEL_STEP


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("int8conv", {"nd_int8_conv": [p, i, p, p, p, p, p, i, p, *[i] * 10, p]})


def _check(x, kernel_q, inv_act, deq, bias, stride, out_dtype):
    if x.dtype not in _X_CODES:
        raise TypeError(f"the int8 conv takes float32, bfloat16 or int8 x, got {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"the int8 conv writes float32 or bfloat16, got {out_dtype}")
    if x.ndim != 4 or 0 in x.shape:
        raise ValueError(f"the int8 conv takes a non-empty NHWC tensor, got {tuple(x.shape)}")
    if kernel_q.dtype != torch.int8 or kernel_q.ndim != 4 or kernel_q.shape[1] != kernel_q.shape[2]:
        raise ValueError(f"the int8 conv takes an int8 (F, k, k, C) kernel_q, got "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    if kernel_q.shape[1] not in (1, 3) or stride not in (1, 2):
        raise NotImplementedError(f"the int8 conv kernel takes k in (1, 3) and stride in "
                                  f"(1, 2), got k={kernel_q.shape[1]}, stride={stride}")
    c, f = x.shape[-1], kernel_q.shape[0]
    if kernel_q.shape[3] != c:
        raise ValueError(f"kernel_q has {kernel_q.shape[3]} channels, x {c}")
    for name, t, n in (("deq", deq, f), ("bias", bias, f)):
        if t is not None and (t.shape != (n,) or t.device != x.device):
            raise ValueError(f"the int8 conv takes a ({n},) {name} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if kernel_q.device != x.device:
        raise ValueError(f"kernel_q is on {kernel_q.device}, x on {x.device}")
    if x.dtype != torch.int8 and (inv_act.numel() != 1 or inv_act.device != x.device):
        raise ValueError(f"inv_act is one scale for the whole tensor, on {x.device}")


def int8_conv_nhwc(x, kernel_q, inv_act, deq, bias=None, stride: int = 1,
                   out_dtype: torch.dtype | None = None, raw: bool = False):
    """The int8 conv: x (B, H, W, C) f32 or bf16, quantized with the static
    scale ``inv_act`` (a 0-dim f32 tensor) inside the kernel, or int8
    already quantized;
    ``kernel_q`` (F, k, k, C) int8, k 1 or 3; ``deq`` (F,) f32; ``bias`` (F,)
    or None; stride 1 or 2, padding k // 2. Returns (B, Ho, Wo, F) in
    ``out_dtype`` (default x's float type), or with ``raw`` (output, int32
    sums). CPU tensors take the plain version; CUDA tensors launch the
    kernel once on the current stream, on the route and tiles of
    :func:`int8_conv_plan`."""
    if out_dtype is None:
        if x.dtype == torch.int8:
            raise ValueError("an int8 x needs an out_dtype")
        out_dtype = x.dtype
    if x.device.type == "cpu":
        return int8_conv_plain(x, kernel_q, inv_act, deq, bias, stride, out_dtype, raw)
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv runs on CUDA tensors, got {x.device}")
    _check(x, kernel_q, inv_act, deq, bias, stride, out_dtype)
    x, kernel_q = x.contiguous(), kernel_q.contiguous()
    deq = deq.detach().float().contiguous()
    if bias is not None:
        bias = bias.detach().float().contiguous()
    # read by the kernel on the device: no host synchronisation per call
    quantized = x.dtype == torch.int8
    inv = None if quantized else inv_act.detach().float().reshape(1).contiguous()
    shape = _out_shape(x, kernel_q, stride)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    sums = torch.empty(shape, dtype=torch.int32, device=x.device) if raw else None
    b, h, w, c = x.shape
    f, k = kernel_q.shape[0], kernel_q.shape[1]
    route, tile, step = int8_conv_plan(b, h, w, c, f, k, stride, x.dtype, _sms(x.device.index))
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_int8_conv(
            x.data_ptr(), _X_CODES[x.dtype], None if quantized else inv.data_ptr(),
            kernel_q.data_ptr(), deq.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), _OUT_CODES[out_dtype], None if sums is None else sums.data_ptr(),
            b, h, w, c, f, k, stride, ROUTES.index(route), tile, step,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise _build.launch_error(
            lib, err, "int8 conv", f"x {tuple(x.shape)} {x.dtype}, kernel_q "
            f"{tuple(kernel_q.shape)}, stride {stride}, {route} route, {tile} filters a block")
    int8_conv_nhwc.launches += 1
    return (out, sums) if raw else out


int8_conv_nhwc.launches = 0
