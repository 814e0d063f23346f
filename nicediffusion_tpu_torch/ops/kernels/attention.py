"""K1, K2 and K5: multi-head attention, forward and backward, CUDA C++.

K1 (``csrc/attention.cu``) replaces the TPU kernel
nicediffusion_tpu/ops/pallas/attention.py :: mha_attention_fused_qkv, K2
(``csrc/attention_bwd.cu``) replaces mha_attention_fused_qkv_bwd and K5
(``csrc/attention.cu`` again) replaces mha_attention, all in the same file.
K1 and K5 are one kernel over three strided views: K5 hands it separate
(B, H, N, D) q, k and v, K1 three offsets into one projection. The source
notes say what bounds each kernel on the card and what the designs do about
the TPU kernels' whole-(N, N)-in-VMEM, one-program-per-batch-element form,
which does not fit a Hopper block's shared memory.

Routes by dtype (a dispatch, not a fallback). bf16 K1, K2 and K5 run on
the tensor cores: one warpgroup owns a 64-row tile, every product is a
``wgmma`` (p and ds as register operands, f32 sums), the streamed tiles go
through a two-stage ``cp.async`` ring in the 128-byte swizzle. f32 K1, K2 and
K5 stay on the CUDA cores in f32 FMA: their 2e-5 gate leaves no room for
TF32. All round where the JAX kernels do (f32 logits and softmax, p cast to
the input type before the product with v or g, ds before its products),
except that K1 casts the unnormalised p and divides by the row sum at the
end.

The row log-sum-exp. Called for a gradient, K1 also writes the f32
(B, H, N) log-sum-exp of each row's scaled logits, and K2 takes it: K2 then
recomputes p = exp(logits - lse) without a pass of its own over the keys.

Head dims. K1 and K2 take 32, 64, 128, 192 and 256. K5 takes any D up to
256: the kernel built for the next head dim up zero-fills the columns past
D in shared memory.

Dispatch: a CPU tensor goes to the plain torch version of the same function
(:func:`fused_qkv_attention_plain`, :func:`fused_qkv_attention_bwd_plain`,
:func:`mha_attention_plain`). A CUDA tensor launches the kernel or raises on
what the kernel does not take; nothing falls back. The libraries are built
from the package's source by ``_build`` at the first launch.

Under autograd :func:`fused_qkv_attention` is a ``torch.autograd.Function``
whose forward is K1 and whose backward is K2, with qkv, the forward output
and the row log-sum-exp saved (the JAX package's custom VJP saves the first
two). Without a gradient to take it calls K1 directly and saves nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "SUPPORTED_HEAD_DIMS",
    "mha_attention",
    "mha_attention_plain",
    "split_qkv",
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "fused_qkv_attention_bwd",
    "fused_qkv_attention_bwd_plain",
]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 192, 256)  # K1's and K2's builds; K5 rounds D up to one
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def split_qkv(qkv: torch.Tensor, num_heads: int, split_qkv_first: bool):
    """Split a (B, N, 3C) fused projection into q, k, v of shape (B, H, N, hc).

    ``split_qkv_first=True`` reads the channels as ``[q(C) | k(C) | v(C)]``
    with heads contiguous inside each; ``False`` as the per-head interleaved
    ``[h0:(q|k|v) | h1:(q|k|v) | ...]`` (original reference model.py:266-287).
    """
    b, n, c3 = qkv.shape
    hc = c3 // 3 // num_heads
    if split_qkv_first:
        qkv = qkv.reshape(b, n, 3, num_heads, hc).permute(2, 0, 3, 1, 4)
    else:
        qkv = qkv.reshape(b, n, num_heads, 3, hc).permute(3, 0, 2, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _attend(qkv: torch.Tensor, num_heads: int, split_qkv_first: bool):
    """K1's plain arithmetic: (the (B, N, C) output, the f32 (B, H, N, N)
    scaled logits it came from)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    hc = c // num_heads
    q, k, v = split_qkv(qkv, num_heads, split_qkv_first)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hc**-0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, c).to(qkv.dtype)
    return out, logits


def fused_qkv_attention_plain(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool,
) -> torch.Tensor:
    """The plain torch version of K1: f32 logits and softmax, p cast to v's
    dtype before the product with v. (B, N, 3C) -> (B, N, C)."""
    return _attend(qkv, num_heads, split_qkv_first)[0]


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) with heads contiguous -> (B, H, N, hc)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor, num_heads: int,
    split_qkv_first: bool, lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain torch version of K2: the cotangent of
    :func:`fused_qkv_attention_plain` wrt qkv from the output cotangent ``g``
    and the forward output ``o``, with the formulas written out (no call to
    autograd) and the kernel's rounding points: p is rounded to qkv's dtype
    before ``p^T g``, ds before ``ds k`` and ``ds^T q``; every sum is f32.
    With ``lse``, the forward's f32 (B, H, N) row log-sum-exp, p is
    ``exp(logits - lse)`` as the kernel makes it; without, the softmax.
    (B, N, 3C), (B, N, C), (B, N, C) -> (B, N, 3C) in qkv's dtype."""
    b, n, c3 = qkv.shape
    hc = c3 // 3 // num_heads
    scale = hc**-0.5
    q, k, v = (t.float() for t in split_qkv(qkv, num_heads, split_qkv_first))
    gh = _heads(g, num_heads).float()
    oh = _heads(o, num_heads).float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if lse is None:
        p = torch.softmax(logits, dim=-1)
    else:
        p = torch.exp(logits - lse.float()[..., None])
    p = p.to(qkv.dtype).float()
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    d = torch.stack([dq, dk, dv])  # (3, B, H, N, hc)
    if split_qkv_first:
        d = d.permute(1, 3, 0, 2, 4)  # (B, N, 3, H, hc)
    else:
        d = d.permute(1, 3, 2, 0, 4)  # (B, N, H, 3, hc)
    return d.reshape(b, n, c3).to(qkv.dtype)


def _set_error_string(lib: ctypes.CDLL) -> None:
    lib.nd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nd_cuda_error_string.restype = ctypes.c_char_p


_STRIDES = ctypes.c_longlong * 3


def _library() -> ctypes.CDLL:
    lib = _build.load_library("attention")
    fn = lib.nd_fused_qkv_attention_lse
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.nd_mha_attention.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.nd_mha_attention.restype = ctypes.c_int
        _set_error_string(lib)
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load_library("attention_bwd")
    fn = lib.nd_fused_qkv_attention_bwd_lse
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _set_error_string(lib)
    return lib


def _check(qkv: torch.Tensor, num_heads: int, kernel: str = "K1") -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"{kernel} takes a (B, N, 3C) projection, got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError(f"{kernel} takes a contiguous (B, N, 3C) projection")
    c = qkv.shape[2] // 3
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    hc = c // num_heads
    if hc not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel} has no build for head dim {hc} (qkv {tuple(qkv.shape)}, "
            f"{num_heads} heads); it supports {SUPPORTED_HEAD_DIMS}."
        )


def _check_out(kernel: str, out: torch.Tensor, shape, like: torch.Tensor) -> None:
    if (out.shape != shape or out.dtype != like.dtype or out.device != like.device
            or not out.is_contiguous()):
        raise ValueError(
            f"{kernel} takes a contiguous out of shape {tuple(shape)} and dtype "
            f"{like.dtype} on {like.device}, got {tuple(out.shape)} {out.dtype} on {out.device}"
        )


def _check_lse(kernel: str, lse: torch.Tensor, shape, like: torch.Tensor) -> None:
    if (lse.shape != shape or lse.dtype != torch.float32 or lse.device != like.device
            or not lse.is_contiguous()):
        raise ValueError(
            f"{kernel} takes a contiguous float32 lse of shape {tuple(shape)} on "
            f"{like.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}"
        )


def _forward(qkv: torch.Tensor, num_heads: int, split_qkv_first: bool,
             out: torch.Tensor | None = None,
             lse: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor; ``lse``, an
    f32 (B, H, N), receives the row log-sum-exp."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    if lse is not None:
        _check_lse("K1", lse, (b, num_heads, n), qkv)
    if qkv.device.type == "cpu":
        res, logits = _attend(qkv, num_heads, split_qkv_first)
        if lse is not None:
            lse.copy_(torch.logsumexp(logits, dim=-1))
        return res if out is None else out.copy_(res)
    if qkv.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {qkv.device}")
    _check(qkv, num_heads)
    if out is None:
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    else:
        _check_out("K1", out, (b, n, c), qkv)
    with torch.cuda.device(qkv.device):
        lib = _library()
        err = lib.nd_fused_qkv_attention_lse(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, n, c, num_heads,
            int(split_qkv_first), _DTYPE_CODES[qkv.dtype],
            (c // num_heads) ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"K1 launch failed: {lib.nd_cuda_error_string(err).decode()} "
            f"(qkv {tuple(qkv.shape)} {qkv.dtype}, {num_heads} heads)"
        )
    fused_qkv_attention.launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it on a 16-byte boundary (the bf16 kernel stages
    its operands with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_qkv_attention_bwd(
    qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor, num_heads: int,
    split_qkv_first: bool, lse: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cotangent of :func:`fused_qkv_attention` wrt qkv -> (B, N, 3C).

    ``g`` is the output cotangent and ``o`` the forward output, both
    (B, N, C) in qkv's dtype; ``lse`` the forward's f32 (B, H, N) row
    log-sum-exp (:func:`fused_qkv_attention`'s ``lse``). Without it the
    wrapper makes it with one K1 launch (counted on K1) before K2. CPU
    tensors take the plain version; CUDA tensors launch K2 (two kernels, one
    count) on the current stream: bf16 on the tensor cores, f32 on the CUDA
    cores. ``fused_qkv_attention_bwd.launches`` counts the launches.
    ``out``, a contiguous tensor like qkv (on 16 bytes in bf16), is written in
    place of a fresh ``torch.empty`` (a check pre-fills it to see that every
    element is written).
    """
    b, n, c3 = qkv.shape
    c = c3 // 3
    if lse is not None:
        _check_lse("K2", lse, (b, num_heads, n), qkv)
    if qkv.device.type == "cpu":
        res = fused_qkv_attention_bwd_plain(qkv, g, o, num_heads, split_qkv_first, lse)
        return res if out is None else out.copy_(res)
    if qkv.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {qkv.device}")
    _check(qkv, num_heads, "K2")
    for name, t, shape in (("g", g, (b, n, c)), ("o", o, (b, n, c)), ("out", out, (b, n, c3))):
        if t is not None and (t.shape != shape or t.dtype != qkv.dtype
                              or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(
                f"K2 takes a contiguous {name} of shape {shape} and dtype "
                f"{qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if qkv.dtype == torch.bfloat16:
        if out is not None and out.data_ptr() % 16:
            raise ValueError("K2 takes a bf16 out that starts on 16 bytes")
        qkv, g, o = _aligned(qkv), _aligned(g), _aligned(o)
    if lse is None:
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
        _forward(qkv, num_heads, split_qkv_first, lse=lse)  # counted on K1
    dqkv = torch.empty_like(qkv) if out is None else out
    # per-row delta = rowsum(g o), written by the dq kernel for the dk/dv kernel
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        lib = _bwd_library()
        err = lib.nd_fused_qkv_attention_bwd_lse(
            qkv.data_ptr(), g.data_ptr(), o.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr(), b, n, c, num_heads,
            int(split_qkv_first), _DTYPE_CODES[qkv.dtype],
            (c // num_heads) ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"K2 launch failed: {lib.nd_cuda_error_string(err).decode()} "
            f"(qkv {tuple(qkv.shape)} {qkv.dtype}, {num_heads} heads)"
        )
    fused_qkv_attention_bwd.launches += 1
    return dqkv


fused_qkv_attention_bwd.launches = 0


class _FusedQKVAttention(torch.autograd.Function):
    """Forward K1, backward K2 (their plain versions on CPU tensors).

    The residuals are qkv, the output and the f32 (B, H, N) row log-sum-exp
    that K1 writes beside the output, which K2 takes instead of recomputing
    it. The JAX package's custom VJP (nicediffusion_tpu/ops/attention.py)
    keeps qkv and the output only; the gradient is the same.
    """

    @staticmethod
    def forward(ctx, qkv, num_heads, split_qkv_first):
        b, n, _ = qkv.shape
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
        out = _forward(qkv, num_heads, split_qkv_first, lse=lse)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.split_qkv_first = num_heads, split_qkv_first
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        dqkv = fused_qkv_attention_bwd(qkv, g, out, ctx.num_heads, ctx.split_qkv_first, lse=lse)
        return dqkv, None, None


def fused_qkv_attention(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool,
    out: torch.Tensor | None = None, lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q k^T * hc^-0.5) v over a (B, N, 3C) projection -> (B, N, C).

    CPU tensors take the plain version; CUDA tensors launch K1 on the
    current stream. ``fused_qkv_attention.launches`` counts the launches.
    When a gradient wrt qkv is wanted the call goes through the autograd
    Function, whose backward is :func:`fused_qkv_attention_bwd`. ``out``, a
    contiguous (B, N, C) tensor like qkv, is written in place of a fresh
    ``torch.empty`` (a check pre-fills it to see that every element is
    written). ``lse``, a contiguous f32 (B, H, N), receives each row's
    log-sum-exp of the scaled logits, ``ln sum_j exp(q k_j * hc^-0.5)``, which
    K2 takes. Neither can be combined with a gradient.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        if out is not None or lse is not None:
            raise ValueError("K1 writes no caller's out or lse under autograd")
        return _FusedQKVAttention.apply(qkv, num_heads, split_qkv_first)
    return _forward(qkv, num_heads, split_qkv_first, out, lse)


fused_qkv_attention.launches = 0


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K5: f32 logits scaled by D^-0.5 and f32
    softmax, p cast to v's dtype before the product with v.
    (B, H, N, D) x 3 -> (B, H, N, D)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhtc,bhsc->bhts", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsc->bhtc", weights, v).to(q.dtype)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T * D^-0.5) v over separate (B, H, N, D) q, k and v ->
    a contiguous (B, H, N, D).

    The three may have any batch, head and row strides (views of a fused
    projection, say) as long as the last axis is contiguous; D is any value
    up to 256. CPU tensors take the plain version; CUDA tensors launch K5 on
    the current stream. ``mha_attention.launches`` counts the launches. No
    autograd: the JAX function it replaces has no VJP either. ``out``, a
    contiguous tensor like q, is written in place of a fresh ``torch.empty``.
    """
    if not (q.shape == k.shape == v.shape and q.ndim == 4):
        raise ValueError(
            f"K5 takes three (B, H, N, D) tensors of one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("K5 takes q, k and v of one dtype on one device")
    if q.device.type == "cpu":
        res = mha_attention_plain(q, k, v)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"K5 takes float32 or bfloat16, got {q.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("K5 has no backward (the JAX function has no VJP)")
    b, h, n, d = q.shape
    if d > SUPPORTED_HEAD_DIMS[-1] or 0 in q.shape:
        raise NotImplementedError(
            f"K5 takes non-empty tensors with D up to {SUPPORTED_HEAD_DIMS[-1]}, "
            f"got {tuple(q.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"K5 takes {name} with a contiguous last axis, got strides {t.stride()}")
    if out is None:
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    else:
        _check_out("K5", out, (b, h, n, d), q)
    with torch.cuda.device(q.device):
        lib = _library()
        err = lib.nd_mha_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d,
            _STRIDES(*q.stride()[:3]), _STRIDES(*k.stride()[:3]), _STRIDES(*v.stride()[:3]),
            _DTYPE_CODES[q.dtype], d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"K5 launch failed: {lib.nd_cuda_error_string(err).decode()} "
            f"(q {tuple(q.shape)} {q.dtype}, strides {q.stride()})"
        )
    mha_attention.launches += 1
    return out


mha_attention.launches = 0
