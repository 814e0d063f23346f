"""K1 and K2: fused-qkv multi-head attention, forward and backward, CUDA C++.

K1 (``csrc/attention.cu``) replaces the TPU kernel
nicediffusion_tpu/ops/pallas/attention.py :: mha_attention_fused_qkv, and K2
(``csrc/attention_bwd.cu``) replaces mha_attention_fused_qkv_bwd in the same
file. The source notes say what bounds each kernel on the card and what the
designs do about the TPU kernels' whole-(N, N)-in-VMEM, one-program-per-
batch-element form, which does not fit a Hopper block's shared memory.

Dispatch: a CPU tensor goes to the plain torch version of the same function
(:func:`fused_qkv_attention_plain`, :func:`fused_qkv_attention_bwd_plain`).
A CUDA tensor launches the kernel or raises on what the kernel does not
take; nothing falls back. The libraries are built from the package's source
by ``_build`` at the first launch.

Under autograd :func:`fused_qkv_attention` is a ``torch.autograd.Function``
whose forward is K1 and whose backward is K2, with qkv and the forward
output saved, as the JAX package's custom VJP does. Without a gradient to
take it calls K1 directly and saves nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "SUPPORTED_HEAD_DIMS",
    "split_qkv",
    "fused_qkv_attention",
    "fused_qkv_attention_plain",
    "fused_qkv_attention_bwd",
    "fused_qkv_attention_bwd_plain",
]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
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


def fused_qkv_attention_plain(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool
) -> torch.Tensor:
    """The plain torch version of K1: f32 logits and softmax, p cast to v's
    dtype before the product with v. (B, N, 3C) -> (B, N, C)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    hc = c // num_heads
    q, k, v = split_qkv(qkv, num_heads, split_qkv_first)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hc**-0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights, v)
    return out.transpose(1, 2).reshape(b, n, c).to(qkv.dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) with heads contiguous -> (B, H, N, hc)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor, num_heads: int,
    split_qkv_first: bool,
) -> torch.Tensor:
    """The plain torch version of K2: the cotangent of
    :func:`fused_qkv_attention_plain` wrt qkv from the output cotangent ``g``
    and the forward output ``o``, with the formulas written out (no call to
    autograd) and the kernel's rounding points: p is rounded to qkv's dtype
    before ``p^T g``, ds before ``ds k`` and ``ds^T q``; every sum is f32.
    (B, N, 3C), (B, N, C), (B, N, C) -> (B, N, 3C) in qkv's dtype."""
    b, n, c3 = qkv.shape
    hc = c3 // 3 // num_heads
    scale = hc**-0.5
    q, k, v = (t.float() for t in split_qkv(qkv, num_heads, split_qkv_first))
    gh = _heads(g, num_heads).float()
    oh = _heads(o, num_heads).float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
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


def _library() -> ctypes.CDLL:
    lib = _build.load_library("attention")
    fn = lib.nd_fused_qkv_attention
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _set_error_string(lib)
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load_library("attention_bwd")
    fn = lib.nd_fused_qkv_attention_bwd
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
            f"{num_heads} heads); it supports {SUPPORTED_HEAD_DIMS}. Head dims "
            "192 and 256 (openai_128) are listed in ROADMAP queue B"
        )


def _forward(qkv: torch.Tensor, num_heads: int, split_qkv_first: bool) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, split_qkv_first)
    if qkv.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {qkv.device}")
    _check(qkv, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        lib = _library()
        err = lib.nd_fused_qkv_attention(
            qkv.data_ptr(), out.data_ptr(), b, n, c, num_heads,
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


def fused_qkv_attention_bwd(
    qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor, num_heads: int,
    split_qkv_first: bool, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cotangent of :func:`fused_qkv_attention` wrt qkv -> (B, N, 3C).

    ``g`` is the output cotangent and ``o`` the forward output, both
    (B, N, C) in qkv's dtype. CPU tensors take the plain version; CUDA
    tensors launch K2 (two kernels, one count) on the current stream.
    ``fused_qkv_attention_bwd.launches`` counts the launches. ``out``, a
    contiguous tensor like qkv, is written in place of a fresh
    ``torch.empty`` (a check pre-fills it to see that every element is
    written).
    """
    if qkv.device.type == "cpu":
        res = fused_qkv_attention_bwd_plain(qkv, g, o, num_heads, split_qkv_first)
        return res if out is None else out.copy_(res)
    if qkv.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {qkv.device}")
    _check(qkv, num_heads, "K2")
    b, n, c3 = qkv.shape
    c = c3 // 3
    for name, t, shape in (("g", g, (b, n, c)), ("o", o, (b, n, c)), ("out", out, (b, n, c3))):
        if t is not None and (t.shape != shape or t.dtype != qkv.dtype
                              or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(
                f"K2 takes a contiguous {name} of shape {shape} and dtype "
                f"{qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    dqkv = torch.empty_like(qkv) if out is None else out
    # per-row log-sum-exp and delta, written by the dq kernel for the dk/dv kernel
    stats = torch.empty((2, b, num_heads, n), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        lib = _bwd_library()
        err = lib.nd_fused_qkv_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), o.data_ptr(), dqkv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), b, n, c, num_heads,
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
    """Forward K1, backward K2 (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, split_qkv_first):
        out = _forward(qkv, num_heads, split_qkv_first)
        ctx.save_for_backward(qkv, out)
        ctx.num_heads, ctx.split_qkv_first = num_heads, split_qkv_first
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        dqkv = fused_qkv_attention_bwd(qkv, g, out, ctx.num_heads, ctx.split_qkv_first)
        return dqkv, None, None


def fused_qkv_attention(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool
) -> torch.Tensor:
    """softmax(q k^T * hc^-0.5) v over a (B, N, 3C) projection -> (B, N, C).

    CPU tensors take the plain version; CUDA tensors launch K1 on the
    current stream. ``fused_qkv_attention.launches`` counts the launches.
    When a gradient wrt qkv is wanted the call goes through the autograd
    Function, whose backward is :func:`fused_qkv_attention_bwd`.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedQKVAttention.apply(qkv, num_heads, split_qkv_first)
    return _forward(qkv, num_heads, split_qkv_first)


fused_qkv_attention.launches = 0
