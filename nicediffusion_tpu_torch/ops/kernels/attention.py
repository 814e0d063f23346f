"""K1: fused-qkv multi-head attention forward, CUDA C++ (``csrc/attention.cu``).

Replaces the TPU kernel nicediffusion_tpu/ops/pallas/attention.py ::
mha_attention_fused_qkv. The source note in ``csrc/attention.cu`` says what
bounds the kernel on the card and what its flash-style design does about
the TPU kernel's whole-(N, N)-in-VMEM form, which does not fit a Hopper
block's shared memory.

Dispatch: a CPU tensor goes to :func:`fused_qkv_attention_plain`, the plain
torch version of the same function. A CUDA tensor launches the kernel or
raises on what the kernel does not take; nothing falls back. The library is
built from the package's source by ``_build`` at the first launch.
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
        lib.nd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"K1 takes a (B, N, 3C) projection, got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("K1 takes a contiguous (B, N, 3C) projection")
    c = qkv.shape[2] // 3
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    hc = c // num_heads
    if hc not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(
            f"K1 has no build for head dim {hc} (qkv {tuple(qkv.shape)}, "
            f"{num_heads} heads); it supports {SUPPORTED_HEAD_DIMS}. Head dims "
            "192 and 256 (openai_128/256) are listed in ROADMAP queue B"
        )
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(
            "K1 is forward only; its backward (K2) is ROADMAP queue B"
        )


def fused_qkv_attention(
    qkv: torch.Tensor, num_heads: int, split_qkv_first: bool
) -> torch.Tensor:
    """softmax(q k^T * hc^-0.5) v over a (B, N, 3C) projection -> (B, N, C).

    CPU tensors take the plain version; CUDA tensors launch K1 on the
    current stream. ``fused_qkv_attention.launches`` counts the launches.
    """
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


fused_qkv_attention.launches = 0
