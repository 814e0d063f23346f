"""The Winograd F(2x2, 3x3) conv of a bf16 forward with grad mode off, CUDA C++.

Replaces no Pallas kernel: the JAX package computes
nicediffusion_tpu/ops/winograd.py::winograd_conv_3x3 (``:63``) as an XLA
composition (tile gathers, einsum transforms, 16 batched dot_generals), the
opt-in path of ``DiffusionModel(winograd=True)``. ``csrc/winograd.cu`` runs
the whole function in one launch: the input transform into shared memory,
the 16 products on the tensor cores (wgmma, bf16 in, f32 sums), split over a
cluster of four blocks (block r the four positions of row r of V, two
m64nFT products a consumer warpgroup, two producer warpgroups making V into
an mbarrier ring that TMA feeds), and the output transform after M is traded
through distributed shared memory, so neither V nor M touches device memory.
Its note says what bounds it.

Semantics: ops/winograd.py's, operation for operation. V = B^T d B rounded
to bf16 twice, rows first (the kernel's V is the plain version's, bit for
bit); M_p = V_p U_p summed over C in f32; Y = A^T M A in f32, rows first;
plus the f32 bias, one rounding to bf16. U, the transformed weight, comes
from the caller (``transform_weights_3x3``: (16, F, C) bf16, channels
innermost; ``WinogradConv`` keeps it between calls). Against the plain
version only the order of M's f32 sums differs.

The order of sums is fixed: each element of M sums its channels in 32-channel
steps in ascending order (two k16 halves a step, each one wgmma), then A^T M A
in one fixed order; nothing splits C, and a tile's row of M never sees the
other tiles of its unit. :func:`winograd_conv_plan` reads (H, W, C, F), never
the batch: bf16 serving through it stays batch-position independent, and
every build since the first gives the same bits.

Dispatch: a CPU tensor goes to :func:`winograd_conv_nhwc_plain`; a CUDA
tensor launches the kernel or raises. Nothing falls back.
``winograd_conv_nhwc.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..winograd import winograd_conv_3x3

__all__ = ["winograd_conv_nhwc", "winograd_conv_nhwc_plain", "winograd_conv_plan",
           "winograd_conv_units", "winograd_filter_tile"]

TILES = 64  # Winograd tiles a work unit: wgmma's M
CLUSTER = 4  # blocks a unit: block r makes positions 4 r to 4 r + 3 (row r of V)
FILTER_TILES = (64, 128)  # filters a unit: wgmma's N
CHANNEL_STEP = 32  # channels a K step: one 64-byte bf16 row


def winograd_filter_tile(f: int) -> int:
    """The kernel's filter tile for F filters (csrc/winograd.cu's
    ``winograd_filter_tile``): of 128 and 64, the one whose shared-memory
    bytes a step (V's 32 KB and U's FT / 2 KB, written and read) over the
    padded filters are fewer, 128 on a tie."""
    return 64 if -(-f // 64) * 64 < -(-f // 128) * 96 else 128


def winograd_conv_plan(h: int, w: int, c: int, f: int) -> dict[str, int]:
    """The kernel's plan for a conv over (h, w) maps of c channels into f
    filters: tiles and filters a unit, blocks a unit (the cluster), the
    channel step and the steps, the tile grid of one map. The batch plays no
    part."""
    ft = winograd_filter_tile(f)
    return {"tiles": TILES, "filters": ft, "cluster": CLUSTER, "channel_step": CHANNEL_STEP,
            "steps": -(-c // CHANNEL_STEP), "tile_rows": -(-h // 2), "tile_cols": -(-w // 2),
            "filter_tiles": -(-f // ft)}


def winograd_conv_units(b: int, h: int, w: int, c: int, f: int) -> int:
    """Blocks of the kernel's grid for ``b`` examples: 64-tile groups (tiles
    of all examples numbered in one sequence) times filter tiles, a cluster
    of four blocks each."""
    plan = winograd_conv_plan(h, w, c, f)
    return (-(-b * plan["tile_rows"] * plan["tile_cols"] // TILES) * plan["filter_tiles"]
            * CLUSTER)


def winograd_conv_nhwc_plain(x: torch.Tensor, u: torch.Tensor,
                             bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version: ops/winograd.py's function on the
    transformed weight ``u`` (16, F, C), output in x's type."""
    return winograd_conv_3x3(x, None, bias, u=u)


def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("winograd", {"nd_winograd_conv": [p, p, p, p, *[i] * 5, p]})


def _launch(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    if x.dtype != torch.bfloat16 or u.dtype != torch.bfloat16:
        raise TypeError(f"the Winograd conv kernel takes bfloat16 x and u, got {x.dtype} and "
                        f"{u.dtype}")
    if x.ndim != 4 or 0 in x.shape:
        raise ValueError(f"the Winograd conv takes a non-empty NHWC tensor, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if u.ndim != 3 or u.shape[0] != 16 or u.shape[2] != c or u.device != x.device:
        raise ValueError(f"the Winograd conv takes a (16, F, {c}) u on {x.device}, got "
                         f"{tuple(u.shape)} on {u.device}")
    f = u.shape[1]
    if bias is not None and (bias.shape != (f,) or bias.device != x.device):
        raise ValueError(f"the Winograd conv takes an ({f},) bias on {x.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    x, u = x.contiguous(), u.contiguous()
    if bias is not None:
        bias = bias.detach().float().contiguous()
    out = torch.empty((b, h, w, f), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_winograd_conv(
            x.data_ptr(), u.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, h, w, c, f, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise _build.launch_error(lib, err, "Winograd conv",
                                  f"x {tuple(x.shape)}, u {tuple(u.shape)}")
    winograd_conv_nhwc.launches += 1
    return out


def winograd_conv_nhwc(x: torch.Tensor, u: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv by F(2x2, 3x3): x (B, H, W, C) bf16, u
    (16, F, C) bf16 from ``transform_weights_3x3``, bias (F,) (added in f32)
    or None -> (B, H, W, F) bf16. CPU tensors take the plain version; CUDA
    tensors launch the kernel once on the current stream."""
    if x.device.type == "cpu":
        return winograd_conv_nhwc_plain(x, u, bias)
    if x.device.type != "cuda":
        raise ValueError(f"the Winograd conv runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, u, bias)


winograd_conv_nhwc.launches = 0
