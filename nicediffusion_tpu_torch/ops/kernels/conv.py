"""The bf16 convolution of sampling and serving, CUDA C++.

Replaces no TPU kernel: the JAX package runs its convs in XLA (flax
``nn.Conv`` with ``dtype=bf16``). The port ran them through cuDNN, whose
bf16 engines sum a row in an order that moves with its batch
(``tools/find_batch_variance.py`` names the calls), so the serving daemon's
bf16 output for a (seed, label) depended on its batch mates. The dense
products stay with cuBLAS: the tool finds none of them moving a row.
``csrc/bf16conv.cu`` runs them on the tensor cores (wgmma, bf16 in, f32
sums), one launch a call, every output element summed in one fixed order
per route (the halo route: 32-channel steps, then kernel rows, then
columns; the row route: taps, then 32-channel steps), nothing split across
blocks or warps. The kernel is warp-specialised and persistent: a producer
warpgroup fills a ring of stages by TMA (by cp.async where C is not a
multiple of 8 or x is off 16 bytes), two consumer warpgroups multiply and
store by TMA (from registers where F is not a multiple of 8), and one block
a multiprocessor walks the work units. Its note says what bounds it.

Semantics, flax's rounding: ``bf16(bf16(sum) + bf16(bias))``, the sum of
the exact products in f32, the bias added to the rounded product in bf16
(both bf16 values summed in f32, then one rounding); zero padding k // 2,
stride 1 or 2, k 1 or 3. A dense layer is a 1 x 1 conv over a (1, 1, M, C)
view (the row route takes it; the model's dense layers do not use it).

The weight is the model's (F, C, k, k) parameter, of any float type: the
wrapper casts it to bf16 into (F, k, k, C), channels innermost, in one copy.

Dispatch: a CPU tensor goes to :func:`conv_nhwc_plain`; a CUDA tensor
launches the kernel or raises. Nothing falls back. :func:`conv_nhwc_plan`
picks the route and the filter tile from the map (H, W), k, stride and F,
never from the batch; no choice of tile, grid or loading way changes a
sum's order, so the bits do not depend on them either.
``conv_nhwc.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv_nhwc", "conv_nhwc_plain", "conv_nhwc_plan", "conv_nhwc_units", "plan_for"]

ROUTES = ("row", "halo")  # the kernel's route codes, in order
FILTER_TILES = (192, 128, 64)
# the kernel's ways to move data, by its staging code: TMA loads and stores
# where a call allows them, cp.async loads, stores from registers, or both
STAGINGS = {"tma": 0, "copy_loads": 1, "copy_stores": 2, "copy": 3}
# the plan fills the card at this batch and these multiprocessors (the
# H100's), whatever the call's batch; a unit's time grows as its filter
# tile's 64-column blocks plus PLAN_UNIT_COST of fixed work (its barriers
# and waits, its epilogue)
PLAN_BATCH = 16
PLAN_SMS = 132
PLAN_UNIT_COST = 0.3


def conv_nhwc_units(b: int, h: int, w: int, k: int, stride: int, f: int, tile: int) -> int:
    """Work units of the kernel for a conv of ``b`` examples of (h, w) maps:
    on the halo route (stride-1 3 x 3) pairs of 8 x 8 output tiles, on the
    row route 128 output pixels, each times the filter tiles of ``tile``."""
    ftiles = -(-f // tile)
    if k == 3 and stride == 1:
        return -(-b * -(-h // 8) * -(-w // 8) // 2) * ftiles
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return -(-b * ho * wo // 128) * ftiles


def conv_nhwc_plan(h: int, w: int, k: int, stride: int, f: int) -> tuple[str, int]:
    """(route, filter tile) of the kernel for a conv over (h, w) maps of size
    ``k``, stride ``stride`` and ``f`` filters: the halo route for stride-1
    3 x 3, the row route for the rest (1 x 1, stride 2, the dense view). The
    tile is one of 192, 128 and 64 that divides F (no zero products; 64 where
    none does), the one whose units at PLAN_BATCH take the fewest waves of
    PLAN_SMS blocks times a unit's cost, the widest on a tie: small maps
    split into enough units to fill the card. The batch plays no part, and
    no tile changes a sum's order."""
    route = "halo" if k == 3 and stride == 1 else "row"
    whole = [t for t in FILTER_TILES if f % t == 0] or [64]

    def cost(t):
        waves = -(-conv_nhwc_units(PLAN_BATCH, h, w, k, stride, f, t) // PLAN_SMS)
        return waves * (t // 64 + PLAN_UNIT_COST)

    return route, min(whole, key=cost)


def plan_for(x_shape: tuple[int, ...], f: int, k: int, stride: int) -> tuple[str, int]:
    """The plan of a call on x of shape (B, H, W, C): :func:`conv_nhwc_plan`
    of its map, the batch dropped."""
    _, h, w, _ = x_shape
    return conv_nhwc_plan(h, w, k, stride, f)


def _round_bias(y: torch.Tensor, bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """f32 sums -> ``dtype``, plus the bias in ``dtype`` (flax's rounding)."""
    y = y.to(dtype)
    if bias is None:
        return y
    return (y.float() + bias.detach().to(dtype).float()).to(dtype)


def conv_nhwc_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                    stride: int = 1) -> torch.Tensor:
    """The plain torch version: each example by its own f32 conv of the
    operands rounded to x's type and upcast (in bf16 every product exact,
    the sums f32), then the kernel's rounding. One call per example, of one
    shape whatever the batch, so an example's output is a function of that
    example alone, bit for bit. x (B, H, W, C) bf16 (or f32, for the
    comparison with the JAX package), weight (F, C, k, k) -> (B, Ho, Wo, F)
    in x's type."""
    w = weight.detach().to(x.dtype).float()
    k = w.shape[-1]
    outs = [F.conv2d(x[i:i + 1].permute(0, 3, 1, 2).float(), w, stride=stride, padding=k // 2)
            for i in range(x.shape[0])]
    return _round_bias(torch.cat(outs).permute(0, 2, 3, 1), bias, x.dtype)


def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("bf16conv", {"nd_bf16_conv": [p, p, p, p, *[i] * 11, p]})


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int,
            filter_tile: int | None, blocks: int | None = None,
            staging: str | None = None) -> torch.Tensor:
    """The kernel on x (B, H, W, C) bf16 and an (F, C, k, k) weight."""
    if x.device.type != "cuda":
        raise ValueError(f"the bf16 conv runs on CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 conv takes bfloat16 x, got {x.dtype}")
    if x.ndim != 4 or 0 in x.shape:
        raise ValueError(f"the bf16 conv takes a non-empty NHWC tensor, got {tuple(x.shape)}")
    if weight.ndim != 4 or weight.shape[2] != weight.shape[3] or weight.device != x.device:
        raise ValueError(f"the bf16 conv takes an (F, C, k, k) weight on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    f, c, k = weight.shape[0], weight.shape[1], weight.shape[3]
    if k not in (1, 3) or stride not in (1, 2):
        raise NotImplementedError(f"the bf16 conv kernel takes k in (1, 3) and stride in "
                                  f"(1, 2), got k={k}, stride={stride}")
    if x.shape[-1] != c:
        raise ValueError(f"the weight has {c} channels, x {x.shape[-1]}")
    if staging not in (None, *STAGINGS) or (blocks is not None and blocks < 1):
        raise ValueError(f"the bf16 conv takes staging in {tuple(STAGINGS)} and blocks >= 1, "
                         f"got {staging!r}, {blocks!r}")
    if bias is not None and (bias.shape != (f,) or bias.device != x.device):
        raise ValueError(f"the bf16 conv takes an ({f},) bias on {x.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    x = x.contiguous()
    # (F, C, k, k) of any float type -> (F, k, k, C) bf16, one copy
    w = torch.empty((f, k, k, c), dtype=torch.bfloat16, device=x.device)
    w.copy_(weight.detach().permute(0, 2, 3, 1))
    if bias is not None:
        bias = bias.detach().to(torch.bfloat16).contiguous()
    b, h, wd, _ = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    out = torch.empty((b, ho, wo, f), dtype=torch.bfloat16, device=x.device)
    route, tile = plan_for(tuple(x.shape), f, k, stride)
    if filter_tile is not None:
        tile = filter_tile
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.nd_bf16_conv(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, h, wd, c, f, k, stride, ROUTES.index(route), tile, blocks or 0,
            STAGINGS[staging or "tma"], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise _build.launch_error(
            lib, err, "bf16 conv", f"x {tuple(x.shape)}, weight {tuple(weight.shape)}, stride "
            f"{stride}, {route} route, {tile} filters a unit, blocks {blocks or 'one an SM'}, "
            f"staging {staging or 'tma'}")
    conv_nhwc.launches += 1
    return out


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
              stride: int = 1, filter_tile: int | None = None, blocks: int | None = None,
              staging: str | None = None) -> torch.Tensor:
    """The bf16 conv: x (B, H, W, C) bf16, weight (F, C, k, k) (k 1 or 3),
    bias (F,) or None, stride 1 or 2, padding k // 2 -> (B, Ho, Wo, F) bf16.
    CPU tensors take the plain version; CUDA tensors launch the kernel once on
    the current stream, on the route and tile of :func:`conv_nhwc_plan`, one
    persistent block a multiprocessor. To compare them (the bits stay the
    same): ``filter_tile`` 64, 128 or 192 overrides the tile, ``blocks`` caps
    the grid, ``staging`` "copy_loads", "copy_stores" or "copy" loads by
    cp.async, stores from registers or both where TMA would serve."""
    if x.device.type == "cpu":
        return conv_nhwc_plain(x, weight, bias, stride)
    return _launch(x, weight, bias, stride, filter_tile, blocks, staging)


conv_nhwc.launches = 0
