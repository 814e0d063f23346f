"""Winograd F(2x2, 3x3) convolution (torch), counterpart of
nicediffusion_tpu/ops/winograd.py.

A SAME-padded stride-1 3x3 conv computed on overlapping 4x4 input tiles at
stride 2 (Lavin & Gray, arXiv:1509.09308): each tile ``d`` goes to
``V = B^T d B``, the weights to ``U = G g G^T``, the 16 transform positions
multiply as 16 products ``M_p = V_p U_p`` over the channels, and each tile's
2x2 outputs are ``Y = A^T M A``. 16 products per tile of four outputs against
the direct conv's 9 taps per output: 4/9 of its multiplies.

Numerics follow the JAX function operation for operation:

  * the weights, already in the compute type (``WinogradConv`` casts them
    first), go to f32; ``G g G^T`` there, rows first, each sum left to right
    (the order of XLA's dot on the CPU); then back to the compute type;
  * the input transform stays in the compute type: ``B^T d`` (rows), then
    ``(B^T d) B`` (columns), each rounded to the compute type (in bf16 two
    roundings, which is what JAX's three-operand einsum gives, bit for bit);
  * the products take the operands in f32 (bf16 values are exact there, and
    in TF32 too) and sum over C in f32;
  * ``A^T M A`` in f32, rows first; the bias (the f32 parameter, not rounded)
    is added in f32, then one cast to the output type. Odd H and W are padded
    with zeros on the far side to even and sliced back.

:func:`winograd_conv_3x3` is the whole function in plain torch: the path of
f32, of a gradient (training, a guidance gradient) and of ``kernels=False``,
and the plain version that the kernel (ops/kernels/winograd.py) is held to.
Tensors are NHWC; the weight is the port's (F, C, 3, 3); ``U`` is laid out
(16, F, C), channels innermost, the layout the kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["transform_weights_3x3", "input_tiles", "input_transform", "winograd_conv_3x3"]

# F(2x2, 3x3) transform matrices (Lavin & Gray 2015, eq. 10): the port's own
# copies of the JAX module's
_B_T = np.array(
    [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32
)
_G = np.array(
    [[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32
)
_A_T = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)


def _rows(mat: np.ndarray, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``mat @ x`` along ``dim`` (x's size there is mat's column count), each
    output the left-to-right sum of its terms, with the zero coefficients
    skipped (a zero product leaves a sum unchanged). Elementwise, so the bits
    do not depend on the device."""
    parts = x.unbind(dim)
    out = []
    for row in mat:
        acc = None
        for coef, part in zip(row.tolist(), parts):
            if coef == 0:
                continue
            term = part if coef == 1 else -part if coef == -1 else part * coef
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, dim)


def transform_weights_3x3(w: torch.Tensor) -> torch.Tensor:
    """(F, C, 3, 3) weight in the compute type -> U = G g G^T, (16, F, C) in
    the same type: position p = 4 i + l holds U[i, l], channels innermost.
    Computed in f32 (16 * 9 * C * F multiplies, about 1e-5 of a conv)."""
    g = w.float().permute(2, 3, 0, 1)  # (3, 3, F, C): g[j, k]
    u = _rows(_G, _rows(_G, g, 0), 1)  # G g (rows), then (G g) G^T (columns)
    return u.reshape(16, *u.shape[2:]).to(w.dtype)


def input_tiles(x: torch.Tensor) -> torch.Tensor:
    """The overlapping 4x4 tiles at stride 2 of x (N, H, W, C) SAME-padded by
    one, and padded with zeros on the far side to even H and W: (N, th, tw, 4,
    4, C) with th = ceil(H / 2), tw = ceil(W / 2)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1 + w % 2, 1, 1 + h % 2))
    return xp.unfold(1, 4, 2).unfold(2, 4, 2).permute(0, 1, 2, 4, 5, 3)


def input_transform(tiles: torch.Tensor) -> torch.Tensor:
    """V = B^T d B of each tile (…, 4, 4, C), in the tiles' type: the rows
    (B^T d), rounded, then the columns, rounded."""
    return _rows(_B_T, _rows(_B_T, tiles, -3), -2)


def winograd_conv_3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      out_dtype: torch.dtype | None = None, u: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv of NHWC ``x`` with the (F, C, 3, 3)
    weight ``w`` (in x's type) through F(2x2, 3x3); ``bias`` (F,) is added in
    f32; the output is in ``out_dtype`` (default x's). ``u``, the transformed
    weight, may be handed over instead of being made from ``w``."""
    n, h, wd, c = x.shape
    if u is None:
        u = transform_weights_3x3(w)
    v = input_transform(input_tiles(x))  # (N, th, tw, 4, 4, C)
    th, tw = v.shape[1], v.shape[2]
    # M_p = V_p U_p^T for the 16 positions, the operands in f32 and the sums
    # over C in f32 (torch's default; under TF32 an f32 x would be rounded,
    # bf16 values are exact in either)
    m = torch.bmm(v.reshape(-1, 16, c).transpose(0, 1).float(), u.float().transpose(1, 2))
    m = m.transpose(0, 1).reshape(n, th, tw, 4, 4, -1)
    y = _rows(_A_T, _rows(_A_T, m, -3), -2)  # A^T M A, rows first: (N, th, tw, 2, 2, F)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * th, 2 * tw, -1)[:, :h, :wd]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)
