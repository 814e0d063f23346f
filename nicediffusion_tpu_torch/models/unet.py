"""UNet epsilon predictor (torch), counterpart of nicediffusion_tpu/models/unet.py.

Architecture as in the original reference's model.py:294-476 and the JAX
port of it: BigGAN-style ResidualBlocks (GN+SiLU -> optional in-block
up/down resample -> 3x3 conv -> AdaGN+SiLU or additive embedding + GN+SiLU
-> zero-init 3x3 conv, plus a skip), pre-norm AttentionBlocks over the
flattened tokens, a [cos|sin] timestep embedding through a 2-layer MLP plus
a class embedding, and a decoder that concatenates one encoder skip per
block.

Layout. Activations are NHWC tensors everywhere, at the boundary (like the
JAX package, so the tests compare like with like) and inside: GroupNorm (K3)
and attention (K1) read NHWC directly. A convolution views its NHWC input
as an NCHW tensor in channels_last memory (a permute, no copy), so cuDNN
runs its NHWC kernels and the result permutes back for free.

Parameters keep the original torch reference's module tree and names
(``downsampling.{i}.{j}.in_norm.weight``, ``qkv_nin`` as a Conv1d
``(O, I, 1)`` weight, ...), so the state dicts of utils/convert.py load with
``strict=True``. Precision follows the JAX package: parameters are stored
in f32 and cast to the compute ``dtype`` at each call (flax ``dtype=``);
the class embedding is never cast; GroupNorm statistics and the softmax are
f32; ``decode`` returns f32.

``kernels=True`` routes every GroupNorm through K3, every attention through
K1 and, in bf16 with grad mode off, every conv through the bf16 conv (whose
sums for a row do not depend on the batch: the serving daemon's promise);
``kernels=False`` takes the plain torch versions (cuDNN for the convs), for
comparing the two on the card. On CPU tensors the kernels' wrappers take their plain
versions either way.

Training. Dropout sits between ``out_norm`` and ``out_conv`` of every
ResidualBlock and is active only in ``train()`` mode; its mask is drawn from
the ``torch.Generator`` the caller hands to ``forward`` (no global RNG).
``use_remat=True`` wraps every ResidualBlock and AttentionBlock in
``torch.utils.checkpoint`` (non-reentrant) while a gradient is being taken;
the recompute replays the generator from the state it had when the block
first ran, so the dropout mask is the same, and puts the generator back
afterwards. Parameters are f32 and cast per call, so bf16 compute gives f32
gradients. A ``DropoutDraws`` may stand in for the generator: it hands out
the step's uniform draws made ahead, in the forward's order (what a
captured training step reads, training/graphs.py), and its cursor is the
state the recompute replays.

Static int8 serving (``quantized=True``; ``quantized_attention=True`` also
quantizes the attention projections). The residual blocks' convs, the
Upsample/Downsample convs and (optionally) the attention projections become
Int8Conv/Int8Dense, which keep the float layers' ``weight`` and ``bias``
(float checkpoints load with ``strict=True``); the stem and the output head
stay float, as in the JAX package. Each int8 layer owns its state and runs in
one of three modes, set by the model's methods (no global): under
``model.calibrating()`` the float compute, recording the running max |x| of
its input; after ``model.freeze_int8(calib)`` the static path (its
``kernel_q``, ``inv_act`` and ``deq`` buffers, not in the state dict), through
the int8 conv kernel; otherwise the dynamic path (ops/quant.py).

Winograd (``winograd=True``, opt-in and off by default, as in the JAX
package): every stride-1 3x3 conv that JAX routes so (the stem, the residual
blocks' ``in_conv`` and ``out_conv``, the Upsample convs; not the head, not
a stride-2 conv, and in an int8 model only the stem) becomes a
WinogradConv, F(2x2, 3x3) (ops/winograd.py), with the same ``weight`` and
``bias``: the same state dict loads either way. In bf16 with grad mode off
and ``kernels`` it runs the Winograd kernel (ops/kernels/winograd.py), whose
order of sums, like the bf16 conv's, does not see the batch; otherwise the
plain torch function. ``device=None`` means the CUDA card
(utils/device.py); the CPU has to be asked for.

Tensor parallelism (``shard_module_(model, mesh)`` or ``model.shard_(mesh)``,
with a mesh of parallel/mesh.py ``make_mesh(num_data, num_model)``): the
parameters are cut in place to the rank's shards by the Megatron-paired
table of parallel/sharding.py, and each block runs the collectives of
parallel/tensor.py over the model group. A paired ResidualBlock: ``in_norm``
(K3, 32 groups) on the replicated input, the column-parallel ``in_conv``,
the AdaGN ``out_norm`` (K3 at ``32 // tp`` groups on the rank's channels,
its scale and shift the rank's slice of the replicated step embedding),
dropout drawn at the whole channel count and sliced, the row-parallel
``out_conv``, one all-reduce, its bias, the skip. An AttentionBlock: the
column-parallel ``qkv_nin``, a gather of the (B, N, 3C) activation, K1 on
every head, the row-parallel ``proj_out``, one all-reduce. The timestep
MLP's Linear layers are column-parallel, each followed by a gather. A block
whose dimensions the table leaves replicated runs as without a mesh.
Construction and parameter names do not change.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import qkv_attention
from ..ops.groupnorm import ada_group_norm_silu, group_norm, group_norm_silu
from ..ops.kernels.conv import conv_nhwc
from ..ops.kernels.winograd import winograd_conv_nhwc
from ..ops.math import timestep_embedding
from ..ops.quant import (
    int8_conv,
    int8_conv_static,
    int8_dense,
    int8_dense_static,
    kernel_layout,
    static_quant_triple,
)
from ..ops.resize import avg_pool_2x, resize_bilinear, upsample_nearest_2x
from ..ops.winograd import transform_weights_3x3, winograd_conv_3x3
from ..parallel.sharding import shard_params, shard_tensor, unet_param_shard_dims
from ..parallel.tensor import copy_to_model, gather_from_model, reduce_from_model, scatter_to_model
from ..utils.device import resolve_device

__all__ = ["DiffusionModel", "DropoutDraws", "SuperResolutionModel", "Int8Conv", "Int8Dense",
           "WinogradConv", "shard_module_"]


class Conv2d(nn.Module):
    """k x k conv with symmetric k//2 padding on NHWC tensors; OIHW weight.
    With ``kernels`` (the model's) a bf16 call with grad mode off
    (sampling, serving, a distiller's teacher) runs the bf16 conv kernel
    (ops/kernels/conv.py), whose output row does not depend on its batch;
    with grad mode on (training, the classifier's guidance gradient), in f32
    and with ``kernels=False`` it stays with cuDNN."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 zero_init: bool = False, dtype=None, device=None, kernels: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, k // 2, dtype
        self.kernels = kernels
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_ch * k * k))

    def forward(self, x, add_bias: bool = True):
        dt = self.dtype or x.dtype
        if self.kernels and dt == torch.bfloat16 and not torch.is_grad_enabled():
            return conv_nhwc(x.to(dt), self.weight, self.bias if add_bias else None, self.stride)
        y = F.conv2d(
            x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
            self.bias.to(dt) if add_bias else None, stride=self.stride, padding=self.padding,
        )
        return y.permute(0, 2, 3, 1).contiguous()


class Linear(nn.Module):
    """Dense layer; ``conv1d_weight`` stores the weight as a Conv1d
    ``(O, I, 1)``, the reference's layout for ``qkv_nin`` and ``proj_out``."""

    def __init__(self, in_features: int, out_features: int, zero_init: bool = False,
                 conv1d_weight: bool = False, dtype=None, device=None):
        super().__init__()
        shape = (out_features, in_features) + ((1,) if conv1d_weight else ())
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_features))

    def forward(self, x, add_bias: bool = True):
        dt = self.dtype or x.dtype
        w = self.weight if self.weight.ndim == 2 else self.weight[:, :, 0]
        return F.linear(x.to(dt), w.to(dt), self.bias.to(dt) if add_bias else None)


class _Int8State:
    """What an int8 layer owns (JAX ``Int8Conv``/``Int8Dense``'s 'calib' and
    'quant' collections): ``absmax``, the running max |x| recorded while
    ``recording``; ``kernel_q`` (F, k, k, C) int8, ``inv_act`` (0-dim f32)
    and ``deq`` (F,) f32 once frozen. Buffers outside the state dict."""

    def _init_int8(self, kernels: bool):
        self.kernels, self.recording = kernels, False
        for name in ("absmax", "kernel_q", "inv_act", "deq"):
            self.register_buffer(name, None, persistent=False)

    def _record(self, x):
        a = x.detach().float().abs().amax()
        self.absmax = a if self.absmax is None else torch.maximum(self.absmax, a)

    def freeze(self, absmax):
        """Quantize the weights per output channel and keep the static scales
        (ops/quant.py static_quant_triple)."""
        with torch.no_grad():
            w_q, self.inv_act, self.deq = static_quant_triple(self.weight, absmax, axis=0)
            self.kernel_q = kernel_layout(w_q)


class Int8Conv(_Int8State, Conv2d):
    """A Conv2d with int8 x int8 -> int32 compute (JAX models/unet.py
    ``Int8Conv``): float while recording, the static path once frozen, the
    dynamic path otherwise. ``kernels=False`` takes the plain version of the
    int8 conv kernel."""

    def __init__(self, *args, kernels: bool = True, **kw):
        super().__init__(*args, kernels=kernels, **kw)
        self._init_int8(kernels)

    def forward(self, x):
        if self.recording:
            self._record(x)
            return super().forward(x)
        out_dtype = self.dtype or x.dtype
        if self.kernel_q is not None:
            return int8_conv_static(x, self.kernel_q, self.inv_act, self.deq, self.bias,
                                    self.stride, out_dtype, kernels=self.kernels)
        return int8_conv(x, self.weight, self.bias, self.stride, out_dtype, kernels=self.kernels)


class Int8Dense(_Int8State, Linear):
    """A Linear with the modes of Int8Conv (JAX ``Int8Dense``), for the
    attention projections; its product is the int8 conv kernel as a 1 x 1
    conv."""

    def __init__(self, *args, kernels: bool = True, **kw):
        super().__init__(*args, **kw)
        self._init_int8(kernels)

    def forward(self, x):
        if self.recording:
            self._record(x)
            return super().forward(x)
        out_dtype = self.dtype or x.dtype
        if self.kernel_q is not None:
            return int8_dense_static(x, self.kernel_q, self.inv_act, self.deq, self.bias,
                                     out_dtype, kernels=self.kernels)
        return int8_dense(x, self.weight, self.bias, out_dtype, kernels=self.kernels)


class WinogradConv(Conv2d):
    """A stride-1 3x3 Conv2d computed by Winograd F(2x2, 3x3) (JAX models/
    unet.py ``WinogradConv``): the same ``weight`` (OIHW) and ``bias``. The
    weight is cast to the compute type, then transformed; the f32 bias is
    added in f32 before the one rounding (not the bf16 conv's flax
    rounding). With ``kernels`` a bf16 call with grad mode off runs the
    Winograd kernel (ops/kernels/winograd.py); otherwise, and on CPU
    tensors, the plain torch function (ops/winograd.py).

    With grad mode off the transformed weight U is kept between calls, made
    anew when the weight changes (its storage or version counter): JAX's
    transform runs once per sampling chain, hoisted out of the scan as
    loop-invariant; here about 13 ms of elementwise work a full-width
    ``openai_64`` forward. Not in the state dict."""

    def __init__(self, in_ch: int, out_ch: int, zero_init: bool = False, dtype=None,
                 device=None, kernels: bool = True):
        super().__init__(in_ch, out_ch, 3, 1, zero_init, dtype, device, kernels=kernels)
        self._u = self._u_key = None

    def transformed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """U of the weight cast to ``dtype``, (16, F, C), made once per
        weight version (grad mode off; it carries no gradient). A weight made
        under ``torch.inference_mode`` has no version counter: its U is made
        each call."""
        w = self.weight
        if w.is_inference():
            return transform_weights_3x3(w.detach().to(dtype))
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._u_key != key:
            self._u, self._u_key = transform_weights_3x3(w.detach().to(dtype)), key
        return self._u

    def forward(self, x, add_bias: bool = True):
        dt = self.dtype or x.dtype
        x = x.to(dt)
        bias = self.bias if add_bias else None
        if torch.is_grad_enabled():
            return winograd_conv_3x3(x, self.weight.to(dt), bias)
        u = self.transformed_weight(dt)
        if self.kernels and dt == torch.bfloat16:
            return winograd_conv_nhwc(x, u, bias)
        return winograd_conv_3x3(x, None, bias, u=u)


def _conv(in_ch, out_ch, k, stride=1, zero_init=False, dtype=None, device=None,
          quantized=False, kernels=True, winograd=False):
    """JAX unet.py ``_conv``: an Int8Conv when quantized, else a WinogradConv
    for a stride-1 3x3 conv when ``winograd``, else a Conv2d."""
    if quantized:
        return Int8Conv(in_ch, out_ch, k, stride, zero_init, dtype, device, kernels=kernels)
    if winograd and k == 3 and stride == 1:
        return WinogradConv(in_ch, out_ch, zero_init, dtype, device, kernels=kernels)
    return Conv2d(in_ch, out_ch, k, stride, zero_init, dtype, device, kernels=kernels)


class GroupNormOp(nn.Module):
    """GroupNorm parameters, applied through the fused ops.

    mode: 'plain' -> GN only; 'silu' -> GN+SiLU; 'ada' -> AdaGN+SiLU taking
    (x, emb_scale, emb_shift).
    """

    def __init__(self, features: int, mode: str = "plain", num_groups: int = 32,
                 eps: float = 1e-5, kernels: bool = True, device=None):
        super().__init__()
        if mode not in ("plain", "silu", "ada"):
            raise ValueError(mode)
        self.mode, self.num_groups, self.eps, self.kernels = mode, num_groups, eps, kernels
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, emb_scale=None, emb_shift=None):
        args = (self.num_groups, self.eps, self.kernels)
        if self.mode == "ada":
            return ada_group_norm_silu(
                x, self.weight, self.bias, emb_scale, emb_shift, *args
            )
        if self.mode == "silu":
            return group_norm_silu(x, self.weight, self.bias, *args)
        return group_norm(x, self.weight, self.bias, *args)


class Upsample(nn.Module):
    """2x nearest upsample, optional 3x3 conv (reference model.py:51-80)."""

    def __init__(self, channels: int, with_conv: bool = True, dtype=None, device=None,
                 quantized: bool = False, kernels: bool = True, winograd: bool = False):
        super().__init__()
        self.conv = (
            _conv(channels, channels, 3, dtype=dtype, device=device, quantized=quantized,
                  kernels=kernels, winograd=winograd)
            if with_conv else None
        )

    def forward(self, x):
        x = upsample_nearest_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """2x downsample via stride-2 conv or avg-pool (reference model.py:83-112)."""

    def __init__(self, channels: int, with_conv: bool = True, dtype=None, device=None,
                 quantized: bool = False, kernels: bool = True):
        super().__init__()
        self.conv = (
            _conv(channels, channels, 3, stride=2, dtype=dtype, device=device,
                  quantized=quantized, kernels=kernels)
            if with_conv else None
        )

    def forward(self, x):
        return avg_pool_2x(x) if self.conv is None else self.conv(x)


class ResidualBlock(nn.Module):
    """BigGAN-style residual block with timestep conditioning
    (reference model.py:117-211). The skip is the identity when the channel
    count is kept, else a 1x1 conv."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, upsample: bool = False,
                 downsample: bool = False, use_adaptive_gn: bool = False,
                 dropout: float = 0.0, dtype=None, kernels: bool = True, device=None,
                 quantized: bool = False, winograd: bool = False):
        super().__init__()
        self.upsample, self.downsample = upsample, downsample
        self.use_adaptive_gn, self.dropout = use_adaptive_gn, dropout
        self.out_channels = out_ch
        self.tp = None  # the mesh, once shard_module_ pairs the block
        conv = functools.partial(_conv, dtype=dtype, device=device, quantized=quantized,
                                 kernels=kernels, winograd=winograd)
        self.in_norm = GroupNormOp(in_ch, "silu", kernels=kernels, device=device)
        self.in_conv = conv(in_ch, out_ch, 3)
        self.step_embedding = Linear(
            emb_dim, 2 * out_ch if use_adaptive_gn else out_ch, dtype=dtype, device=device
        )
        self.out_norm = GroupNormOp(
            out_ch, "ada" if use_adaptive_gn else "silu", kernels=kernels, device=device
        )
        self.out_conv = conv(out_ch, out_ch, 3, zero_init=True)
        self.skip = None if out_ch == in_ch else conv(in_ch, out_ch, 1)

    def forward(self, x, emb, generator=None):
        tp = self.tp
        h = self.in_norm(x)
        if self.upsample:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.downsample:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_conv(copy_to_model(h, tp))

        emb = self.step_embedding(F.silu(emb))
        if self.use_adaptive_gn:
            # (B, 2, C): the rank's channels of the scale half and the shift half
            emb = scatter_to_model(emb.unflatten(-1, (2, -1)), tp)
            h = self.out_norm(h, emb[:, 0], emb[:, 1])
        else:
            emb = scatter_to_model(emb, tp)
            h = self.out_norm(h + emb[:, None, None, :].to(h.dtype))

        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout in train() mode needs the caller's torch.Generator")
            # drawn at the whole channel count, the rank's channels kept
            keep = _uniform(generator, (*h.shape[:-1], self.out_channels),
                            h.device) >= self.dropout
            keep = shard_tensor(keep, -1 if tp else None, tp)
            h = h * keep / (1.0 - self.dropout)
        if tp is None:
            h = self.out_conv(h)
        else:
            h = reduce_from_model(self.out_conv(h, add_bias=False), tp)
            h = h + self.out_conv.bias.to(h.dtype)
        return h + (x if self.skip is None else self.skip(x))


class AttentionBlock(nn.Module):
    """Pre-norm multi-head self-attention over flattened HW tokens
    (reference model.py:214-291); num_head_channels supersedes num_heads
    when given; zero-init output projection with a residual add."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int | None = None, split_qkv_first: bool = True,
                 dtype=None, kernels: bool = True, device=None, quantized: bool = False):
        super().__init__()
        if num_head_channels is None:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(
                    f"channels {channels} not divisible by num_head_channels "
                    f"{num_head_channels}"
                )
            self.heads = channels // num_head_channels
        self.split_qkv_first, self.kernels = split_qkv_first, kernels
        # set by shard_module_: the mesh, and which projections are sharded
        self.tp, self.tp_qkv, self.tp_proj = None, False, False
        self.norm = GroupNormOp(channels, "plain", kernels=kernels, device=device)
        dense = functools.partial(Int8Dense, kernels=kernels) if quantized else Linear
        self.qkv_nin = dense(channels, 3 * channels, conv1d_weight=True,
                             dtype=dtype, device=device)
        self.proj_out = dense(channels, channels, zero_init=True, conv1d_weight=True,
                              dtype=dtype, device=device)

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = self.norm(x).reshape(b, hh * ww, c)
        if self.tp_qkv:  # column-parallel, then the (B, N, 3C) activation gathered
            qkv = gather_from_model(self.qkv_nin(copy_to_model(h, self.tp)), self.tp)
        else:
            qkv = self.qkv_nin(h)
        h = qkv_attention(qkv, self.heads, self.split_qkv_first, kernels=self.kernels)
        if self.tp_proj:  # row-parallel on the rank's channels, one all-reduce
            h = self.proj_out(scatter_to_model(h, self.tp), add_bias=False)
            h = reduce_from_model(h, self.tp) + self.proj_out.bias.to(h.dtype)
        else:
            h = self.proj_out(h)
        return x + h.reshape(b, hh, ww, c)


class DropoutDraws:
    """Stands in for the dropout generator of a model in ``train()`` mode:
    the uniform draws of one step's masks, made ahead of the forward in the
    order the forward takes them, so no generator is read inside it.

    The first step records: each draw is made from ``generator`` where the
    forward asks for it (the eager stream, bit for bit) and kept as a buffer.
    Each later step calls ``refill()`` first, which draws every buffer anew
    from ``generator`` in the same order, then the forward reads them. Since
    nothing else draws between a step's masks, the stream is the eager one.
    ``get_state()``/``set_state()`` read and set the cursor: the remat
    recompute (``_replay_generator``) takes the masks its block's first run
    took. (A CUDA capture can neither read nor set a generator's host-side
    offset; the cursor is host state alone.)"""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.buffers: list[torch.Tensor] = []
        self.cursor = 0

    def refill(self) -> None:
        """A new step: every buffer drawn anew, in the forward's order."""
        for u in self.buffers:
            torch.rand(u.shape, generator=self.generator, device=u.device, out=u)
        self.cursor = 0

    def uniform(self, shape, device) -> torch.Tensor:
        """The step's next draw of ``shape``: recorded on the first step,
        the buffer after."""
        if self.cursor == len(self.buffers):
            self.buffers.append(torch.rand(shape, generator=self.generator, device=device))
        u = self.buffers[self.cursor]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"dropout draw {self.cursor} has shape {tuple(u.shape)}, the "
                             f"forward asks for {tuple(shape)}")
        self.cursor += 1
        return u

    def get_state(self) -> int:
        return self.cursor

    def set_state(self, cursor: int) -> None:
        self.cursor = cursor


def _uniform(generator, shape, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from a ``torch.Generator`` or a ``DropoutDraws``."""
    if isinstance(generator, DropoutDraws):
        return generator.uniform(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def _replay_generator(generator):
    """``context_fn`` of a checkpointed block: the recompute starts from the
    generator state the block's first run started from, so it draws the same
    dropout mask, and leaves the generator as it found it."""
    state = generator.get_state()

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(state)
        try:
            yield
        finally:
            generator.set_state(now)

    return contextlib.nullcontext(), recompute()


class StepSequential(nn.ModuleList):
    """Sequential that passes the step embedding (and the dropout
    generator) to the residual blocks (reference UsesStepsSequential,
    model.py:40-48). With ``use_remat`` every residual and attention block
    is rematerialised in the backward pass (JAX unet.py:529-535)."""

    def __init__(self, modules, use_remat: bool = False):
        super().__init__(modules)
        self.use_remat = use_remat

    def forward(self, x, emb, generator=None):
        remat = self.use_remat and torch.is_grad_enabled()
        for layer in self:
            if isinstance(layer, ResidualBlock):
                args = (x, emb, generator)
            else:
                args = (x,)
            if remat and isinstance(layer, (ResidualBlock, AttentionBlock)):
                kw = {}
                if generator is not None:
                    kw["context_fn"] = functools.partial(_replay_generator, generator)
                x = checkpoint(layer, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(*args)
        return x


class EmbedMLP(nn.Sequential):
    """Linear -> SiLU -> Linear timestep-embedding MLP (model.py:348-352)."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None):
        super().__init__(
            Linear(in_features, features, dtype=dtype, device=device),
            nn.SiLU(),
            Linear(features, features, dtype=dtype, device=device),
        )
        self.tp, self.tp_layers = None, ()  # set by shard_module_

    def forward(self, x):
        for i, layer in enumerate(self):
            if i in self.tp_layers:  # column-parallel, gathered, then the bias
                x = gather_from_model(layer(copy_to_model(x, self.tp), add_bias=False), self.tp)
                x = x + layer.bias.to(x.dtype)
            else:
                x = layer(x)
        return x


class OutHead(nn.Sequential):
    """GN -> SiLU -> zero-init 3x3 conv output head (model.py:445-449). The
    SiLU, index 1 in the reference, is fused into the GroupNorm."""

    def __init__(self, features: int, out_channels: int, dtype=None,
                 kernels: bool = True, device=None):
        super().__init__(
            GroupNormOp(features, "silu", kernels=kernels, device=device),
            nn.Identity(),
            Conv2d(features, out_channels, 3, zero_init=True, dtype=dtype, device=device,
                   kernels=kernels),
        )


class DiffusionModel(nn.Module):
    """UNet epsilon predictor (reference model.py:294-476), NHWC.

    forward: (x[B,H,W,Cin], timestep[B], y[B] or None) -> f32 [B,H,W,Cout].
    ``timestep`` is the original-chain timestep (the diffusion engine maps
    rescaled indices through its timestep_map before calling the model).
    ``dtype`` is the compute dtype (None: the input's); parameters stay f32.
    ``quantized`` makes the residual blocks' and resamplers' convs int8
    (``quantized_attention`` also the attention projections); see the
    module docstring for their calibrate -> freeze -> serve modes.
    ``winograd`` computes the stride-1 3x3 convs by F(2x2, 3x3)
    (WinogradConv, at JAX's sites; the state dict is unchanged).
    """

    def __init__(
        self,
        resolution: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_classes: int | None = None,
        num_heads: int = 1,
        num_head_channels: int | None = None,
        resblock_updown: bool = False,
        use_adaptive_gn: bool = False,
        split_qkv_first: bool = True,
        use_remat: bool = False,
        dtype: torch.dtype | None = None,
        quantized: bool = False,
        quantized_attention: bool = False,
        winograd: bool = False,
        kernels: bool = True,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.resolution, self.in_channels = resolution, in_channels
        self.model_channels, self.num_classes = model_channels, num_classes
        self.dtype, self.kernels, self.use_remat = dtype, kernels, use_remat
        emb_dim = 4 * model_channels
        kw = dict(dtype=dtype, device=device)
        seq = functools.partial(StepSequential, use_remat=use_remat)

        def res(cin, cout, up=False, down=False):
            return ResidualBlock(cin, cout, emb_dim, upsample=up, downsample=down,
                                 use_adaptive_gn=use_adaptive_gn, dropout=dropout,
                                 kernels=kernels, quantized=quantized, winograd=winograd, **kw)

        def attn(ch):
            return AttentionBlock(ch, num_heads, num_head_channels, split_qkv_first,
                                  kernels=kernels, quantized=quantized and quantized_attention,
                                  **kw)

        self.step_embed = EmbedMLP(model_channels, emb_dim, **kw)
        if self.conditional:
            self.class_embedding = nn.Embedding(num_classes, emb_dim, device=device)

        # ---- encoder (reference model.py:363-402) ----
        ch = input_ch = int(model_channels * channel_mult[0])
        curr_res = resolution
        # the stem: never int8, Winograd with the flag (JAX passes no quantized)
        down = [seq([_conv(in_channels, ch, 3, kernels=kernels, winograd=winograd, **kw)])]
        skip_chs = [ch]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(model_channels * mult))]
                ch = int(model_channels * mult)
                if curr_res in attention_resolutions:
                    layers.append(attn(ch))
                skip_chs.append(ch)
                down.append(seq(layers))
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    down.append(seq([res(ch, ch, down=True)]))
                else:
                    # a stride-2 conv: never Winograd (JAX passes the flag, _conv drops it)
                    down.append(seq([Downsample(ch, conv_resample, quantized=quantized,
                                                kernels=kernels, **kw)]))
                skip_chs.append(ch)
                curr_res //= 2
        self.downsampling = nn.ModuleList(down)

        # ---- middle (reference model.py:404-412) ----
        self.middle_block = seq([res(ch, ch), attn(ch), res(ch, ch)])

        # ---- decoder (reference model.py:414-443) ----
        up = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skip_chs.pop(), int(model_channels * mult))]
                ch = int(model_channels * mult)
                if curr_res in attention_resolutions:
                    layers.append(attn(ch))
                if level != 0 and i == num_res_blocks:
                    if resblock_updown:
                        layers.append(res(ch, ch, up=True))
                    else:
                        layers.append(Upsample(ch, conv_resample, quantized=quantized,
                                               kernels=kernels, winograd=winograd, **kw))
                    curr_res *= 2
                up.append(seq(layers))
        self.upsampling = nn.ModuleList(up)

        self.out = OutHead(input_ch, out_channels, kernels=kernels, **kw)

    @property
    def conditional(self) -> bool:
        return self.num_classes is not None

    def shard_(self, mesh):
        """Tensor parallelism over ``mesh``'s model axis: see
        :func:`shard_module_`. Returns the model."""
        return shard_module_(self, mesh)

    # ---- static int8 (JAX ops/quant.py's calibrate -> freeze -> serve) ----

    def int8_layers(self) -> dict[str, nn.Module]:
        """Every Int8Conv/Int8Dense by its module name (the state-dict prefix
        of its weight), in module order; empty unless ``quantized``."""
        return {name: m for name, m in self.named_modules() if isinstance(m, _Int8State)}

    @contextlib.contextmanager
    def calibrating(self):
        """Within the block every int8 layer computes in float and records
        the running max |x| of its input, starting afresh."""
        layers = list(self.int8_layers().values())
        for m in layers:
            m.absmax, m.recording = None, True
        try:
            yield self
        finally:
            for m in layers:
                m.recording = False

    def int8_calibration(self) -> dict[str, torch.Tensor]:
        """``{layer name: absmax}`` recorded by the last ``calibrating()``."""
        out = {}
        for name, m in self.int8_layers().items():
            if m.absmax is None:
                raise RuntimeError(f"int8 layer {name} recorded no calibration input")
            out[name] = m.absmax.detach().clone()
        return out

    def freeze_int8(self, calib: Mapping[str, torch.Tensor]) -> None:
        """Freeze every int8 layer from ``calib`` (``{layer name: absmax}``,
        one entry per layer, as ``int8_calibration`` returns); the model then
        serves the static path."""
        layers = self.int8_layers()
        if set(calib) != set(layers):
            raise KeyError(f"the calibration names {sorted(set(calib) ^ set(layers))[:4]} "
                           "not both in it and among the model's int8 layers")
        for name, m in layers.items():
            m.freeze(calib[name])

    def load_int8_state(self, quant: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Set every int8 layer's frozen buffers from ``{layer name:
        {"kernel_q", "inv_act", "deq"}}`` (utils/convert.py
        ``flax_quant_to_torch`` reads the JAX package's 'quant' tree so)."""
        layers = self.int8_layers()
        if set(quant) != set(layers):
            raise KeyError(f"the quant state names {sorted(set(quant) ^ set(layers))[:4]} "
                           "not both in it and among the model's int8 layers")
        for name, m in layers.items():
            dev = m.weight.device
            q = {k: torch.as_tensor(v) for k, v in quant[name].items()}
            m.kernel_q = q["kernel_q"].to(dev, torch.int8).contiguous()
            m.inv_act = q["inv_act"].to(dev, torch.float32).reshape(())
            m.deq = q["deq"].to(dev, torch.float32).contiguous()

    # The forward pass keeps the JAX package's embed / encode / decode split,
    # which the encoder cache of Diffusion.denoise builds on.

    def embed(self, timestep, y=None):
        """Timestep (+ class) embedding [B, 4*model_channels]."""
        if (y is not None) != self.conditional:
            raise ValueError("pass y iff the model is class-conditional")
        emb = self.step_embed(timestep_embedding(timestep, self.model_channels))
        if self.conditional:
            emb = emb + self.class_embedding(y)
        return emb

    def encode(self, x, emb, generator=None):
        """Encoder stack -> (bottom feature, all skip activations)."""
        x = x.to(self.dtype or x.dtype)
        xs = []
        for module in self.downsampling:
            x = module(x, emb, generator)
            xs.append(x)
        return x, xs

    def decode(self, h, xs, emb, generator=None):
        """Middle + decoder + head, consuming the encoder skips; f32 out."""
        xs = list(xs)
        h = self.middle_block(h, emb, generator)
        for module in self.upsampling:
            h = module(torch.cat([h, xs.pop()], dim=-1), emb, generator)
        return self.out(h).float()

    def forward(self, x, timestep, y=None, generator=None):
        """``generator`` feeds the dropout masks; it is needed only in
        ``train()`` mode with ``dropout > 0``."""
        emb = self.embed(timestep, y)
        h, xs = self.encode(x, emb, generator)
        return self.decode(h, xs, emb, generator)


def shard_module_(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model``'s parameters in place to this rank's shards over
    ``mesh``'s model axis (parallel/sharding.py's table over its full
    shapes) and set the blocks the table pairs to run tensor-parallel; keep
    the table as ``model.tp_dims`` and the mesh as ``model.tp_mesh``. Every
    rank of the model group starts from the same whole weights (the
    parameter objects stay, so make an optimizer afterwards). A model axis
    of one changes nothing. Raises ValueError for a quantized model: no
    entry point combines int8 with a model axis."""
    tp = mesh.num_model
    model.tp_mesh, model.tp_dims = mesh, unet_param_shard_dims(model, tp)
    if tp == 1:
        return model
    if any(isinstance(m, _Int8State) for m in model.modules()):
        raise ValueError("quantized=True with tensor parallelism (a model axis of "
                         f"{tp}): static int8 runs unsharded")
    dims = model.tp_dims
    local = shard_params({n: p.data for n, p in model.named_parameters()}, mesh, dims)
    for name, p in model.named_parameters():
        p.data = local[name]
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, ResidualBlock) and dims[pre + "in_conv.weight"] == 0:
            m.tp = mesh  # the table shards out_norm and out_conv with it
            m.out_norm.num_groups //= tp
        elif isinstance(m, AttentionBlock):
            m.tp = mesh
            m.tp_qkv = dims[pre + "qkv_nin.weight"] == 0
            m.tp_proj = dims[pre + "proj_out.weight"] == 1
        elif isinstance(m, EmbedMLP):
            m.tp = mesh
            m.tp_layers = tuple(i for i, layer in enumerate(m) if isinstance(layer, Linear)
                                and dims[f"{pre}{i}.weight"] == 0)
    return model


class SuperResolutionModel(DiffusionModel):
    """Super-resolution UNet conditioned on a low-resolution image, resized
    bilinearly to the input's size and concatenated to it on the channel
    axis (reference model.py:479-499, JAX ``models/unet.py:666-679``).

    Construct with ``in_channels = 2 * image_channels``: the image and the
    upsampled low-res image. ``low_res`` is NHWC with the image's channels;
    the diffusion engine passes it through ``Diffusion.with_model_kwargs``.
    """

    def forward(self, x, timestep, low_res=None, y=None, generator=None):
        assert low_res is not None, "must pass low_res to SuperResolutionModel"
        _, h, w, _ = x.shape
        x = torch.cat([x, resize_bilinear(low_res.to(x.dtype), h, w)], dim=-1)
        return super().forward(x, timestep, y, generator)
