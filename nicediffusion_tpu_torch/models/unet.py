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

``kernels=True`` routes every GroupNorm through K3 and every attention
through K1; ``kernels=False`` takes the plain torch versions, for comparing
the two on the card. On CPU tensors the kernels' wrappers take their plain
versions either way.

Training. Dropout sits between ``out_norm`` and ``out_conv`` of every
ResidualBlock and is active only in ``train()`` mode; its mask is drawn from
the ``torch.Generator`` the caller hands to ``forward`` (no global RNG).
``use_remat=True`` wraps every ResidualBlock and AttentionBlock in
``torch.utils.checkpoint`` (non-reentrant) while a gradient is being taken;
the recompute replays the generator from the state it had when the block
first ran, so the dropout mask is the same, and puts the generator back
afterwards. Parameters are f32 and cast per call, so bf16 compute gives f32
gradients.

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
the int8 conv kernel; otherwise the dynamic path (ops/quant.py). Winograd is
an ablation the port leaves out. ``device=None`` means the CUDA card
(utils/device.py); the CPU has to be asked for.
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
from ..utils.device import resolve_device

__all__ = ["DiffusionModel", "SuperResolutionModel", "Int8Conv", "Int8Dense"]


class Conv2d(nn.Module):
    """k x k conv with symmetric k//2 padding on NHWC tensors; OIHW weight."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 zero_init: bool = False, dtype=None, device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, k // 2, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_ch * k * k))

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = F.conv2d(
            x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), self.bias.to(dt),
            stride=self.stride, padding=self.padding,
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

    def forward(self, x):
        dt = self.dtype or x.dtype
        w = self.weight if self.weight.ndim == 2 else self.weight[:, :, 0]
        return F.linear(x.to(dt), w.to(dt), self.bias.to(dt))


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
        super().__init__(*args, **kw)
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


def _conv(in_ch, out_ch, k, stride=1, zero_init=False, dtype=None, device=None,
          quantized=False, kernels=True):
    """JAX unet.py ``_conv``: an Int8Conv when quantized, else a Conv2d."""
    if quantized:
        return Int8Conv(in_ch, out_ch, k, stride, zero_init, dtype, device, kernels=kernels)
    return Conv2d(in_ch, out_ch, k, stride, zero_init, dtype, device)


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
                 quantized: bool = False, kernels: bool = True):
        super().__init__()
        self.conv = (
            _conv(channels, channels, 3, dtype=dtype, device=device, quantized=quantized,
                  kernels=kernels)
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
                 quantized: bool = False):
        super().__init__()
        self.upsample, self.downsample = upsample, downsample
        self.use_adaptive_gn, self.dropout = use_adaptive_gn, dropout
        conv = functools.partial(_conv, dtype=dtype, device=device, quantized=quantized,
                                 kernels=kernels)
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
        h = self.in_norm(x)
        if self.upsample:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.downsample:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_conv(h)

        emb = self.step_embedding(F.silu(emb))
        if self.use_adaptive_gn:
            emb_scale, emb_shift = emb.chunk(2, dim=-1)
            h = self.out_norm(h, emb_scale, emb_shift)
        else:
            h = self.out_norm(h + emb[:, None, None, :].to(h.dtype))

        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout in train() mode needs the caller's torch.Generator")
            keep = torch.rand(h.shape, generator=generator, device=h.device) >= self.dropout
            h = h * keep / (1.0 - self.dropout)
        h = self.out_conv(h)
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
        self.norm = GroupNormOp(channels, "plain", kernels=kernels, device=device)
        dense = functools.partial(Int8Dense, kernels=kernels) if quantized else Linear
        self.qkv_nin = dense(channels, 3 * channels, conv1d_weight=True,
                             dtype=dtype, device=device)
        self.proj_out = dense(channels, channels, zero_init=True, conv1d_weight=True,
                              dtype=dtype, device=device)

    def forward(self, x):
        b, hh, ww, c = x.shape
        qkv = self.qkv_nin(self.norm(x).reshape(b, hh * ww, c))
        h = qkv_attention(qkv, self.heads, self.split_qkv_first, kernels=self.kernels)
        return x + self.proj_out(h).reshape(b, hh, ww, c)


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


class OutHead(nn.Sequential):
    """GN -> SiLU -> zero-init 3x3 conv output head (model.py:445-449). The
    SiLU, index 1 in the reference, is fused into the GroupNorm."""

    def __init__(self, features: int, out_channels: int, dtype=None,
                 kernels: bool = True, device=None):
        super().__init__(
            GroupNormOp(features, "silu", kernels=kernels, device=device),
            nn.Identity(),
            Conv2d(features, out_channels, 3, zero_init=True, dtype=dtype, device=device),
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
        if winograd:
            raise NotImplementedError("Winograd is an ablation the port leaves out (ROADMAP)")
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
                                 kernels=kernels, quantized=quantized, **kw)

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
        down = [seq([Conv2d(in_channels, ch, 3, **kw)])]
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
                                               kernels=kernels, **kw))
                    curr_res *= 2
                up.append(seq(layers))
        self.upsampling = nn.ModuleList(up)

        self.out = OutHead(input_ch, out_channels, kernels=kernels, **kw)

    @property
    def conditional(self) -> bool:
        return self.num_classes is not None

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
