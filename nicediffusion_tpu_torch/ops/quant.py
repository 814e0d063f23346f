"""int8 quantization for static int8 serving (torch), counterpart of
nicediffusion_tpu/ops/quant.py.

Weights are quantized per output channel (symmetric), activations per tensor;
products sum in int32 and dequantize into an f32 epilogue. The arithmetic is
the JAX package's operation for operation, in f32, so a float input gives the
same int8 values in both packages:

  * ``quantize_weight_channelwise`` and ``quantize_activation`` (the dynamic
    path) quantize by *division*, ``round(x / scale)``, with a 1e-12 absmax
    clamp;
  * ``static_quant_triple`` (the freeze) keeps ``inv_act = 1 / act_scale``
    with a 1e-6 absmax clamp, and serving quantizes by *multiplying* by it;
  * ``torch.round`` is round-half-to-even, like ``jnp.round``;
  * the dequant scale is ``s_w * act_scale`` (static) or ``s_x * s_w``
    (dynamic); the bias is added in f32 after it, then one cast to the output
    type.

The products go through the int8 conv kernel (ops/kernels/int8conv.py; a
dense layer is a 1 x 1 conv over a (1, 1, M, C) view): on a CUDA tensor it
launches or raises, on a CPU tensor, or with ``kernels=False``, it takes its
plain version (exact float64 sums). ``kernel_q`` is frozen as (F, k, k, C)
int8, channels innermost per filter, the layout 8-bit wgmma reads.

Calibrate -> freeze -> serve: the model's Int8Conv and Int8Dense modules own
their state (models/unet.py). :func:`collect_calibration` runs float forwards
under ``model.calibrating()``, where each records the running max |x| of its
input, and returns ``{layer name: absmax}``; :func:`freeze_int8` hands such
a dict to ``model.freeze_int8``, which fills each layer's ``kernel_q``,
``inv_act`` and ``deq`` buffers; a frozen layer serves the static path, any
other the dynamic one. :func:`calibration_inputs` draws its sample batch
through the model as it stands, unfrozen: the dynamic path, as in the JAX
package. utils/convert.py carries a calibration (and the JAX package's
frozen ``quant`` tree) across; utils/checkpoint.py writes the ``.npz`` that
``--int8_calibration`` keeps.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from .kernels.int8conv import int8_conv_nhwc, int8_conv_plain, quantize_static

__all__ = [
    "quantize_weight_channelwise",
    "quantize_activation",
    "quantize_static",
    "int8_conv",
    "int8_dense",
    "int8_conv_static",
    "int8_dense_static",
    "int8_conv_plain",
    "static_quant_triple",
    "kernel_layout",
    "merge_calibrations",
    "collect_calibration",
    "freeze_int8",
    "build_int8_variables",
    "calibration_inputs",
]


def quantize_weight_channelwise(w: torch.Tensor, axis: int = -1):
    """Symmetric per-output-channel int8 quantization along ``axis``.

    Returns (w_q int8 in w's layout, scale f32 of shape (w.shape[axis],))
    with w ~= w_q * scale broadcast along ``axis``."""
    w = w.detach().float()
    axis %= w.ndim
    reduce = tuple(i for i in range(w.ndim) if i != axis)
    absmax = w.abs().amax(dim=reduce, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.reshape(w.shape[axis])


def quantize_activation(x: torch.Tensor):
    """Dynamic symmetric per-tensor int8 quantization of an activation:
    (x_q int8, scale f32 0-dim)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 weight in the port's torch layout -> the kernel's (F, k, k, C):
    a conv's (F, C, k, k) permuted, a dense layer's (O, I) or Conv1d
    (O, I, 1) as (O, 1, 1, I)."""
    if w_q.ndim == 4:
        return w_q.permute(0, 2, 3, 1).contiguous()
    if w_q.ndim == 3:
        w_q = w_q[:, :, 0]
    return w_q[:, None, None, :].contiguous()


def _conv(x, kernel_q, inv_act, deq, bias, stride, out_dtype, kernels):
    if kernels:
        return int8_conv_nhwc(x, kernel_q, inv_act, deq, bias, stride, out_dtype)
    return int8_conv_plain(x, kernel_q, inv_act, deq, bias, stride, out_dtype)


def _dense(x, kernel_q, inv_act, deq, bias, out_dtype, kernels):
    """(..., I) through the conv as a 1 x 1 conv over a (1, 1, M, I) view."""
    lead = x.shape[:-1]
    o = _conv(x.reshape(1, 1, -1, x.shape[-1]), kernel_q, inv_act, deq, bias, 1, out_dtype,
              kernels)
    return o.reshape(*lead, kernel_q.shape[0])


def int8_conv_static(x, kernel_q, inv_act, deq, bias=None, stride: int = 1, out_dtype=None,
                     kernels: bool = True):
    """Static-scale int8 conv, the serving path: x float NHWC, quantized by
    ``rint(x * inv_act)`` in the kernel's prologue; ``kernel_q`` (F, k, k, C)
    int8; ``deq`` (F,) f32 = act_scale * weight_scale; ``inv_act`` a 0-dim
    f32 tensor. k 1 or 3, padding k // 2."""
    return _conv(x, kernel_q, inv_act, deq, bias, stride, out_dtype or x.dtype, kernels)


def int8_dense_static(x, kernel_q, inv_act, deq, bias=None, out_dtype=None,
                      kernels: bool = True):
    """Static-scale int8 dense: (..., I) with ``kernel_q`` (O, 1, 1, I)."""
    return _dense(x, kernel_q, inv_act, deq, bias, out_dtype or x.dtype, kernels)


def int8_conv(x, weight, bias=None, stride: int = 1, out_dtype=None, kernels: bool = True):
    """Dynamic int8 conv: x float NHWC and the float (F, C, k, k) weight are
    both quantized here (the activation per tensor, the weight per output
    channel, both by division) and the int8 product is dequantized by
    ``s_x * s_w``. The kernel takes x already quantized."""
    out_dtype = out_dtype or x.dtype
    x_q, s_x = quantize_activation(x)
    w_q, s_w = quantize_weight_channelwise(weight, axis=0)
    return _conv(x_q, kernel_layout(w_q), None, s_x * s_w, bias, stride, out_dtype, kernels)


def int8_dense(x, weight, bias=None, out_dtype=None, kernels: bool = True):
    """Dynamic int8 dense: (..., I) x the float (O, I) (or Conv1d (O, I, 1))
    weight, quantized as :func:`int8_conv`."""
    out_dtype = out_dtype or x.dtype
    x_q, s_x = quantize_activation(x)
    w = weight if weight.ndim == 2 else weight[:, :, 0]
    w_q, s_w = quantize_weight_channelwise(w, axis=0)
    return _dense(x_q, kernel_layout(w_q), None, s_x * s_w, bias, out_dtype, kernels)


def static_quant_triple(kernel: torch.Tensor, absmax, axis: int = -1):
    """The calibrated freeze of one layer, the one place its convention
    lives: (w_q int8 in kernel's layout, inv_act f32 0-dim, deq f32 (F,))
    from the float weight and the calibration absmax, with the 1e-6 absmax
    clamp and the /127 symmetric range; deq = s_w * act_scale."""
    if isinstance(absmax, tuple):
        absmax = absmax[0]
    absmax = torch.as_tensor(absmax, dtype=torch.float32, device=kernel.device)
    act_scale = torch.clamp(absmax, min=1e-6) / 127.0
    w_q, s_w = quantize_weight_channelwise(kernel, axis=axis)
    return w_q, 1.0 / act_scale, s_w * act_scale


def merge_calibrations(calibs: Iterable[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """The elementwise max of several ``{layer name: absmax}`` dicts."""
    merged: dict[str, torch.Tensor] = {}
    for calib in calibs:
        for name, v in calib.items():
            v = torch.as_tensor(v, dtype=torch.float32)
            merged[name] = v if name not in merged else torch.maximum(merged[name], v)
    return merged


def collect_calibration(model, sample_inputs) -> dict[str, torch.Tensor]:
    """Float forwards of ``model`` over ``sample_inputs`` (``(x, mapped_t,
    y)`` triples) under ``model.calibrating()``: every Int8Conv/Int8Dense
    records the max |x| of its input. Returns ``{layer name: absmax}``, one
    f32 scalar per quantized layer: the thing worth keeping between runs
    (``--int8_calibration``)."""
    sample_inputs = list(sample_inputs)
    if not sample_inputs:
        raise ValueError("need at least one calibration input")
    with model.calibrating(), torch.inference_mode():
        for x, t, y in sample_inputs:
            model(x, t, y)
    return model.int8_calibration()


def freeze_int8(model, calib: Mapping[str, torch.Tensor]):
    """Freeze every Int8Conv/Int8Dense of ``model`` from ``calib``: its
    weights quantized per output channel once, the static activation scale
    and the dequant scale kept as buffers. Returns the model, which now
    serves the static path."""
    model.freeze_int8(calib)
    return model


def build_int8_variables(model, sample_inputs=None, calib=None):
    """Calibrate over ``sample_inputs`` (or take a saved ``calib``) and
    freeze; returns the model."""
    if calib is None:
        calib = collect_calibration(model, sample_inputs)
    return freeze_int8(model, calib)


def calibration_inputs(diffusion, generator: torch.Generator, y=None, batch_size: int = 8,
                       num_points: int = 6, x0=None):
    """Model inputs spanning the sampling chain for int8 calibration.

    Draws one sample batch through ``diffusion`` itself (the dynamic path
    when the model is quantized and not frozen), then q-samples it back to
    ``num_points`` evenly spaced rescaled timesteps, the last one pure noise
    as ``denoise`` draws it. Inputs are CFG-doubled (null class 0) under
    classifier-free guidance, as serving batches are. ``x0`` skips the draw.
    Every random number comes from ``generator``. Returns a list of
    ``(x, mapped_t, y)``."""
    if x0 is None:
        x0 = diffusion.denoise(generator, y=y, batch_size=batch_size)
    else:
        batch_size = x0.shape[0]
    n = diffusion.rescaled_num_steps
    ts = [int(round(i * (n - 1) / max(num_points - 1, 1))) for i in range(num_points)]
    inputs = []
    for ti in sorted(set(ts)):
        t = torch.full((batch_size,), ti, dtype=torch.long, device=x0.device)
        noise = torch.randn(x0.shape, generator=generator, dtype=torch.float32,
                            device=x0.device)
        x_t = noise if ti == n - 1 else diffusion.q_sample(x0, t, noise.to(x0.dtype))
        mapped = diffusion.timestep_map[t]
        yy = y
        if diffusion.guidance == "classifier_free":
            x_t, mapped = torch.cat([x_t, x_t]), torch.cat([mapped, mapped])
            yy = torch.cat([y, torch.zeros_like(y)])
        inputs.append((x_t, mapped, yy))
    return inputs
